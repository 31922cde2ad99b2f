"""Wavefront integrator — the reference's fragment-shader megaloop as arrays.

One bounce of the reference (``fs_main`` loop, ``w8e3.wgsl:264-275``) is:
closest-hit against analytic primitives + trimesh, a material-switch shade
that may respawn the ray, and early exit on absorption/terminal shaders. Here
the whole W*H pixel wavefront advances through a ``lax.scan`` over the bounce
budget: every lane evaluates every material branch and masks select the
results, so masked array arithmetic replaces the shader's divergent
branches.

Faithfulness notes:
* the per-lane PRNG state advances exactly as the per-branch draw sequence of
  the reference shader would (the selected branch's end state wins), so the
  random streams match the WGSL implementation draw-for-draw;
* traversal returns integer primitive ids under ``stop_gradient``; hit
  attributes (t, position, normal) are *re-derived differentiably* from ids,
  which is what makes the whole renderer differentiable wrt vertices,
  materials and lights without differentiating through the BVH walk.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from tracer.accel import traverse
from tracer.kernels import intersect
from tracer.kernels.intersect import Rays
from tracer.math import rng, vec
from tracer.render import texture as tex
from tracer.render.camera import camera_rays, pixel_uv
from tracer.render.scene import (
    FROM_SELECTION1,
    FROM_SELECTION2,
    Scene,
    SceneConfig,
)
from tracer.geometry.device import (
    SHADER_BASECOLOR,
    SHADER_GLOSSY,
    SHADER_HOLDOUT,
    SHADER_LAMBERTIAN,
    SHADER_MIRROR,
    SHADER_NORMAL,
    SHADER_PHONG,
    SHADER_TRANSMIT,
    SHADER_TRANSPARENT,
)
from tracer.util import pytree_dataclass

PI = jnp.float32(3.14159265359)


@pytree_dataclass
class Hit:
    """Per-lane hit record (the reference ``HitRecord``, w9e2.wgsl:79-95,
    minus the mutable bookkeeping that lives in the bounce carry)."""

    valid: jnp.ndarray  # (N,) bool
    t: jnp.ndarray  # (N,)
    position: jnp.ndarray  # (N, 3)
    normal: jnp.ndarray  # (N, 3) shading normal (normalized)
    shader: jnp.ndarray  # (N,) i32
    albedo: jnp.ndarray  # (N, 3) — material.diffuse or base_color
    emission: jnp.ndarray  # (N, 3) — material.ambient (mesh emitters)
    specular: jnp.ndarray  # (N,)
    shininess: jnp.ndarray  # (N,)
    ior: jnp.ndarray  # (N,) ior1_over_ior2
    extinction: jnp.ndarray  # (N, 3)
    uv: jnp.ndarray  # (N, 2) plane texture coords
    textured: jnp.ndarray  # (N,) bool
    is_mesh: jnp.ndarray  # (N,) bool
    converged: jnp.ndarray  # (N,) bool — False iff a traversal cap tripped


def _resolve_shader(shader_code, uniforms):
    """Map FROM_SELECTION sentinels to the live uniform values."""
    s = shader_code
    s = jnp.where(s == FROM_SELECTION1, uniforms.selection1, s)
    s = jnp.where(s == FROM_SELECTION2, uniforms.selection2, s)
    return s



def onehot_rows(idx, table):
    """``table[idx]`` as a one-hot matmul: its backward is a matmul rather
    than a scatter. HIGHEST precision keeps the product exact (each output
    is one table entry plus zeros); a reduced-precision f32 matmul (TF32)
    would round the table's mantissas."""
    oh = (
        idx[:, None] == jnp.arange(table.shape[0], dtype=idx.dtype)[None, :]
    ).astype(jnp.float32)
    return jnp.dot(oh, table, precision=jax.lax.Precision.HIGHEST)


def _effective_traversal(scene: Scene, cfg: SceneConfig) -> str:
    """Execution engine for the mesh hot path. BSP-configured scenes
    default to the treelet engines (cfg.bsp_execution == "fast"): the
    result of a closest-hit/any-hit query is traversal-independent, so
    the faithful BSP walk stays available ("walk") without being the
    render path (parity gated in tests)."""
    if (
        cfg.traversal == "bsp"
        and cfg.bsp_execution == "fast"
        and scene.tb is not None
    ):
        return "bvh"
    return cfg.traversal


def trace_closest(scene: Scene, cfg: SceneConfig, rays: Rays,
                  seed_t=None) -> Hit:
    """Closest hit over analytic primitives + trimesh.

    Reproduces the sequential tmax-shrinking fold of the per-scene
    ``intersect_scene`` functions (e.g. ``w8e3.wgsl:290-311``) as a running
    minimum with attribute selection.

    ``seed_t``: optional per-ray temporal upper-bound hint for the flat
    (coherent-wavefront) mesh engine; exact regardless of hint quality
    (see ``tracer.accel.flat.closest_hit``).
    """
    n = rays.o.shape[0]
    f32 = jnp.float32
    z3 = jnp.zeros((n, 3), f32)
    best = Hit(
        valid=jnp.zeros(n, bool),
        t=rays.tmax,
        position=z3,
        normal=z3,
        shader=jnp.full(n, 255, jnp.int32),
        albedo=z3,
        emission=z3,
        specular=jnp.zeros(n, f32),
        shininess=jnp.zeros(n, f32),
        ior=jnp.full(n, cfg.sphere_ior_default, f32),
        extinction=z3,
        uv=jnp.zeros((n, 2), f32),
        textured=jnp.zeros(n, bool),
        is_mesh=jnp.zeros(n, bool),
        converged=jnp.ones(n, bool),
    )

    def upd(best: Hit, closer, **fields) -> Hit:
        out = {}
        for name in best.__dataclass_fields__:
            cur = getattr(best, name)
            if name in fields:
                new = fields[name]
                if new.ndim > closer.ndim:
                    out[name] = vec.where(closer, new, cur)
                else:
                    out[name] = jnp.where(closer, new, cur)
            else:
                out[name] = cur
        return Hit(**out)

    uniforms = scene.uniforms

    # --- Analytic spheres (static python loop; S is tiny).
    S = scene.spheres.radius.shape[0]
    for i in range(S):
        c = scene.spheres.center[i]
        r = scene.spheres.radius[i]
        t, ok = intersect.sphere_t(
            Rays(rays.o, rays.d, rays.tmin, best.t), c, r
        )
        closer = ok
        pos = rays.o + t[:, None] * rays.d
        nrm = vec.normalize(pos - c, eps=1e-24)
        shader = jnp.broadcast_to(
            _resolve_shader(scene.spheres.shader[i], uniforms), (n,)
        ).astype(jnp.int32)
        best = upd(
            best,
            closer,
            valid=jnp.ones(n, bool),
            t=t,
            position=pos,
            normal=nrm,
            shader=shader,
            albedo=jnp.broadcast_to(scene.spheres.base_color[i], (n, 3)),
            emission=z3,
            ior=jnp.broadcast_to(scene.spheres.ior[i], (n,)),
            extinction=jnp.broadcast_to(scene.spheres.extinction[i], (n, 3)),
            is_mesh=jnp.zeros(n, bool),
            textured=jnp.zeros(n, bool),
        )

    # --- Analytic planes.
    P = scene.planes.normal.shape[0]
    for i in range(P):
        p0 = scene.planes.position[i]
        nrm0 = scene.planes.normal[i]
        t, ok = intersect.plane_t(
            Rays(rays.o, rays.d, rays.tmin, best.t), p0, nrm0
        )
        pos = rays.o + t[:, None] * rays.d
        u = vec.dot(pos - p0, scene.planes.tangent[i])
        v = vec.dot(pos - p0, scene.planes.binormal[i])
        shader = jnp.broadcast_to(
            _resolve_shader(scene.planes.shader[i], uniforms), (n,)
        ).astype(jnp.int32)
        best = upd(
            best,
            ok,
            valid=jnp.ones(n, bool),
            t=t,
            position=pos,
            normal=jnp.broadcast_to(nrm0, (n, 3)),
            shader=shader,
            albedo=jnp.broadcast_to(scene.planes.base_color[i], (n, 3)),
            emission=z3,
            uv=jnp.stack([jnp.abs(u), jnp.abs(v)], axis=-1),
            textured=jnp.broadcast_to(
                scene.planes.textured[i] != 0, (n,)
            ),
            is_mesh=jnp.zeros(n, bool),
        )

    # --- Analytic triangles.
    R = scene.tris.shader.shape[0]
    for i in range(R):
        v0 = scene.tris.verts[i, 0]
        v1 = scene.tris.verts[i, 1]
        v2 = scene.tris.verts[i, 2]
        t, beta, gamma, ok = intersect.triangle_t(
            Rays(rays.o, rays.d, rays.tmin, best.t),
            v0,
            v1,
            v2,
            eps_denom=1e-10,
        )
        pos = rays.o + t[:, None] * rays.d
        nrm = vec.normalize(vec.cross(v1 - v0, v2 - v0), eps=1e-24)
        shader = jnp.broadcast_to(
            _resolve_shader(scene.tris.shader[i], uniforms), (n,)
        ).astype(jnp.int32)
        best = upd(
            best,
            ok,
            valid=jnp.ones(n, bool),
            t=t,
            position=pos,
            normal=jnp.broadcast_to(nrm, (n, 3)),
            shader=shader,
            albedo=jnp.broadcast_to(scene.tris.base_color[i], (n, 3)),
            emission=z3,
            is_mesh=jnp.zeros(n, bool),
            textured=jnp.zeros(n, bool),
        )

    # --- Triangle mesh via the configured traversal.
    if scene.geom is not None:
        trav = _effective_traversal(scene, cfg)
        sub = Rays(rays.o, rays.d, rays.tmin, best.t)
        mesh_conv = None  # engines without caps always converge
        if trav == "brute":
            t_m, tri = intersect.mesh_brute_force(
                sub, scene.geom.vertices, scene.geom.indices
            )
            tri = jax.lax.stop_gradient(tri)
        elif trav == "bsp":
            from tracer.accel import bsp as bsp_mod

            sg = jax.lax.stop_gradient
            t_m, tri, mesh_conv = bsp_mod.bsp_closest_hit(
                Rays(sg(sub.o), sg(sub.d), sg(sub.tmin), sg(sub.tmax)),
                scene.bsp,
                sg(scene.geom.vertices),
                sg(scene.geom.indices),
                with_conv=True,
            )
        elif trav == "bvh2":
            sg = jax.lax.stop_gradient
            t_m, tri = traverse.bvh_closest_hit(
                Rays(sg(sub.o), sg(sub.d), sg(sub.tmin), sg(sub.tmax)),
                scene.bvh,
                sg(scene.geom.vertices),
                sg(scene.geom.indices),
                max_leaf=cfg.max_leaf,
            )
        elif trav == "bvh8":
            from tracer.accel import wide as wide_mod

            sg = jax.lax.stop_gradient
            t_m, tri, conv = wide_mod.closest_hit(
                Rays(sg(sub.o), sg(sub.d), sg(sub.tmin), sg(sub.tmax)),
                scene.wide,
                with_conv=True,
            )
            mesh_conv = conv
        else:  # "bvh" — treelet traversal (default): dense frustum cull
            # for coherent direct-mode wavefronts, per-ray packet walk for
            # path-mode bounces (incoherent tiles defeat interval frustums)
            from tracer.accel import flat as flat_mod
            from tracer.accel import packet as packet_mod

            mod = flat_mod if cfg.mode == "direct" else packet_mod
            sg = jax.lax.stop_gradient
            kw = {}
            if mod is flat_mod and seed_t is not None:
                kw["seed_t"] = sg(seed_t)
            t_m, tri, conv = mod.closest_hit(
                Rays(sg(sub.o), sg(sub.d), sg(sub.tmin), sg(sub.tmax)),
                jax.tree.map(sg, scene.tb),  # accel buffers carry no grads
                frame=(cfg.width, cfg.height),
                with_conv=True,
                **kw,
            )
            mesh_conv = conv
        ok = tri >= 0
        tri_c = jnp.clip(tri, 0, scene.geom.indices.shape[0] - 1)
        # Both drivers fetch hit attributes as ONE row gather from the
        # precomputed (T, 20) table. fetch_tri_rows carries a custom VJP
        # so the scan driver stays reverse-differentiable: the backward is
        # one stacked (V, 6) scatter-add into vertices+normals.
        from tracer.geometry.device import fetch_tri_rows

        T_mesh = scene.geom.indices.shape[0]
        if T_mesh <= 128:
            # Small meshes (the brute-force scenes: Cornell boxes, quads)
            # fetch via a one-hot matmul over a table built differentiably
            # in-trace: its backward is a matmul + a 3T-index scatter
            # instead of an N-index one.
            idxT = scene.geom.indices
            cols = [scene.geom.vertices[idxT[:, c]] for c in range(3)]
            cols += [scene.geom.normals[idxT[:, c]] for c in range(3)]
            cols = [c.reshape(T_mesh, 3) for c in cols]
            cols.append(
                jax.lax.stop_gradient(
                    scene.geom.mat_ids.astype(jnp.float32)
                )[:, None].reshape(T_mesh, 1)
            )
            row = onehot_rows(tri_c, jnp.concatenate(cols, axis=1))
        else:
            row = fetch_tri_rows(
                scene.geom.vertices,
                scene.geom.normals,
                scene.geom.tri_table,
                scene.geom.indices,
                tri_c,
            )
        v0 = row[:, 0:3]
        v1 = row[:, 3:6]
        v2 = row[:, 6:9]
        n0 = row[:, 9:12]
        n1 = row[:, 12:15]
        n2 = row[:, 15:18]
        mat = jax.lax.stop_gradient(row[:, 18]).astype(jnp.int32)
        # Differentiable re-derivation of t/beta/gamma from the winning id.
        t_d, beta, gamma, _ = intersect.triangle_t(
            Rays(rays.o, rays.d, jnp.zeros_like(rays.tmin), rays.tmax),
            v0,
            v1,
            v2,
        )
        pos = rays.o + t_d[:, None] * rays.d
        face_n = vec.cross(v1 - v0, v2 - v0)
        if cfg.use_vertex_normals:
            sn = (
                n0 * (1.0 - beta - gamma)[:, None]
                + n1 * beta[:, None]
                + n2 * gamma[:, None]
            )
            # Fall back to the face normal where vertex normals are zero
            # (the reference zero-fills missing normals, mesh.rs:159-166,
            # and Cornell shaders use the face normal, w8e3.wgsl:340-342).
            sn = jnp.where(
                (vec.dot(sn, sn) > 1e-20)[:, None], sn, face_n
            )
        else:
            sn = face_n
        nrm = vec.normalize(sn, eps=1e-24)
        shader = jnp.broadcast_to(
            _resolve_shader(jnp.int32(cfg.mesh_shader), uniforms), (n,)
        ).astype(jnp.int32)
        # Material fetch as one one-hot matmul instead of 5 row gathers:
        # the material table is tiny (M <= 8 in every scene), and the
        # backward of a matmul is a matmul where the backward of a gather
        # with N nearly-all-equal indices is a heavily contended scatter.
        pack = jnp.concatenate(
            [
                scene.materials.diffuse,
                scene.materials.emission,
                scene.materials.specular,
                scene.materials.shininess[:, None],
                scene.materials.ior[:, None],
            ],
            axis=1,
        )  # (M, 11)
        rows = onehot_rows(mat, pack)  # (N, 11)
        best = upd(
            best,
            ok,
            valid=jnp.ones(n, bool),
            t=t_d,
            position=pos,
            normal=nrm,
            shader=shader,
            albedo=rows[:, 0:3],
            emission=rows[:, 3:6],
            specular=rows[:, 6:9].mean(axis=-1),
            shininess=rows[:, 9],
            ior=rows[:, 10],
            is_mesh=jnp.ones(n, bool),
            textured=jnp.zeros(n, bool),
        )
        if mesh_conv is not None:
            from tracer.util import replace as _rep

            best = _rep(best, converged=best.converged & mesh_conv)

    return best


def trace_occluded(scene: Scene, cfg: SceneConfig, rays: Rays,
                   with_conv=False):
    """Boolean occlusion over the full scene (shadow rays).

    The reference's shadow test reuses the closest-hit ``intersect_scene``
    (``w8e3.wgsl:469-471``); only the boolean is consumed, so an any-hit
    traversal is used for the mesh part. ``with_conv=True`` adds the
    per-lane traversal-truncation flag.
    """
    n = rays.o.shape[0]
    conv = jnp.ones(n, bool)
    blocked = jnp.zeros(n, bool)
    S = scene.spheres.radius.shape[0]
    for i in range(S):
        _, ok = intersect.sphere_t(
            rays, scene.spheres.center[i], scene.spheres.radius[i]
        )
        blocked = blocked | ok
    P = scene.planes.normal.shape[0]
    for i in range(P):
        _, ok = intersect.plane_t(
            rays, scene.planes.position[i], scene.planes.normal[i]
        )
        blocked = blocked | ok
    R = scene.tris.shader.shape[0]
    for i in range(R):
        _, _, _, ok = intersect.triangle_t(
            rays,
            scene.tris.verts[i, 0],
            scene.tris.verts[i, 1],
            scene.tris.verts[i, 2],
            eps_denom=1e-10,
        )
        blocked = blocked | ok
    if scene.geom is not None:
        sg = jax.lax.stop_gradient
        srays = Rays(sg(rays.o), sg(rays.d), sg(rays.tmin), sg(rays.tmax))
        trav = _effective_traversal(scene, cfg)
        if trav == "brute":
            b = intersect.mesh_brute_force_anyhit(
                srays, scene.geom.vertices, scene.geom.indices
            )
        elif trav == "bsp":
            from tracer.accel import bsp as bsp_mod

            b, conv = bsp_mod.bsp_any_hit(
                srays, scene.bsp, sg(scene.geom.vertices),
                sg(scene.geom.indices), with_conv=True,
            )
        elif trav == "bvh2":
            b = traverse.bvh_any_hit(
                srays,
                scene.bvh,
                sg(scene.geom.vertices),
                sg(scene.geom.indices),
                max_leaf=cfg.max_leaf,
            )
        elif trav == "bvh8":
            from tracer.accel import wide as wide_mod

            b, conv = wide_mod.any_hit(srays, scene.wide, with_conv=True)
        else:  # "bvh" — treelet traversal (default; see trace_closest)
            from tracer.accel import flat as flat_mod
            from tracer.accel import packet as packet_mod

            mod = flat_mod if cfg.mode == "direct" else packet_mod
            b, conv = mod.any_hit(
                srays, jax.tree.map(sg, scene.tb),
                frame=(cfg.width, cfg.height),
                with_conv=True,
            )
        blocked = blocked | b
    if with_conv:
        return blocked, conv
    return blocked


# ---------------------------------------------------------------------------
# Lights
# ---------------------------------------------------------------------------


def _sample_point_light_w1(pos, cfg: SceneConfig):
    """``sample_point_light`` (w1e6.wgsl:239-252) — faithful quirks included:
    w_i is the *unnormalized* offset and l_i divides by |d|^4 (dist here is
    the squared distance)."""
    lp = jnp.asarray(cfg.point_light_pos, jnp.float32)
    li = jnp.asarray(cfg.point_light_intensity, jnp.float32)
    d = lp - pos
    dist2 = vec.dot(d, d)
    l_i = li / (dist2 * dist2)[..., None]
    return l_i, d, dist2


def _sample_directional(cfg: SceneConfig, n):
    """``sample_directional_light`` (w5e2.wgsl:293-304)."""
    d = -vec.normalize(jnp.asarray(cfg.dir_light_direction, jnp.float32))
    li = jnp.asarray(cfg.dir_light_intensity, jnp.float32)
    return (
        jnp.broadcast_to(li, (n, 3)),
        jnp.broadcast_to(d, (n, 3)),
        jnp.full((n,), 1.0, jnp.float32),
    )


def _area_light_attrs(scene: Scene, light_slot):
    """Fetch (v0, v1, v2, Le, area, normal) of light triangle ``light_slot``
    (an index into scene.light_indices).

    Per-ray slots select via a one-hot matmul over the (L, 12) light
    table instead of per-ray row gathers: L is tiny (2 for the Cornell
    scenes), and a matmul's backward is a matmul where a gather's is a
    scatter — this is the path-mode NEE hot loop, hit every bounce.
    """
    L = scene.light_indices.shape[0]
    tri_all = scene.light_indices  # (L,)
    idx_all = scene.geom.indices[tri_all]  # (L, 3) — L-row gather, tiny
    v0L = scene.geom.vertices[idx_all[:, 0]]
    v1L = scene.geom.vertices[idx_all[:, 1]]
    v2L = scene.geom.vertices[idx_all[:, 2]]
    leL = scene.materials.emission[scene.geom.mat_ids[tri_all]]
    slot = jnp.asarray(light_slot)
    if slot.ndim == 1 and 0 < L <= 64:
        rows = onehot_rows(
            slot, jnp.concatenate([v0L, v1L, v2L, leL], axis=1)
        )  # (N, 12)
        v0, v1, v2, l_e = (
            rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
        )
    else:
        v0, v1, v2, l_e = v0L[slot], v1L[slot], v2L[slot], leL[slot]
    e0 = v0 - v1
    e1 = v0 - v2
    cr = vec.cross(e0, e1)
    area = 0.5 * jnp.sqrt(vec.dot(cr, cr))
    nrm = vec.normalize(cr, eps=1e-24)
    return v0, v1, v2, l_e, area, nrm


def _sample_area_light_mc(scene: Scene, pos, light_slot, state):
    """``sample_area_light`` with the sqrt barycentric warp
    (w9e2.wgsl:406-433). Returns (l_i, w_i, dist, state')."""
    v0, v1, v2, l_e, area, nrm = _area_light_attrs(scene, light_slot)
    psi1_raw, state = rng.rnd(state)
    psi2, state = rng.rnd(state)
    psi1 = jnp.sqrt(psi1_raw)
    alpha = 1.0 - psi1
    beta = (1.0 - psi2) * psi1
    gamma = psi2 * psi1
    p = v0 * alpha[..., None] + v1 * beta[..., None] + v2 * gamma[..., None]
    d = p - pos
    dist = jnp.sqrt(vec.dot(d, d))
    w_i = vec.normalize(d, eps=1e-24)
    cos_l = jnp.maximum(vec.dot(-w_i, nrm), 0.0)
    l_i = l_e * (area * cos_l / (dist * dist))[..., None]
    return l_i, w_i, dist, state


def _sample_area_light_center(scene: Scene, pos, light_slot):
    """w5e5's deterministic variant: triangle center, unclamped cos
    (w5e5.wgsl:247-268)."""
    v0, v1, v2, l_e, area, nrm = _area_light_attrs(scene, light_slot)
    center = (v0 + v1 + v2) / 3.0
    d = center - pos
    dist = jnp.sqrt(vec.dot(d, d))
    w_i = vec.normalize(d, eps=1e-24)
    cos_l = vec.dot(-w_i, nrm)
    l_i = l_e * (area * cos_l / (dist * dist))[..., None]
    return l_i, w_i, dist


# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------


def _plane_albedo(scene: Scene, cfg: SceneConfig, hit: Hit):
    """Albedo with optional plane texture (w3): fract(uv * uv_scale) sampled
    by the uniform-selected sampler; TEX_NONE keeps the base color."""
    albedo = hit.albedo
    if cfg.plane_texture and scene.texture is not None:
        uv = hit.uv * scene.uniforms.uv_scale
        u = uv[..., 0] - jnp.floor(uv[..., 0])
        v = uv[..., 1] - jnp.floor(uv[..., 1])
        texel = tex.sample(scene.texture, u, v, scene.uniforms.use_texture)
        use = hit.textured & (scene.uniforms.use_texture != tex.TEX_NONE)
        albedo = vec.where(use, texel, albedo)
    return albedo


def _reflect_continue(rays: Rays, hit: Hit, cfg: SceneConfig, normal=None):
    """``mirror`` (w8e3.wgsl:512-525): reflected continuation ray offset by
    normal * ETA."""
    nrm = hit.normal if normal is None else normal
    d = vec.reflect(rays.d, nrm)
    o = hit.position + nrm * cfg.eta
    return Rays(
        o=o,
        d=d,
        tmin=jnp.full(d.shape[:-1], cfg.eta, jnp.float32),
        tmax=jnp.full(d.shape[:-1], cfg.tmax, jnp.float32),
    )


def _fresnel_r(cos_i, cos_t, ni_over_nt):
    """``fresnel_r`` (w9e2.wgsl:193-203)."""
    ii = ni_over_nt * cos_i
    tt = cos_t
    ti = cos_i
    it = ni_over_nt * cos_t
    r1 = (ii - tt) / (ii + tt)
    r2 = (ti - it) / (ti + it)
    return 0.5 * (r1 * r1 + r2 * r2)


ERROR_COLOR = jnp.array([0.7, 0.0, 0.7], jnp.float32)


def _mesh_only_anyhit(scene: Scene, cfg: SceneConfig, rays: Rays):
    """Trimesh-only occlusion — ``intersect_trimesh_immediate_return`` as
    used by the holdout shader (w9e2.wgsl:514-538). Returns
    (blocked, converged)."""
    n = rays.o.shape[0]
    ones = jnp.ones(n, bool)
    if scene.geom is None:
        return jnp.zeros(n, bool), ones
    sg = jax.lax.stop_gradient
    srays = Rays(sg(rays.o), sg(rays.d), sg(rays.tmin), sg(rays.tmax))
    trav = _effective_traversal(scene, cfg)
    if trav == "brute":
        return intersect.mesh_brute_force_anyhit(
            srays, scene.geom.vertices, scene.geom.indices
        ), ones
    if trav == "bsp":
        from tracer.accel import bsp as bsp_mod

        return bsp_mod.bsp_any_hit(
            srays, scene.bsp, sg(scene.geom.vertices),
            sg(scene.geom.indices), with_conv=True,
        )
    if trav == "bvh2":
        return traverse.bvh_any_hit(
            srays,
            scene.bvh,
            sg(scene.geom.vertices),
            sg(scene.geom.indices),
            max_leaf=cfg.max_leaf,
        ), ones
    if trav == "bvh8":
        from tracer.accel import wide as wide_mod

        return wide_mod.any_hit(srays, scene.wide, with_conv=True)
    from tracer.accel import flat as flat_mod
    from tracer.accel import packet as packet_mod

    mod = flat_mod if cfg.mode == "direct" else packet_mod
    return mod.any_hit(
        srays, jax.tree.map(sg, scene.tb), frame=(cfg.width, cfg.height),
        with_conv=True,
    )


def _shade_lambertian_direct(scene, cfg, rays, hit, albedo):
    """w1/w2/w5-family direct lambertian. Returns (color, converged)."""
    n_lanes = hit.t.shape[0]
    nrm = hit.normal
    conv = jnp.ones(n_lanes, bool)
    diffuse = jnp.zeros((n_lanes, 3), jnp.float32)
    blocked_point = jnp.zeros(n_lanes, bool)
    any_point_light = False
    for kind in cfg.lights:
        if kind == "point_w1":
            any_point_light = True
            l_i, w_i, _ = _sample_point_light_w1(hit.position, cfg)
            if cfg.shadows:
                sray = Rays(
                    o=hit.position + nrm * cfg.eta,
                    d=w_i,
                    tmin=jnp.full(n_lanes, cfg.eta, jnp.float32),
                    tmax=jnp.full(n_lanes, cfg.tmax, jnp.float32),
                )
                blocked_point, c1 = trace_occluded(
                    scene, cfg, sray, with_conv=True
                )
                conv = conv & c1
            # light_diffuse_contribution (w1e6.wgsl:274-280): unclamped dot.
            diffuse = diffuse + albedo * (
                vec.dot(nrm, w_i)[..., None]
                * l_i
                * ((1.0 - hit.specular) / PI)[..., None]
            )
        elif kind == "directional":
            any_point_light = True
            l_i, w_i, _ = _sample_directional(cfg, n_lanes)
            if cfg.shadows:
                sray = Rays(
                    o=hit.position + nrm * cfg.eta,
                    d=w_i,
                    tmin=jnp.full(n_lanes, cfg.eta, jnp.float32),
                    tmax=jnp.full(n_lanes, cfg.tmax, jnp.float32),
                )
                b1, c1 = trace_occluded(scene, cfg, sray, with_conv=True)
                blocked_point = blocked_point | b1
                conv = conv & c1
            diffuse = diffuse + albedo * (
                vec.dot(nrm, w_i)[..., None]
                * l_i
                * ((1.0 - hit.specular) / PI)[..., None]
            )
        elif kind == "directional_n":
            # w6e1/project lambertian (project.wgsl:286-293): a loop over
            # lightIndices with a *directional* sampler, but the body ends in
            # ``break`` — exactly ONE unscaled directional sample (the
            # sentinel in slot 0, storage_mesh.rs:330-332, guarantees the
            # loop runs at least once). No shadow ray (``blocked = false``).
            l_i, w_i, _ = _sample_directional(cfg, n_lanes)
            diffuse = diffuse + albedo * (
                vec.dot(nrm, w_i)[..., None] * l_i / PI
            )
        elif kind == "area_all":
            # w5e5.wgsl:293-318 — loop every emissive triangle, deterministic
            # center sample, shadow ray with no normal offset.
            L = int(scene.light_indices.shape[0])
            for slot in range(L):
                slot_arr = jnp.full(n_lanes, slot, jnp.int32)
                l_i, w_i, dist = _sample_area_light_center(
                    scene, hit.position, slot_arr
                )
                sray = Rays(
                    o=hit.position,
                    d=w_i,
                    tmin=jnp.full(n_lanes, cfg.eta, jnp.float32),
                    tmax=dist - cfg.eta,
                )
                blocked, c1 = trace_occluded(scene, cfg, sray, with_conv=True)
                conv = conv & c1
                contrib = albedo * vec.dot(nrm, w_i)[..., None] * l_i / PI
                diffuse = diffuse + vec.where(~blocked, contrib, 0.0)
    if cfg.ambient in ("mix", "mix_ka"):
        # "mix": ambient = base color (w2e1.wgsl:316, w5e2.wgsl:352).
        # "mix_ka": w6e1.wgsl:295-297 fetches the MTL material and mixes in
        # Ka (material.ambient) instead — carried here as hit.emission for
        # mesh hits; analytic hits keep the base color.
        if cfg.ambient == "mix_ka":
            ambient = vec.where(hit.is_mesh, hit.emission, albedo)
        else:
            ambient = albedo
        lit = 0.9 * diffuse + 0.1 * ambient
        shadowed = ambient * 0.1
        if cfg.shadows and any_point_light:
            return vec.where(blocked_point, shadowed, lit), conv
        return lit, conv
    if cfg.ambient == "plain_scaled":
        return diffuse + 0.1 * hit.emission, conv
    # "plain": diffuse + material emission as ambient term (w5e5).
    return diffuse + hit.emission, conv


def _shade_phong(scene, cfg, rays, hit):
    """``phong`` (w2e5.wgsl:374-389): Phong lobe lit by the point light."""
    w_o = vec.normalize(scene.camera.eye - hit.position, eps=1e-24)
    l_i, w_i, _ = _sample_point_light_w1(hit.position, cfg)
    w_r = vec.normalize(vec.reflect(-w_i, hit.normal), eps=1e-24)
    diffuse = (
        vec.saturate(vec.dot(hit.normal, w_i))[..., None] * l_i / PI
    )
    coeff = hit.specular * (hit.shininess + 2.0) / (2.0 * PI)
    lobe = coeff * jnp.power(
        vec.saturate(vec.dot(w_o, w_r)), hit.shininess
    )
    return lobe[..., None] * diffuse


def _shade_transmit_direct(rays, hit, cfg):
    """w2e3/w2e5 ``transmit``: deterministic refraction, TIR -> error color.

    Returns (color, new_rays, cont, tir). Faithful to the reference's sign
    conventions (w2e5.wgsl:410-446), including out_normal/ior selection.
    """
    w_i = -vec.normalize(rays.d, eps=1e-24)
    nrm = vec.normalize(hit.normal, eps=1e-24)
    cos_i = vec.dot(w_i, nrm)
    outside = cos_i < 0.0
    ior = jnp.where(outside, hit.ior, 1.0 / hit.ior)
    out_normal = vec.where(outside, -nrm, nrm)
    cos_t2 = 1.0 - (ior * ior) * (1.0 - cos_i * cos_i)
    tir = cos_t2 < 0.0
    sq = jnp.sqrt(jnp.maximum(cos_t2, 0.0))
    tangent = nrm * cos_i[..., None] - w_i
    w_t = ior[..., None] * tangent - out_normal * sq[..., None]
    o = hit.position + w_t * cfg.eta
    new_rays = Rays(
        o=o,
        d=w_t,
        tmin=jnp.full(cos_i.shape, cfg.eta, jnp.float32),
        tmax=jnp.full(cos_i.shape, cfg.tmax, jnp.float32),
    )
    color = vec.where(tir, jnp.broadcast_to(ERROR_COLOR, o.shape), 0.0)
    cont = ~tir
    return color, new_rays, cont, tir


def _shade_transparent_path(scene, cfg, rays, hit, factor, state):
    """Path-mode dielectric (w8e3.wgsl:527-617 "absorb" variant; w8e2's
    variant is the same without the Beer-Lambert exit terms).

    Returns (color, new_rays, cont, factor', emit', state').
    """
    n_lanes = hit.t.shape[0]
    w_i = -vec.normalize(rays.d, eps=1e-24)
    nrm = vec.normalize(hit.normal, eps=1e-24)
    cos_raw = vec.dot(w_i, nrm)
    entering = cos_raw < 0.0
    cos_i = jnp.abs(cos_raw)
    ior = jnp.where(entering, hit.ior, 1.0 / hit.ior)
    out_normal = vec.where(entering, -nrm, nrm)

    # Beer-Lambert transmittance on exit.
    s = vec.length(hit.position - rays.o) / cfg.beer_distance_scale
    t_r_exit = jnp.exp(-hit.extinction * s[..., None])
    if cfg.dielectric in ("absorb",):
        t_r = vec.where(entering, jnp.ones((n_lanes, 3), jnp.float32), t_r_exit)
    else:
        t_r = jnp.ones((n_lanes, 3), jnp.float32)
    transmission_prob = jnp.where(entering, 1.0, vec.mean3(t_r))
    if cfg.dielectric == "fresnel":
        transmission_prob = jnp.ones(n_lanes, jnp.float32)

    cos_t2 = 1.0 - (ior * ior) * (1.0 - cos_i * cos_i)
    tir = cos_t2 < 0.0
    sq = jnp.sqrt(jnp.maximum(cos_t2, 0.0))
    refl_prob = jnp.where(tir, 1.0, _fresnel_r(cos_i, sq, ior))

    tangent = out_normal * cos_i[..., None] - w_i
    w_t = ior[..., None] * tangent - out_normal * sq[..., None]
    refr_rays = Rays(
        o=hit.position,
        d=w_t,
        tmin=jnp.full(n_lanes, cfg.eta, jnp.float32),
        tmax=jnp.full(n_lanes, cfg.tmax, jnp.float32),
    )
    # Faithful quirk: the reference calls mirror() after *r was already
    # replaced by the refraction ray (w8e3.wgsl:560-566), so the "reflection"
    # reflects w_t about out_normal, not the incident direction.
    refl_rays = Rays(
        o=hit.position + out_normal * cfg.eta,
        d=vec.reflect(w_t, out_normal),
        tmin=jnp.full(n_lanes, cfg.eta, jnp.float32),
        tmax=jnp.full(n_lanes, cfg.tmax, jnp.float32),
    )

    step, state = rng.rnd(state)
    take_reflect = step < refl_prob
    take_transmit = ~take_reflect & (step < refl_prob + transmission_prob)
    # absorb: neither -> terminate (w8e3: has_hit stays true).
    new_rays = Rays(
        o=vec.where(take_reflect, refl_rays.o, refr_rays.o),
        d=vec.where(take_reflect, refl_rays.d, refr_rays.d),
        tmin=refr_rays.tmin,
        tmax=refr_rays.tmax,
    )
    cont = take_reflect | take_transmit
    # w8e3: on transmission the throughput picks up T_r/(refl+trans).
    denom = jnp.maximum(refl_prob + transmission_prob, 1e-8)
    factor_new = jnp.where(
        (take_transmit & ~entering)[..., None],
        factor * t_r / denom[..., None],
        factor,
    )
    color = jnp.zeros((n_lanes, 3), jnp.float32)
    emit_new = jnp.ones(n_lanes, bool)  # transparent sets emit = true
    return color, new_rays, cont, factor_new, emit_new, state


def _shade_lambertian_path(scene, cfg, rays, hit, factor, emit, state):
    """w7e3/w8e3 path-traced lambertian: one-sample NEE over area lights,
    emission gating, cosine-hemisphere indirect with Russian roulette.

    Returns (color, new_rays, cont, factor', emit', state', converged).
    """
    n_lanes = hit.t.shape[0]
    albedo = _plane_albedo(scene, cfg, hit)
    brdf = albedo / PI
    nrm = hit.normal
    conv = jnp.ones(n_lanes, bool)

    diffuse = jnp.zeros((n_lanes, 3), jnp.float32)
    use_nee = (
        "area_mc" in cfg.lights
        and scene.light_indices is not None
        and int(scene.light_indices.shape[0]) > 0
    )
    if use_nee:
        L = int(scene.light_indices.shape[0])
        ri, state = rng.rnd_int(state)
        slot = (ri % jnp.uint32(L)).astype(jnp.int32)
        l_i, w_i, dist, state = _sample_area_light_mc(
            scene, hit.position, slot, state
        )
        sray = Rays(
            o=hit.position,
            d=w_i,
            tmin=jnp.full(n_lanes, cfg.eta, jnp.float32),
            tmax=dist - cfg.eta,
        )
        blocked, c1 = trace_occluded(scene, cfg, sray, with_conv=True)
        conv = conv & c1
        contrib = (
            brdf
            * vec.saturate(vec.dot(nrm, w_i))[..., None]
            * l_i
            * jnp.float32(L)
        )
        if cfg.diffuse_factor:
            contrib = contrib * factor
        diffuse = vec.where(~blocked, contrib, 0.0)
    elif "directional" in cfg.lights:
        # w9e3 path lambertian: NEE against the sun (w9e3.wgsl:451-477).
        l_i, w_i, _ = _sample_directional(cfg, n_lanes)
        sray = Rays(
            o=hit.position,
            d=w_i,
            tmin=jnp.full(n_lanes, cfg.eta, jnp.float32),
            tmax=jnp.full(n_lanes, 999999.0 - cfg.eta, jnp.float32),
        )
        blocked, c1 = trace_occluded(scene, cfg, sray, with_conv=True)
        conv = conv & c1
        contrib = brdf * vec.saturate(vec.dot(nrm, w_i))[..., None] * l_i
        if cfg.diffuse_factor:
            contrib = contrib * factor
        diffuse = vec.where(~blocked, contrib, 0.0)

    if cfg.emit_gating:
        ambient = vec.where(emit, hit.emission, 0.0)
    else:
        ambient = hit.emission
    if cfg.emission_factor:
        ambient = ambient * factor

    if not cfg.rr:
        # w8e1-style terminal lambertian: no indirect bounce.
        return (
            diffuse + ambient,
            rays,
            jnp.zeros(n_lanes, bool),
            factor,
            emit,
            state,
            conv,
        )

    factor_new = factor * brdf * PI
    prob = vec.mean3(brdf)
    step, state = rng.rnd(state)
    cont = step < prob
    ind_dir, state_ind = sampling_cosine(nrm, state)
    state = jnp.where(cont, state_ind, state)
    factor_new = jnp.where(
        cont[..., None], factor_new / jnp.maximum(prob, 1e-12)[..., None], factor_new
    )
    new_rays = Rays(
        o=hit.position,
        d=ind_dir,
        tmin=jnp.full(n_lanes, cfg.eta, jnp.float32),
        tmax=jnp.full(n_lanes, cfg.tmax, jnp.float32),
    )
    emit_new = jnp.where(cont, False, emit)
    return diffuse + ambient, new_rays, cont, factor_new, emit_new, state, conv


def sampling_cosine(normal, state):
    """Cosine-hemisphere draw matching ``setup_indirect``
    (w8e3.wgsl:492-509)."""
    from tracer.math import sampling

    return sampling.cosine_hemisphere(normal, state)


def _shade_holdout(scene, cfg, rays, hit, factor, state):
    """``holdout_shader`` (w9e2.wgsl:514-538): hemisphere AO probe against
    the trimesh; unoccluded -> environment radiance."""
    n_lanes = hit.t.shape[0]
    nrm = vec.normalize(hit.normal, eps=1e-24)
    ao_dir, state = sampling_cosine(nrm, state)
    aoray = Rays(
        o=hit.position,
        d=ao_dir,
        tmin=jnp.full(n_lanes, cfg.eta, jnp.float32),
        tmax=jnp.full(n_lanes, cfg.tmax, jnp.float32),
    )
    blocked, conv = _mesh_only_anyhit(scene, cfg, aoray)
    if scene.env is not None:
        env = tex.environment_map(scene.env, vec.normalize(rays.d, eps=1e-24))
    else:
        env = jnp.broadcast_to(
            jnp.asarray(cfg.bg_color, jnp.float32), (n_lanes, 3)
        )
    color = vec.where(blocked, 0.0, env * factor)
    return color, state, conv


def shade(scene, cfg, rays, hit, factor, emit, state):
    """Material dispatch — the WGSL ``shade`` switch (w9e2.wgsl:436-466) as
    masked branch blending. Only shader ids in ``cfg.possible_shaders`` emit
    code (each reference scene compiles only its own switch arms); absent
    ids fall through to the error color. Returns
    (color, new_rays, cont, factor', emit', state', converged)."""
    n_lanes = hit.t.shape[0]
    z3 = jnp.zeros((n_lanes, 3), jnp.float32)
    sid = hit.shader
    possible = set(cfg.possible_shaders)

    color = jnp.broadcast_to(ERROR_COLOR, (n_lanes, 3))
    new_rays = rays
    cont = jnp.zeros(n_lanes, bool)
    factor_out = factor
    emit_out = emit
    state_out = state
    conv_out = jnp.ones(n_lanes, bool)

    def merge(mask, c, nr, ct, f, e, s, cv=None):
        nonlocal color, new_rays, cont, factor_out, emit_out, state_out
        nonlocal conv_out
        color = vec.where(mask, c, color)
        new_rays = Rays(
            o=vec.where(mask, nr.o, new_rays.o),
            d=vec.where(mask, nr.d, new_rays.d),
            tmin=jnp.where(mask, nr.tmin, new_rays.tmin),
            tmax=jnp.where(mask, nr.tmax, new_rays.tmax),
        )
        cont = jnp.where(mask, ct, cont)
        factor_out = vec.where(mask, f, factor_out)
        emit_out = jnp.where(mask, e, emit_out)
        state_out = jnp.where(mask, s, state_out)
        if cv is not None:
            conv_out = conv_out & (~mask | cv)

    albedo = _plane_albedo(scene, cfg, hit)

    # Lambertian (0)
    if SHADER_LAMBERTIAN in possible:
        m = sid == SHADER_LAMBERTIAN
        if cfg.mode == "path":
            c, nr, ct, f, e, s, cv = _shade_lambertian_path(
                scene, cfg, rays, hit, factor, emit, state
            )
            merge(m, c, nr, ct, f, e, s, cv)
        else:
            c, cv = _shade_lambertian_direct(scene, cfg, rays, hit, albedo)
            merge(m, c, rays, jnp.zeros(n_lanes, bool), factor, emit, state,
                  cv)

    # Phong (1) — direct-mode shading model.
    if SHADER_PHONG in possible:
        m = sid == SHADER_PHONG
        c = _shade_phong(scene, cfg, rays, hit)
        merge(m, c, rays, jnp.zeros(n_lanes, bool), factor, emit, state)

    # Mirror (2)
    if SHADER_MIRROR in possible:
        m = sid == SHADER_MIRROR
        nr = _reflect_continue(rays, hit, cfg)
        merge(
            m, z3, nr, jnp.ones(n_lanes, bool), factor,
            jnp.ones(n_lanes, bool) if cfg.mode == "path" else emit, state,
        )

    # Transmit (3) / Glossy (4) — deterministic dielectric (w2 family).
    if (
        SHADER_TRANSMIT in possible
        or SHADER_GLOSSY in possible
        or (SHADER_TRANSPARENT in possible and cfg.mode != "path")
    ):
        tc, tnr, tct, _tir = _shade_transmit_direct(rays, hit, cfg)
        if SHADER_TRANSMIT in possible:
            m = sid == SHADER_TRANSMIT
            merge(m, tc, tnr, tct, factor, emit, state)
        if SHADER_GLOSSY in possible:
            m = sid == SHADER_GLOSSY
            pc = _shade_phong(scene, cfg, rays, hit)
            merge(m, pc + tc, tnr, tct, factor, emit, state)
        if SHADER_TRANSPARENT in possible and cfg.mode != "path":
            m = sid == SHADER_TRANSPARENT
            merge(m, tc, tnr, tct, factor, emit, state)

    # Normal (5)
    if SHADER_NORMAL in possible:
        m = sid == SHADER_NORMAL
        merge(
            m, (hit.normal + 1.0) * 0.5, rays, jnp.zeros(n_lanes, bool),
            factor, emit, state,
        )

    # Base color (6): diffuse + ambient/emission (w9e2.wgsl:629-633).
    if SHADER_BASECOLOR in possible:
        m = sid == SHADER_BASECOLOR
        merge(
            m, albedo + hit.emission, rays, jnp.zeros(n_lanes, bool),
            factor, emit, state,
        )

    # Transparent (7) — stochastic Fresnel dielectric (path family).
    if SHADER_TRANSPARENT in possible and cfg.mode == "path":
        m = sid == SHADER_TRANSPARENT
        c, nr, ct, f, e, s = _shade_transparent_path(
            scene, cfg, rays, hit, factor, state
        )
        merge(m, c, nr, ct, f, e, s)

    # Holdout (8)
    if SHADER_HOLDOUT in possible:
        m = sid == SHADER_HOLDOUT
        c, s, cv = _shade_holdout(scene, cfg, rays, hit, factor, state)
        merge(m, c, rays, jnp.zeros(n_lanes, bool), factor, emit, s, cv)

    return color, new_rays, cont, factor_out, emit_out, state_out, conv_out


# ---------------------------------------------------------------------------
# Bounce loop and frame rendering
# ---------------------------------------------------------------------------


# Shader ids that can respawn a continuation ray. If a scene's
# possible_shaders has none of these, every lane terminates on its first
# hit and the bounce loop collapses to a single unrolled iteration.
_CONTINUATION_SHADERS = frozenset(
    {SHADER_MIRROR, SHADER_TRANSMIT, SHADER_GLOSSY, SHADER_TRANSPARENT}
)


def _single_bounce(cfg: SceneConfig) -> bool:
    return cfg.mode == "direct" and not (
        _CONTINUATION_SHADERS & set(cfg.possible_shaders)
    )


def bounce_loop(scene: Scene, cfg: SceneConfig, rays0: Rays, state0,
                seed_t=None, return_t=False):
    """The fragment-shader main loop (w8e3.wgsl:264-275) over the wavefront:
    iterate up to ``max_depth`` bounces, accumulating ``result += shade(...)``
    and stopping lanes on miss or terminal shade.

    Driver: cfg.loop == "while" exits as soon as every lane is done (one
    traversal total for terminal-shader scenes); "scan" runs the static
    depth and is reverse-mode differentiable. Scenes whose shader set has
    no continuation materials skip the loop machinery entirely (one
    unrolled iteration — the XLA analog of the reference compiling each
    scene's shader with only its own switch arms).

    ``seed_t``/``return_t`` (single-bounce driver only): temporal t-bound
    hint for the primary trace and the per-lane mesh hit distance to seed
    the next frame with (0 where the closest hit is not a mesh — analytic
    prims shrink the window before the mesh engine, so seeding those
    lanes would send them through the repair pass every frame).
    """
    n = rays0.o.shape[0]

    def body(carry, _, seed=None):
        rays, result, factor, emit, done, bad, state = carry
        # Done lanes collapse their ray interval to empty so every
        # traversal engine's alive-culling skips them — without this, a
        # fixed-depth scan re-traces the full original wavefront at every
        # remaining depth.
        rays = Rays(rays.o, rays.d, rays.tmin,
                    jnp.where(done, rays.tmin, rays.tmax))
        hit = trace_closest(scene, cfg, rays, seed_t=seed)
        bad = bad | (~done & ~hit.converged)

        miss = ~hit.valid & ~done
        if cfg.env_light and scene.env is not None:
            bg = tex.environment_map(
                scene.env, vec.normalize(rays.d, eps=1e-24)
            ) * factor
        else:
            bg = jnp.broadcast_to(
                jnp.asarray(cfg.bg_color, jnp.float32), (n, 3)
            )
        result = result + vec.where(miss, bg, 0.0)
        done_next = done | miss

        live = hit.valid & ~done
        color, new_rays, cont, factor2, emit2, state2, shade_conv = shade(
            scene, cfg, rays, hit, factor, emit, state
        )
        bad = bad | (live & ~shade_conv)
        if cfg.firefly_clamp > 0.0:
            color = jnp.minimum(color, cfg.firefly_clamp)
        result = result + vec.where(live, color, 0.0)
        rays = Rays(
            o=vec.where(live, new_rays.o, rays.o),
            d=vec.where(live, new_rays.d, rays.d),
            tmin=jnp.where(live, new_rays.tmin, rays.tmin),
            tmax=jnp.where(live, new_rays.tmax, rays.tmax),
        )
        factor = vec.where(live, factor2, factor)
        emit = jnp.where(live, emit2, emit)
        state = jnp.where(live, state2, state)
        done_next = done_next | (live & ~cont)
        return (
            (rays, result, factor, emit, done_next, bad, state),
            (hit.t, hit.valid & hit.is_mesh),
        )

    carry0 = (
        rays0,
        jnp.zeros((n, 3), jnp.float32),
        jnp.ones((n, 3), jnp.float32),
        jnp.ones(n, bool),  # emit starts true (hit_record_init)
        jnp.zeros(n, bool),
        jnp.zeros(n, bool),  # bad: traversal truncated somewhere
        state0,
    )
    if _single_bounce(cfg) and cfg.max_depth >= 1:
        carry, (t1, mesh1) = body(carry0, None, seed=seed_t)
        out = _paint_bad(carry[1], carry[5])
        if return_t:
            return out, jnp.where(mesh1, t1, 0.0)
        return out
    if cfg.loop == "while":
        def wcond(st):
            i, carry = st
            done = carry[4]
            return (i < cfg.max_depth) & jnp.any(~done)

        def wbody(st):
            i, carry = st
            carry, _ = body(carry, None)
            return i + 1, carry

        _, (rays, result, factor, emit, done, bad, state) = jax.lax.while_loop(
            wcond, wbody, (jnp.int32(0), carry0)
        )
        out = _paint_bad(result, bad)
        return (out, jnp.zeros(n, jnp.float32)) if return_t else out
    scan_body = body
    if cfg.remat != "none":
        # Trade recompute for residual memory in the backward sweep
        # (jax.checkpoint over the bounce body; prevent_cse=False is the
        # documented setting for scan bodies).
        policy = (
            jax.checkpoint_policies.checkpoint_dots
            if cfg.remat == "dots"
            else None
        )
        scan_body = jax.checkpoint(body, prevent_cse=False, policy=policy)
    (rays, result, factor, emit, done, bad, state), _ = jax.lax.scan(
        lambda c, x: (scan_body(c, x)[0], None), carry0, None,
        length=cfg.max_depth,
    )
    out = _paint_bad(result, bad)
    return (out, jnp.zeros(n, jnp.float32)) if return_t else out


def _paint_bad(result, bad):
    """Truncated-traversal lanes render the magenta error sentinel — the
    loud-failure analog of the reference's deliberate hang on stack
    underflow (bvh.wgsl:139-148): a clipped image is visibly wrong, never
    silently plausible."""
    return vec.where(bad, jnp.broadcast_to(ERROR_COLOR, result.shape), result)


def _frame(cfg: SceneConfig, band):
    """(traversal cfg, u, v, launch_idx) of the image rows ``band=(row0,
    rows)`` selects (``None``: the whole frame). ``row0`` may be traced;
    the band keeps the full frame's pixel coordinates and RNG streams, and
    traversal sees it as its frame. Rows past H are traced like any other.
    """
    w, h = cfg.width, cfg.height
    row0, rows = (0, h) if band is None else band
    u, v = pixel_uv(w, h, row0, rows)
    launch_idx = row0 * w + jnp.arange(w * rows, dtype=jnp.int32)
    if rows != h:
        cfg = dataclasses.replace(cfg, height=rows)
    return cfg, u, v, launch_idx.astype(jnp.uint32)


def _direct_rays(scene: Scene, cfg: SceneConfig, u, v):
    """Primary rays of each stratified sub-sample (w3e3.wgsl:150-165)."""
    jitters = scene.jitters
    if jitters is None:
        jitters = jnp.zeros((1, 2), jnp.float32)
    n = u.shape[0]
    out = []
    for i in range(jitters.shape[0]):
        rays = camera_rays(scene.camera, u, v, jnp.broadcast_to(jitters[i], (n, 2)))
        out.append(Rays(
            rays.o, rays.d,
            jnp.full(n, cfg.eta, jnp.float32),
            jnp.full(n, cfg.tmax, jnp.float32),
        ))
    return out


def render_sample(scene: Scene, cfg: SceneConfig, band=None):
    """Render one sample pass over the full W x H wavefront, or over the
    rows ``band=(row0, rows)`` selects (see ``_frame``).

    Path mode: per-pixel PRNG jitter seeded by (launch_idx, iteration)
    exactly as w8e3.wgsl:254-259. Direct mode: average over the stratified
    jitter table (w3e3.wgsl:150-165), subdivs^2 sub-samples.
    """
    h = cfg.height
    cfg, u, v, launch_idx = _frame(cfg, band)
    n = u.shape[0]
    state = rng.pixel_seed(launch_idx, scene.uniforms.iteration)
    if cfg.mode == "path":
        j1, state = rng.rnd(state)
        j2, state = rng.rnd(state)
        jitter = jnp.stack([j1, j2], axis=-1) / jnp.float32(h)
        rays = camera_rays(scene.camera, u, v, jitter)
        rays = Rays(
            rays.o, rays.d,
            jnp.full(n, cfg.eta, jnp.float32),
            jnp.full(n, cfg.tmax, jnp.float32),
        )
        return bounce_loop(scene, cfg, rays, state)
    # Direct mode: stratified subdivision table, zero RNG consumption.
    all_rays = _direct_rays(scene, cfg, u, v)
    acc = jnp.zeros((n, 3), jnp.float32)
    for rays in all_rays:
        acc = acc + bounce_loop(scene, cfg, rays, state)
    return acc / jnp.float32(len(all_rays))


def render_sample_seeded(scene: Scene, cfg: SceneConfig, seed_t, band=None):
    """``render_sample`` + temporal t-bound seeding for single-bounce
    direct scenes on the flat engine: the per-sub-tile break bounds start
    at last frame's depths instead of being discovered along the stream.
    Returns
    (radiance, next_seed). EXACT: lanes whose hint undershoots (moved
    camera, disocclusion) are re-traced by the flat engine's repair pass,
    so the radiance is bit-identical to the unseeded render.

    Falls back to plain ``render_sample`` (hint passed through) for
    path-mode / multi-bounce / non-treelet scenes.
    """
    seeded = (
        _single_bounce(cfg)
        and cfg.max_depth >= 1
        and scene.geom is not None
        and scene.tb is not None
        and _effective_traversal(scene, cfg) == "bvh"
    )
    if not seeded:
        return render_sample(scene, cfg, band), seed_t
    cfg, u, v, launch_idx = _frame(cfg, band)
    state = rng.pixel_seed(launch_idx, scene.uniforms.iteration)
    all_rays = _direct_rays(scene, cfg, u, v)
    acc = jnp.zeros((u.shape[0], 3), jnp.float32)
    for rays in all_rays:
        res, seed_t = bounce_loop(
            scene, cfg, rays, state, seed_t=seed_t, return_t=True
        )
        acc = acc + res
    return acc / jnp.float32(len(all_rays)), seed_t


def accumulate(result, accum, iteration):
    """Progressive mean: (result + accum * iter) / (iter + 1)
    (w8e3.wgsl:277-278)."""
    it = iteration.astype(jnp.float32)
    return (result + accum * it) / (it + 1.0)


def to_display(accum, cfg: SceneConfig):
    """Display transform: saturate(pow(accum, gamma)) with the reference's
    negative/NaN magenta guard (w8e3.wgsl:280-287)."""
    g = jnp.float32(cfg.gamma)
    framed = vec.saturate(jnp.power(jnp.maximum(accum, 0.0), g))
    bad = jnp.any(accum < 0.0, axis=-1) | jnp.any(jnp.isnan(accum), axis=-1)
    return vec.where(bad, jnp.broadcast_to(ERROR_COLOR, framed.shape), framed)


@partial(jax.jit, static_argnames=("cfg",))
def render_frame(scene: Scene, cfg: SceneConfig, accum):
    """One progressive frame: sample pass + accumulation. ``accum`` is the
    device-resident running mean (donate it at the call site for the
    ping-pong-free analog of the reference's texture pair)."""
    result = render_sample(scene, cfg)
    return accumulate(result, accum, scene.uniforms.iteration)
