"""Scene building: descriptor -> device ``Scene`` (and CPU-oracle scene).

The analog of ``RenderState::setup_rendering``
(``/root/reference/src/render_state.rs:161-265``): load OBJ/MTL, build the
acceleration structure, upload buffers, bind textures — except "upload" is
just ``jnp.asarray`` and "bind" is a pytree field.
"""

from __future__ import annotations

import os
from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from tracer.accel import lbvh
from tracer.geometry import obj as obj_mod
from tracer.geometry.device import (
    AnalyticTriangles,
    Planes,
    Spheres,
    upload_mesh,
)
from tracer.math.sampling import compute_jitters
from tracer.render import texture as tex
from tracer.render.camera import make_camera
from tracer.render.scene import Scene, make_scene, make_uniforms
from tracer.scenes.registry import SceneDescriptor


@lru_cache(maxsize=16)
def _load_mesh_cached(path: str, scale: float):
    from tracer.scenes import cache as disk_cache

    m = disk_cache.load_mesh(path, scale)
    if m is not None:
        return m
    if not os.path.exists(path):
        # bunny.obj / dragon.obj are listed in the reference's
        # .MISSING_LARGE_BLOBS — substitute a procedural stand-in of
        # comparable triangle count so the scene and benchmarks still run.
        from tracer.geometry.procedural import standin_for

        m = standin_for(path)
    else:
        m = obj_mod.load_obj(path)
        if scale != 1.0:
            m = m.scale(scale)
    disk_cache.save_mesh(path, scale, m)
    return m


@lru_cache(maxsize=16)
def _load_texture_cached(path: str, rgbe: bool):
    if not os.path.exists(path):
        import sys

        print(
            f"[build] texture '{path}' missing — scene falls back to the "
            f"background color (reference lists it in .MISSING_LARGE_BLOBS)",
            file=sys.stderr,
        )
        return None
    if path.endswith(".hdr"):
        return tex.load_radiance_hdr(path)
    if rgbe:
        return tex.load_rgbe_png(path)
    return tex.load_image(path)


def _possible_shaders(desc: SceneDescriptor):
    """Statically enumerate shader ids this scene can produce (analytic
    primitives + mesh shader, with selection sentinels resolved to the
    descriptor's current selections)."""
    ids = set()
    for s in desc.spheres:
        ids.add(_resolve_static(s[2], desc))
    for p in desc.planes:
        ids.add(_resolve_static(p[4], desc))
    for t in desc.tris:
        ids.add(_resolve_static(t[3], desc))
    if desc.model is not None:
        ids.add(_resolve_static(desc.cfg.mesh_shader, desc))
    ids.discard(255)
    return tuple(sorted(ids))


def _treelet_host(mesh, bvh_leaf: int):
    """Disk-cached host half of the treelet build (cut + top tree)."""
    from tracer.accel import treelet as treelet_mod
    from tracer.scenes import cache as disk_cache

    fp = disk_cache.mesh_fingerprint(mesh)
    host = disk_cache.load_treelet_host(fp, bvh_leaf, 1024)
    if host is None:
        binary = lbvh.build_for_mesh(mesh, max_prims=bvh_leaf)
        host = treelet_mod.build_host(binary, T=1024)
        disk_cache.save_treelet_host(fp, bvh_leaf, host)
    return host


def build_scene(desc: SceneDescriptor, timings: dict | None = None):
    """Build the device scene for a descriptor; returns (Scene, SceneConfig).

    ``timings``: optional dict that receives per-stage wall seconds
    (mesh_load / accel_host / device_assembly / textures / misc) — the
    build-cost attribution bench.py prints (the reference logs its BVH
    build time the same way, ``src/mesh.rs:237``).
    """
    import dataclasses
    import time as _time

    _t_start = _time.perf_counter()
    _marks = {}

    def _mark(name, t0):
        if timings is not None:
            _marks[name] = _marks.get(name, 0.0) + (_time.perf_counter() - t0)

    cfg = dataclasses.replace(
        desc.cfg,
        possible_shaders=_possible_shaders(desc),
        max_leaf=min(desc.cfg.max_leaf, desc.bvh_leaf),
    )
    f32 = jnp.float32

    # Analytic primitives: every field rides ONE packed transfer instead
    # of 13 tiny uploads.
    from tracer.geometry.device import pack_upload

    ana_parts = []
    if desc.spheres:
        c, r, sh, bc, ior, ext = zip(*desc.spheres)
        ana_parts += [
            np.asarray(c, np.float32), np.asarray(r, np.float32),
            np.asarray(sh, np.int32), np.asarray(bc, np.float32),
            np.asarray(ior, np.float32), np.asarray(ext, np.float32),
        ]
    if desc.planes:
        p, n, tg, bn, sh, bc, txd = zip(*desc.planes)
        ana_parts += [
            np.asarray(p, np.float32), np.asarray(n, np.float32),
            np.asarray(tg, np.float32), np.asarray(bn, np.float32),
            np.asarray(sh, np.int32), np.asarray(bc, np.float32),
            np.asarray([int(t) for t in txd], np.int32),
        ]
    if desc.tris:
        v0, v1, v2, sh, bc = zip(*desc.tris)
        ana_parts += [
            np.stack([np.stack(v) for v in zip(v0, v1, v2)], axis=0).astype(
                np.float32
            ),
            np.asarray(sh, np.int32), np.asarray(bc, np.float32),
        ]
    ana_dev = iter(pack_upload(ana_parts))
    spheres = planes = tris = None
    if desc.spheres:
        spheres = Spheres(
            center=next(ana_dev), radius=next(ana_dev), shader=next(ana_dev),
            base_color=next(ana_dev), ior=next(ana_dev),
            extinction=next(ana_dev),
        )
    if desc.planes:
        planes = Planes(
            position=next(ana_dev), normal=next(ana_dev),
            tangent=next(ana_dev), binormal=next(ana_dev),
            shader=next(ana_dev), base_color=next(ana_dev),
            textured=next(ana_dev),
        )
    if desc.tris:
        tris = AnalyticTriangles(
            verts=next(ana_dev), shader=next(ana_dev),
            base_color=next(ana_dev),
        )

    geom = materials = light_indices = bvh = wide = tb = bsp = None
    if desc.model is not None:
        _t0 = _time.perf_counter()
        mesh = _load_mesh_cached(desc.model, desc.model_scale)
        _mark("mesh_load", _t0)
        # Tiny meshes: a dense brute-force sweep (no random access at all)
        # instead of a gather-based traversal.
        if mesh.num_triangles <= 64 and cfg.traversal in ("bvh", "bsp"):
            cfg = dataclasses.replace(cfg, traversal="brute")
        treelet_wanted = cfg.traversal == "bvh" or (
            cfg.traversal == "bsp" and cfg.bsp_execution == "fast"
        )
        host = None
        if treelet_wanted:
            # Host half FIRST so the pid table rides the single packed
            # geometry transfer.
            _t0 = _time.perf_counter()
            host = _treelet_host(mesh, desc.bvh_leaf)
            _mark("accel_host", _t0)
        _t0 = _time.perf_counter()
        extra = []
        if host is not None:
            extra = [host.pids, host.top, host.t_lo, host.t_hi,
                     host.box_table, host.counts.astype(np.int32)]
        geom, materials, light_indices, extra_dev = upload_mesh(
            mesh, extra=extra
        )
        _mark("upload", _t0)
        if host is not None:
            # Treelet-cut traversal (accel.packet/flat) — the wavefront
            # redesign of the reference's per-thread BVH walk
            # (res/shaders/bvh.wgsl:154-191). The 94 MB block table is
            # gathered on device from the already-uploaded geometry.
            from tracer.accel import treelet as treelet_mod

            _t0 = _time.perf_counter()
            tb = treelet_mod.from_host(
                host, geom.vertices, geom.indices, dev=extra_dev
            )
            _mark("device_assembly", _t0)
        if cfg.traversal == "bvh8":
            from tracer.accel import wide as wide_mod

            binary = lbvh.build_for_mesh(mesh, max_prims=desc.bvh_leaf)
            wide = wide_mod.build(binary, mesh.vertices, mesh.indices)
        elif cfg.traversal == "bvh2":
            import jax

            bvh = jax.tree.map(
                jnp.asarray,
                lbvh.build_for_mesh(mesh, max_prims=desc.bvh_leaf),
            )
        elif cfg.traversal == "bsp" and cfg.bsp_execution != "fast":
            # BSP scenes with bsp_execution="fast" execute through the
            # treelet engines built above (a closest/any-hit query is
            # traversal-independent); only the
            # faithful-walk parity path builds the BSP tree itself.
            import jax

            from tracer.accel import bsp as bsp_mod

            bsp = jax.tree.map(jnp.asarray, bsp_mod.build_for_mesh(mesh))

    _t0 = _time.perf_counter()
    env = _load_texture_cached(desc.hdri, desc.hdri_rgbe) if desc.hdri else None
    texture = _load_texture_cached(desc.texture, False) if desc.texture else None
    _mark("textures", _t0)

    jitters = None
    if cfg.mode != "path" and cfg.subdivs > 1:
        jitters = jnp.asarray(compute_jitters(1.0 / cfg.height, cfg.subdivs))

    uniforms = make_uniforms(
        selection1=desc.selection1,
        selection2=desc.selection2,
        use_texture=tex.TEX_DEFAULT if desc.texture else tex.TEX_NONE,
    )
    cam = make_camera(**desc.camera)
    scene = make_scene(
        cam,
        uniforms=uniforms,
        spheres=spheres,
        planes=planes,
        tris=tris,
        geom=geom,
        materials=materials,
        light_indices=light_indices,
        bvh=bvh,
        wide=wide,
        tb=tb,
        bsp=bsp,
        env=env,
        texture=texture,
        jitters=jitters,
    )
    if timings is not None:
        total = _time.perf_counter() - _t_start
        _marks["misc"] = total - sum(_marks.values())
        _marks["total"] = total
        timings.update(_marks)
    return scene, cfg


def build_oracle_scene(desc: SceneDescriptor):
    """Build the matching CPU-oracle scene; returns (OracleScene, cfg, cam)."""
    from tracer.oracle.cpu_tracer import OracleScene

    cfg = desc.cfg
    sc = OracleScene()
    for (c, r, sh, bc, ior, ext) in desc.spheres:
        sid = _resolve_static(sh, desc)
        sc.spheres.append(
            (np.array(c, np.float32), np.float32(r), sid,
             np.array(bc, np.float32), np.float32(ior),
             np.array(ext, np.float32))
        )
    for (p, n, tg, bn, sh, bc, txd) in desc.planes:
        sid = _resolve_static(sh, desc)
        sc.planes.append(
            (np.array(p, np.float32), np.array(n, np.float32),
             np.array(tg, np.float32), np.array(bn, np.float32), sid,
             np.array(bc, np.float32), bool(txd))
        )
    for (v0, v1, v2, sh, bc) in desc.tris:
        sid = _resolve_static(sh, desc)
        sc.tris.append(
            (np.array(v0, np.float32), np.array(v1, np.float32),
             np.array(v2, np.float32), sid, np.array(bc, np.float32))
        )
    if desc.model is not None:
        mesh = _load_mesh_cached(desc.model, desc.model_scale)
        sc.mesh_vertices = mesh.vertices
        sc.mesh_normals = mesh.normals
        sc.mesh_indices = mesh.indices.astype(np.int64)
        sc.mesh_matids = np.where(
            mesh.mat_ids == 0xFFFFFFFF, 0, mesh.mat_ids
        ).astype(np.int64)
        sc.mat_diffuse = np.stack([m.diffuse for m in mesh.materials])
        sc.mat_emission = np.stack([m.ambient for m in mesh.materials])
        sc.light_indices = list(mesh.light_indices())
        sc.mesh_shader = _resolve_static(cfg.mesh_shader, desc)
        sc.use_vertex_normals = cfg.use_vertex_normals
    if desc.texture:
        t = _load_texture_cached(desc.texture, False)
        if t is not None:
            sc.texture_img = np.asarray(t.data)
            sc.tex_mode = tex.TEX_DEFAULT
    if desc.hdri:
        e = _load_texture_cached(desc.hdri, desc.hdri_rgbe)
        if e is not None:
            sc.env_img = np.asarray(e.data)
            sc.env_rgbe = e.kind == tex.ENV_RGBE
    return sc, cfg, dict(desc.camera)


def _resolve_static(shader_code: int, desc: SceneDescriptor) -> int:
    from tracer.render.scene import FROM_SELECTION1, FROM_SELECTION2

    if shader_code == FROM_SELECTION1:
        return desc.selection1
    if shader_code == FROM_SELECTION2:
        return desc.selection2
    return shader_code
