"""Vectorized ray-primitive intersection kernels (plain jnp).

Each WGSL intersection routine of the reference (sphere quadratic with
two-root select ``w9e2.wgsl:353-380``, plane ``:386-404``, Möller-style
triangle via cross products ``:309-351``, AABB slab test ``aabb.wgsl:8-31``)
becomes a *batched, branch-free* kernel over N rays: every lane evaluates the
full expression and validity is a mask. Attribute fetches (position, normal,
material) are deferred to hit-record reconstruction so the traversal loop only
carries ``(t, prim_id)`` — the key to a compact wavefront and a cheap custom
VJP (backward re-gathers by prim_id and re-derives t differentiably).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tracer.math import vec
from tracer.util import pytree_dataclass

INF = jnp.float32(3.0e38)


def _safe_denom(denom, tiny: float = 1.0e-20):
    """Sign-preserving clamp away from zero before a reciprocal.

    Lanes with |denom| < tiny are always rejected by the [tmin, tmax] window
    (t blows past tmax), but an unguarded 1/denom puts inf in the backward
    Jacobian and 0 * inf = NaN leaks through downstream ``where`` masks —
    this is what makes the whole forward pass differentiable wrt geometry.
    """
    mag = jnp.maximum(jnp.abs(denom), tiny)
    return jnp.where(denom < 0.0, -mag, mag)


@pytree_dataclass
class Rays:
    """A wavefront of rays, SoA over the batch axis."""

    o: jnp.ndarray  # (N, 3)
    d: jnp.ndarray  # (N, 3)
    tmin: jnp.ndarray  # (N,)
    tmax: jnp.ndarray  # (N,)


def make_rays(o, d, tmin=1.0e-5, tmax=5000.0):
    """``ray_init`` defaults: tmin=ETA, tmax=5000 (``w9e2.wgsl:45-52``).

    ETA is a per-scene shader constant in the reference (1e-5 in most
    shaders, up to 1e-2 in the large Cornell scenes); scenes pass their own.
    """
    o = jnp.asarray(o, jnp.float32)
    d = jnp.asarray(d, jnp.float32)
    batch = o.shape[:-1]
    return Rays(
        o=o,
        d=d,
        tmin=jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), batch),
        tmax=jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), batch),
    )


def sphere_t(rays: Rays, center, radius):
    """Closest valid root of the sphere quadratic; (t, valid).

    Matches ``intersect_sphere`` (``w9e2.wgsl:353-380``): try the near root,
    fall back to the far root, reject if both outside [tmin, tmax].
    """
    oc = rays.o - center
    a = vec.dot(rays.d, rays.d)
    b2 = vec.dot(oc, rays.d)
    c = vec.dot(oc, oc) - radius * radius
    disc = b2 * b2 - a * c
    # Double-where safe sqrt: sqrt's backward at 0 is inf, and 0 * inf = NaN
    # leaks through downstream `where` masks on miss lanes.
    disc_pos = disc > 0.0
    sq = jnp.where(disc_pos, jnp.sqrt(jnp.where(disc_pos, disc, 1.0)), 0.0)
    r0 = (-b2 - sq) / a
    r1 = (-b2 + sq) / a
    r0_ok = (r0 >= rays.tmin) & (r0 <= rays.tmax)
    r1_ok = (r1 >= rays.tmin) & (r1 <= rays.tmax)
    t = jnp.where(r0_ok, r0, r1)
    valid = (disc >= 0.0) & (r0_ok | r1_ok)
    return t, valid


def plane_t(rays: Rays, position, normal):
    """Infinite-plane hit distance; (t, valid) (``w9e2.wgsl:386-404``)."""
    denom = _safe_denom(vec.dot(rays.d, normal))
    t = vec.dot(position - rays.o, normal) / denom
    valid = (t >= rays.tmin) & (t <= rays.tmax)
    return t, valid


def triangle_t(rays: Rays, v0, v1, v2, eps_denom: float = 0.0):
    """Möller-style triangle test via cross products; (t, beta, gamma, valid).

    Matches ``intersect_triangle_indexed`` (``w9e2.wgsl:309-351``):
    ``nom = cross(v0 - o, d)``; ``beta = dot(nom, e1)/denom``;
    ``gamma = -dot(nom, e0)/denom``; ``t = dot(v0 - o, n)/denom``. The
    reference rejects ``|denom| < 1e-10`` for analytic triangles
    (``w1e6.wgsl:185-187``) but not for indexed mesh triangles; pass
    ``eps_denom`` accordingly.
    """
    e0 = v1 - v0
    e1 = v2 - v0
    o_to_v0 = v0 - rays.o
    n = vec.cross(e0, e1)
    nom = vec.cross(o_to_v0, rays.d)
    denom = _safe_denom(vec.dot(rays.d, n))
    inv = 1.0 / denom
    beta = vec.dot(nom, e1) * inv
    gamma = -vec.dot(nom, e0) * inv
    t = vec.dot(o_to_v0, n) * inv
    valid = (
        (beta >= 0.0)
        & (gamma >= 0.0)
        & (beta + gamma <= 1.0)
        & (t >= rays.tmin)
        & (t <= rays.tmax)
    )
    if eps_denom:
        valid = valid & (jnp.abs(denom) >= eps_denom)
    return t, beta, gamma, valid


def aabb_slab(rays: Rays, lo, hi, pad: float = 1.0e-4):
    """Scene-AABB interval clamp; returns (tmin', tmax', hit).

    Faithful to ``intersect_min_max`` (``aabb.wgsl:8-31``), which — unlike a
    textbook slab test — takes the *outer* envelope (min of per-axis mins,
    max of per-axis maxes), skips axes with |d| <= 1e-8, pads by +-1e-4, and
    clamps the ray interval. Conservative, so correct for its purpose of
    bounding the traversal interval.
    """
    inv_d = 1.0 / _safe_denom(rays.d, tiny=1.0e-20)
    t0 = (lo - rays.o) * inv_d
    t1 = (hi - rays.o) * inv_d
    pmin = jnp.minimum(t0, t1)
    pmax = jnp.maximum(t0, t1)
    axis_ok = jnp.abs(rays.d) > 1.0e-8
    tmin = jnp.min(jnp.where(axis_ok, pmin, INF), axis=-1)
    tmax = jnp.max(jnp.where(axis_ok, pmax, -INF), axis=-1)
    hit = ~((tmin > tmax) | (tmin > rays.tmax) | (tmax < rays.tmin))
    new_tmin = jnp.maximum(tmin - pad, rays.tmin)
    new_tmax = jnp.minimum(tmax + pad, rays.tmax)
    return new_tmin, new_tmax, hit


def node_slab(o, inv_d, tmin, tmax, lo, hi):
    """Branch-free node AABB test for traversal inner loops.

    The reference found a branchy early-out slab (``intersect_bb2``,
    ``bvh.wgsl:14-60``) beat a select-based one per GPU thread; over a
    lockstep wavefront every lane evaluates every test anyway, so the fused
    min/max form is used. Shapes: o/inv_d (..., 3); lo/hi broadcastable to
    them.
    """
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (near <= far) & (far >= tmin) & (near <= tmax)


def _moller_features(vertices, idx_c, valid_c):
    """(chunk,) triangle slab -> (10, 4*chunk) feature matrix for the
    matmul-form Möller test. Column groups: [beta_num | gamma_num |
    denom | t_num]; ray feature vector is [d, o x d, o, 1] so

        beta_num  = d.(e1 x v0) - (o x d).e1
        gamma_num = -d.(e0 x v0) + (o x d).e0
        denom     = n.d          t_num = (v0.n) - n.o

    (algebraically identical to ``triangle_t``'s cross-product form;
    reference ``w9e2.wgsl:309-351``). Also returns the n rows for the
    validity epilogue."""
    v0 = vertices[idx_c[:, 0]]  # (chunk, 3)
    v1 = vertices[idx_c[:, 1]]
    v2 = vertices[idx_c[:, 2]]
    e0 = v1 - v0
    e1 = v2 - v0
    nrm = jnp.cross(e0, e1)
    kpl = jnp.sum(v0 * nrm, axis=-1)
    bA = jnp.cross(e1, v0)
    bB = -jnp.cross(e0, v0)
    chunk = idx_c.shape[0]
    z = jnp.zeros((chunk,), jnp.float32)
    rows = []
    for a in range(3):
        rows.append(jnp.concatenate([bA[:, a], bB[:, a], nrm[:, a], z]))
    for a in range(3):
        rows.append(jnp.concatenate([-e1[:, a], e0[:, a], z, z]))
    for a in range(3):
        rows.append(jnp.concatenate([z, z, z, -nrm[:, a]]))
    rows.append(jnp.concatenate([z, z, z, kpl]))
    return jnp.stack(rows, axis=0), valid_c  # (10, 4*chunk)


def _ray_features(rays: Rays):
    oxd = jnp.cross(rays.o, rays.d)
    n = rays.o.shape[0]
    return jnp.concatenate(
        [rays.d, oxd, rays.o, jnp.ones((n, 1), jnp.float32)], axis=1
    )  # (N, 10)


def mesh_brute_force(rays: Rays, vertices, indices, chunk: int = 512):
    """Closest-hit over *all* triangles — the reference's w5 brute-force loop
    (``w5e2.wgsl:230-240``) as a matmul: one (N, 10) x (10, 4*chunk)
    product yields every (ray, tri) pair's Möller numerators with no
    (N, chunk, 3) rank-3 broadcast temps. Division-free validity:
    beta >= 0 etc. test numerator*denom signs.

    Returns (t, tri_id) with tri_id == -1 for miss. ``chunk`` is clamped
    to the lane-rounded triangle count (a 2048-pad on the 12-triangle
    Cornell box cost 170x redundant work and OOM'd the backward).
    """
    T = indices.shape[0]
    chunk = min(chunk, max(128, -(-T // 128) * 128))
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T
    idx_pad = jnp.pad(indices, ((0, pad), (0, 0)))
    valid_tri = jnp.arange(n_chunks * chunk) < T
    idx_chunks = idx_pad.reshape(n_chunks, chunk, 3)
    valid_chunks = valid_tri.reshape(n_chunks, chunk)
    tri_base = (jnp.arange(n_chunks) * chunk).astype(jnp.int32)
    rm = _ray_features(rays)

    def body(carry, xs):
        best_t, best_id = carry
        idx_c, valid_c, base = xs
        feat, _ = _moller_features(vertices, idx_c, valid_c)
        # HIGHEST: a reduced-precision f32 matmul (TF32 or bf16 passes)
        # would move intersection geometry; HIGHEST keeps f32 accuracy.
        out = jax.lax.dot(
            rm, feat, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )  # (N, 4*chunk)
        C = idx_c.shape[0]
        bn = out[:, 0:C]
        gn = out[:, C:2 * C]
        dn = out[:, 2 * C:3 * C]
        tn = out[:, 3 * C:4 * C]
        t = tn / _safe_denom(dn)
        ok = (
            (bn * dn >= 0.0)
            & (gn * dn >= 0.0)
            & ((bn + gn) * dn <= dn * dn)
            & (t >= rays.tmin[:, None])
            & (t <= best_t[:, None])
            & (dn != 0.0)
            & valid_c[None, :]
        )
        t = jnp.where(ok, t, INF)
        j = jnp.argmin(t, axis=1)
        t_best = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
        better = t_best < best_t
        best_t = jnp.where(better, t_best, best_t)
        best_id = jnp.where(better, base + j.astype(jnp.int32), best_id)
        return (best_t, best_id), None

    n = rays.o.shape[0]
    init = (rays.tmax, jnp.full((n,), -1, jnp.int32))
    (t, tri_id), _ = jax.lax.scan(
        body, init, (idx_chunks, valid_chunks, tri_base)
    )
    return t, tri_id


def mesh_brute_force_anyhit(rays: Rays, vertices, indices, chunk: int = 2048):
    """Any-hit (shadow) variant: boolean occlusion, no closest-hit bookkeeping
    — the analog of ``intersect_trimesh_immediate_return``
    (``/root/reference/res/shaders/bsp.wgsl:83-155``)."""
    T = indices.shape[0]
    chunk = min(chunk, max(128, -(-T // 128) * 128))
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T
    idx_pad = jnp.pad(indices, ((0, pad), (0, 0)))
    valid_tri = jnp.arange(n_chunks * chunk) < T
    idx_chunks = idx_pad.reshape(n_chunks, chunk, 3)
    valid_chunks = valid_tri.reshape(n_chunks, chunk)

    rm = _ray_features(rays)

    def body(blocked, xs):
        idx_c, valid_c = xs
        feat, _ = _moller_features(vertices, idx_c, valid_c)
        out = jax.lax.dot(
            rm, feat, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        C = idx_c.shape[0]
        bn = out[:, 0:C]
        gn = out[:, C:2 * C]
        dn = out[:, 2 * C:3 * C]
        tn = out[:, 3 * C:4 * C]
        t = tn / _safe_denom(dn)
        ok = (
            (bn * dn >= 0.0)
            & (gn * dn >= 0.0)
            & ((bn + gn) * dn <= dn * dn)
            & (t >= rays.tmin[:, None])
            & (t <= rays.tmax[:, None])
            & (dn != 0.0)
            & valid_c[None, :]
        )
        return blocked | jnp.any(ok, axis=1), None

    n = rays.o.shape[0]
    blocked, _ = jax.lax.scan(
        body, jnp.zeros((n,), bool), (idx_chunks, valid_chunks)
    )
    return blocked
