"""Flat frustum traversal: dense super-tile culling + per-sub-tile hits.

The fully dense redesign of the reference's per-thread BVH walk
(``/root/reference/res/shaders/bvh.wgsl:154-191``) for *coherent* ray
wavefronts (primary rays, shadow rays): there is no tree and no walk.

* The frame is cut into 32x64-pixel **super-tiles** (2048 rays = 16
  sub-tiles of 8x16). Each super-tile is summarized by an interval bound
  (origin AABB, per-axis direction interval, t window).
* One dense (n_super, NT) conservative interval slab test culls every
  treelet against every super-tile in a single fused pass; the
  survivors are compacted to a near-ordered top-K emission list with
  ``jax.lax.top_k``.
* The surviving blocks are refined to quarter-blocks with per-sub-tile
  gate bits, and the hits stage recovers sub-tile precision: each
  sub-tile tests only the quarter-blocks its own frustum passes, keeps
  its own monotone early-break bound, and runs per-ray exact Möller tests
  — so the conservative cull costs extra block tests, never correctness.
  On the GPU the hits stage is the Pallas kernel
  ``tracer.kernels.super_hits``; on the CPU it is the plain-XLA form
  ``_phase_b_xla_q``, which is also the kernel's reference.

Super-tiles whose emission count exceeds K sweep the remaining blocks in
id order (rare: silhouette tiles with unbounded frustums), so arbitrarily
incoherent wavefronts stay correct — they just degrade toward brute force
over blocks, which is why the path-mode integrator keeps the per-ray
packet walk (``tracer.accel.packet``) instead.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tracer.accel.treelet import NQ, TreeletBvh
from tracer.kernels import super_hits
from tracer.kernels.intersect import Rays
from tracer.kernels.super_hits import NSUB, SUB, SUPER

# NumPy scalars, not jnp arrays: a jnp constant is captured by the traced
# program as an extra argument, which the platform-dependent hits stage
# (``_dispatch``) breaks on recompilation.
_INF = np.float32(3.0e38)
_BIG = np.float32(1.0e18)  # indefinite-interval sentinel (safe in products)
# Block emission budget per super-tile (each block streams as NQ
# quarter-blocks). Super-tiles with more cull survivors fall into the
# id-ordered overflow sweep, which stays exact but runs without the break.
K_EMIT = 96
MAX_ROUNDS = 4096

# Super-tile pixel geometry: 4x4 grid of 8x16 sub-tiles.
SUP_H, SUP_W = 32, 64
SUB_H, SUB_W = 8, 16


def _pads(W: int, H: int):
    Hp = -(-H // SUP_H) * SUP_H
    Wp = -(-W // SUP_W) * SUP_W
    return Hp, Wp


def to_supers(x: jnp.ndarray, W: int, H: int, fill):
    """(H*W, ...) row-major -> (n_super, SUPER, ...); sub-tile-major inside
    each super-tile. Pure layout ops."""
    Hp, Wp = _pads(W, H)
    rest = x.shape[1:]
    img = x.reshape(H, W, *rest)
    pad = ((0, Hp - H), (0, Wp - W)) + ((0, 0),) * len(rest)
    img = jnp.pad(img, pad, constant_values=fill)
    img = img.reshape(
        Hp // SUP_H, 4, SUB_H, Wp // SUP_W, 4, SUB_W, *rest
    )
    perm = (0, 3, 1, 4, 2, 5) + tuple(range(6, 6 + len(rest)))
    return img.transpose(perm).reshape(-1, SUPER, *rest)


def from_supers(x: jnp.ndarray, W: int, H: int):
    Hp, Wp = _pads(W, H)
    rest = x.shape[2:]
    img = x.reshape(Hp // SUP_H, Wp // SUP_W, 4, 4, SUB_H, SUB_W, *rest)
    perm = (0, 2, 4, 1, 3, 5) + tuple(range(6, 6 + len(rest)))
    img = img.transpose(perm).reshape(Hp, Wp, *rest)
    return img[:H, :W].reshape(H * W, *rest)


def _linear_supers(x: jnp.ndarray, fill):
    """Fallback for non-frame wavefronts: consecutive-lane sub-tiles."""
    n = x.shape[0]
    pad = (-n) % SUPER
    rest = x.shape[1:]
    x = jnp.concatenate(
        [x, jnp.full((pad, *rest), fill, x.dtype)]
    ) if pad else x
    return x.reshape(-1, SUPER, *rest)


def _interval_fields(o, d, tmin, prune):
    """Interval summary over the last ray axis. o, d: (..., L, 3);
    tmin, prune: (..., L)."""
    alive = prune > tmin
    a3 = alive[..., None]
    o_lo = jnp.min(jnp.where(a3, o, _BIG), axis=-2)
    o_hi = jnp.max(jnp.where(a3, o, -_BIG), axis=-2)
    d_lo = jnp.min(jnp.where(a3, d, _BIG), axis=-2)
    d_hi = jnp.max(jnp.where(a3, d, -_BIG), axis=-2)
    tmin_lo = jnp.min(jnp.where(alive, tmin, _BIG), axis=-1)
    prune_hi = jnp.max(jnp.where(alive, prune, -_BIG), axis=-1)
    any_alive = jnp.any(alive, axis=-1)
    return o_lo, o_hi, d_lo, d_hi, tmin_lo, prune_hi, any_alive


def interval_slab(lo, hi, o_lo, o_hi, d_lo, d_hi):
    """Conservative [near_lb, far_ub] of a ray-set interval bound vs slabs.

    All args (..., 3), broadcastable. Handles sign-spanning direction
    intervals without giving up the axis: rays whose d_k crosses 0 still
    need t >= gap / max|d_k| to reach a slab the origin box is outside of
    — this is what keeps frame-center tiles (d_x, d_y spanning 0) tightly
    culled instead of degenerating to an unbounded slab.
    """
    a_lo = lo - o_hi
    a_hi = lo - o_lo
    b_lo = hi - o_hi
    b_hi = hi - o_lo
    definite = (d_lo > 0.0) | (d_hi < 0.0)
    # Definite sign: 1/d is a proper interval (same sign, no pole).
    safe_lo = jnp.where(definite, d_lo, 1.0)
    safe_hi = jnp.where(definite, d_hi, 1.0)
    inv_lo = 1.0 / safe_hi
    inv_hi = 1.0 / safe_lo
    t0_lo, t0_hi = _imul(a_lo, a_hi, inv_lo, inv_hi)
    t1_lo, t1_hi = _imul(b_lo, b_hi, inv_lo, inv_hi)
    near_def = jnp.minimum(t0_lo, t1_lo)
    far_def = jnp.maximum(t0_hi, t1_hi)
    # Sign-spanning: no exit bound, but a valid entry bound if the origin
    # box sits outside the slab (gap > 0).
    gap = jnp.maximum(jnp.maximum(a_lo, -b_hi), 0.0)
    amax = jnp.maximum(jnp.maximum(-d_lo, d_hi), 1e-30)
    near_ind = gap / amax
    near = jnp.max(jnp.where(definite, near_def, near_ind), axis=-1)
    far = jnp.min(jnp.where(definite, far_def, _BIG), axis=-1)
    return near, far


def sub_bounds(o, d, tmin, prune):
    """Per-sub-tile packed bounds (n_super, NSUB, 16) for the hits kernel.
    Rows: [o_lo3, o_hi3, d_lo3, d_hi3, tmin_lo, alive, pad2]."""
    n_super = o.shape[0]
    os = o.reshape(n_super, NSUB, SUB, 3)
    ds = d.reshape(n_super, NSUB, SUB, 3)
    tm = tmin.reshape(n_super, NSUB, SUB)
    pr = prune.reshape(n_super, NSUB, SUB)
    o_lo, o_hi, d_lo, d_hi, tmin_lo, _, any_alive = _interval_fields(
        os, ds, tm, pr
    )
    return jnp.concatenate(
        [
            o_lo,
            o_hi,
            d_lo,
            d_hi,
            tmin_lo[..., None],
            any_alive[..., None].astype(jnp.float32),
            jnp.zeros((n_super, NSUB, 2), jnp.float32),
        ],
        axis=-1,
    )


def _imul(x_lo, x_hi, y_lo, y_hi):
    p1 = x_lo * y_lo
    p2 = x_lo * y_hi
    p3 = x_hi * y_lo
    p4 = x_hi * y_hi
    return (
        jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4)),
        jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4)),
    )


def _frustum_cull(tb: TreeletBvh, bounds):
    """(n_super, NT) conservative hit mask + near lower bound."""
    o_lo, o_hi, d_lo, d_hi, tmin_lo, prune_hi, any_alive = bounds
    near, far = interval_slab(
        tb.t_lo[None, :, :],
        tb.t_hi[None, :, :],
        o_lo[:, None, :],
        o_hi[:, None, :],
        d_lo[:, None, :],
        d_hi[:, None, :],
    )
    ok = (
        (near <= far)
        & (far >= tmin_lo[:, None])
        & (near < prune_hi[:, None])
        & any_alive[:, None]
    )
    return ok, jnp.where(ok, jnp.maximum(near, 0.0), _INF)


def _sub_gates_raw(tb, ids, sb, prune_sub):
    """Per-(emission, sub-tile, quarter-block) conservative frustum tests.

    ids: (ns, K); sb: (ns, NSUB, 16) packed sub bounds;
    prune_sub: (ns, NSUB) initial per-sub window top.
    -> ok (ns, K, NSUB, NQ) bool.
    """
    qb = tb.qbox[jnp.clip(ids, 0, tb.qbox.shape[0] - 1)]  # (ns, K, NQ, 6)
    lo = qb[:, :, None, :, 0:3]  # (ns, K, 1, NQ, 3)
    hi = qb[:, :, None, :, 3:6]
    o_lo = sb[:, None, :, None, 0:3]  # (ns, 1, NSUB, 1, 3)
    o_hi = sb[:, None, :, None, 3:6]
    d_lo = sb[:, None, :, None, 6:9]
    d_hi = sb[:, None, :, None, 9:12]
    near, far = interval_slab(lo, hi, o_lo, o_hi, d_lo, d_hi)
    tmin_lo = sb[:, None, :, None, 12]
    alive = sb[:, None, :, None, 13] > 0.5
    near = jnp.maximum(near, 0.0)
    return (
        (near <= far)
        & (far >= tmin_lo)
        & (near < prune_sub[:, None, :, None])
        & alive
    )  # (ns, K, NSUB, NQ)


def _dispatch(tb, eids, enear, en, gm, o, d, tmin, bt, bp, any_hit):
    """Hits stage for one quarter-block emission round: the Triton kernel
    when lowering for CUDA, the plain-XLA form when lowering for the CPU.
    Any other platform has no hits stage and fails to lower."""
    args = (tb, eids, enear, en, gm, o, d, tmin, bt, bp)
    return jax.lax.platform_dependent(
        *args,
        cpu=lambda tb, eids, enear, en, gm, o, d, tmin, bt, bp: (
            _phase_b_xla_q(tb, eids, en, o, d, tmin, bt, bp, any_hit)
        ),
        cuda=partial(super_hits.hits, any_hit=any_hit),
    )


def _phase_b_xla_q(tb, qids, en, o, d, tmin, best_t, best_pid, any_hit):
    """Plain-XLA hits stage: every emitted quarter-block against every ray
    of its super-tile, with neither the per-sub-tile gates nor the break.
    The CPU path and the reference the kernel is checked against."""
    from tracer.accel.packet import _moller_block

    NTQ = tb.qblocks.shape[0]
    K = qids.shape[1]

    def step(carry, k):
        bt, bp = carry
        qid = jnp.clip(qids[:, k], 0, NTQ - 1)
        blk = tb.qblocks[qid]  # (ns, 16, TQ)
        live = (k < en)[:, None]
        t, pid = _moller_block(blk, o, d, tmin, bt)
        if any_hit:
            bp = jnp.where(live & (t < _INF), 1.0, bp)
        else:
            better = live & (t < bt)
            bt = jnp.where(better, t, bt)
            bp = jnp.where(better, pid, bp)
        return (bt, bp), None

    (bt, bp), _ = jax.lax.scan(
        step, (best_t, best_pid), jax.lax.iota(jnp.int32, K)
    )
    return bt, bp


# Temporal seed slack: the previous frame's hit distance at a jittered
# sub-pixel bounds this frame's within (surface slope x jitter); lanes
# whose true hit lands beyond the slack fall into the exact repair pass.
SEED_REL = 1.01
SEED_ABS = 1.0e-3


def _run(rays: Rays, tb: TreeletBvh, frame, any_hit: bool, K: int | None = None,
         seed_t=None):
    if K is None:
        K = K_EMIT  # read at call time so tests can shrink the budget
    n = rays.o.shape[0]
    if frame is not None and frame[0] * frame[1] == n:
        W, H = frame
        tile = partial(to_supers, W=W, H=H)
        untile = partial(from_supers, W=W, H=H)
    else:
        tile = _linear_supers
        untile = lambda x: x.reshape(-1)[:n]

    o = tile(rays.o, fill=1.0e30)
    d = tile(rays.d, fill=1.0)
    tmin = tile(rays.tmin, fill=1.0)
    tmax = tile(rays.tmax, fill=0.0)
    n_super = o.shape[0]
    NT = tb.blocks.shape[0]
    K = min(K, NT)

    sb = sub_bounds(o, d, tmin, tmax)
    # Super-tile bound = union of its sub-tiles (reduce the packed fields).
    super_bounds = (
        jnp.min(sb[:, :, 0:3], axis=1),
        jnp.max(sb[:, :, 3:6], axis=1),
        jnp.min(sb[:, :, 6:9], axis=1),
        jnp.max(sb[:, :, 9:12], axis=1),
        jnp.min(
            jnp.where(sb[:, :, 13] > 0.5, sb[:, :, 12], _BIG), axis=1
        ),
        jnp.max(
            jnp.where(
                tmax.reshape(n_super, -1) > tmin.reshape(n_super, -1),
                tmax.reshape(n_super, -1),
                -_BIG,
            ),
            axis=1,
        ),
        jnp.any(sb[:, :, 13] > 0.5, axis=1),
    )
    ok, near = _frustum_cull(tb, super_bounds)
    total = jnp.sum(ok, axis=1, dtype=jnp.int32)
    negnear, ids = jax.lax.top_k(jnp.where(ok, -near, -_INF), K)
    enear = -negnear  # ascending conservative entry distance; INF pad

    # Per-sub-tile window tops for the quarter-block gates.
    prune_sub = jnp.max(
        jnp.where(
            tmax.reshape(n_super, NSUB, SUB) > tmin.reshape(n_super, NSUB, SUB),
            tmax.reshape(n_super, NSUB, SUB),
            -_BIG,
        ),
        axis=2,
    )
    # Temporal t-bound seeding (closest-hit only): clamp each lane's
    # initial best-t to last frame's hit distance (+ slack), so the
    # per-sub-tile break bounds start tight instead of being discovered
    # along the stream. Gates/emissions keep the ORIGINAL windows, so the
    # same emission list conservatively covers both the seeded pass and
    # the repair pass below.
    seeded_mask = None
    if seed_t is not None and not any_hit:
        st = tile(seed_t, fill=0.0)
        bound = st * jnp.float32(SEED_REL) + jnp.float32(SEED_ABS)
        seeded_mask = (st > 0.0) & (bound < tmax)
        bt0 = jnp.where(seeded_mask, bound, tmax)
    else:
        bt0 = tmax
    bp0 = jnp.full((n_super, SUPER), -1.0, jnp.float32)
    # Quarter-block emissions: each selected block expands to its NQ
    # quarters, each with one gate bit per sub-tile. Entries whose gate
    # word is empty stay in the list; the hits stage skips them.
    ok_q = _sub_gates_raw(tb, ids, sb, prune_sub)
    powers = jnp.arange(NSUB, dtype=jnp.int32)
    gm = jnp.sum(
        ok_q.astype(jnp.int32) << powers[None, None, :, None], axis=2
    ).reshape(n_super, K * NQ)
    ids = (
        ids[:, :, None] * NQ + jnp.arange(NQ, dtype=ids.dtype)[None, None, :]
    ).reshape(n_super, K * NQ)
    # Stream break key: the BLOCK near, replicated per quarter — the
    # stream is monotone in it (quarter nears are tighter but would break
    # the monotonicity the early exit relies on).
    enear = jnp.repeat(enear, NQ, axis=1)
    en1 = jnp.minimum(total, K) * NQ
    KD = K * NQ  # dispatch batch width (emission ids are quarters)
    ND = NT * NQ  # id-space size for the overflow sweep

    bt, bp = _dispatch(tb, ids, enear, en1, gm, o, d, tmin, bt0, bp0, any_hit)

    if seeded_mask is not None:
        # Exact repair: a seeded lane that found NOTHING under its clamped
        # window may have its true hit in (seed, tmax] — re-dispatch the
        # same (conservative, original-window) emission list with the full
        # window for exactly those lanes and a dead (-inf) window for the
        # rest. Steady state has zero unresolved lanes (the seed includes
        # slack), so the whole pass sits behind a lax.cond and costs one
        # any() reduce per frame.
        unresolved = (bp < 0.0) & seeded_mask

        def _repair(args):
            bt, bp = args
            btr, bpr = _dispatch(
                tb, ids, enear,
                jnp.where(jnp.any(unresolved, axis=1), en1, 0),
                gm, o, d, tmin,
                jnp.where(unresolved, tmax, -_INF),
                jnp.full_like(bp, -1.0),
                any_hit,
            )
            return (
                jnp.where(unresolved, btr, bt),
                jnp.where(unresolved, bpr, bp),
            )

        bt, bp = jax.lax.cond(
            jnp.any(unresolved), _repair, lambda args: args, (bt, bp)
        )

    # Overflow super-tiles (super-cull survivors > K) sweep the remaining
    # blocks in id order, en-gated so everyone else pays nothing.
    # Conservative superset (all sub-tiles gated on); the kernel's per-sub
    # bound check still culls, only the stream break is disabled
    # (enear = 0).
    overflow = total > K
    if NT > K:
        iota_ids = jnp.broadcast_to(
            jnp.arange(KD, dtype=jnp.int32)[None, :], (n_super, KD)
        )
        zeros = jnp.zeros((n_super, KD), jnp.float32)
        full_mask = jnp.full((n_super, KD), (1 << NSUB) - 1, jnp.int32)

        def round_body(carry):
            r, bt, bp = carry
            base = (r - 1) * KD  # sweep [0, ND): top-K picked by nearness
            ids_r = jnp.minimum(iota_ids + base, ND - 1)
            en_r = jnp.where(overflow, jnp.clip(ND - base, 0, KD), 0)
            bt, bp = _dispatch(
                tb, ids_r, zeros, en_r, full_mask, o, d, tmin, bt, bp,
                any_hit,
            )
            return r + 1, bt, bp

        def cond(c):
            return jnp.any(overflow) & ((c[0] - 1) * KD < ND) & (c[0] < MAX_ROUNDS)

        r_end, bt, bp = jax.lax.while_loop(
            cond, round_body, (jnp.int32(1), bt, bp)
        )
        # Converged iff the sweep covered every block before the round cap
        # (the reference crashes loudly on traversal overflow,
        # bvh.wgsl:139-148; we flag instead of hanging).
        conv_super = ~overflow | ((r_end - 1) * KD >= ND)
    else:
        conv_super = jnp.ones((n_super,), bool)

    bt = untile(bt)
    bp = untile(bp)
    conv = untile(
        jnp.broadcast_to(conv_super[:, None], (n_super, SUPER)).astype(
            jnp.float32
        )
    ) > 0.5
    return bt, bp, conv


def closest_hit(rays: Rays, tb: TreeletBvh, frame=None, with_conv=False,
                seed_t=None):
    """(t, prim_id) closest hit; prim_id == -1 on miss. Exact (the frustum
    cull is conservative; the per-ray hits kernel decides).

    ``seed_t``: optional (N,) per-ray upper-bound hint (0 = no hint),
    typically last frame's hit distance. EXACT regardless of hint quality:
    lanes whose hint undershoots are re-traced by the repair pass in
    ``_run``; a good hint only makes the stream break earlier.

    ``with_conv=True`` additionally returns a per-ray bool that is False
    when the overflow sweep hit its round cap before covering every block
    — a clipped traversal is detectable, never silent."""
    bt, bp, conv = _run(rays, tb, frame, any_hit=False, seed_t=seed_t)
    pid = bp.astype(jnp.int32)
    t = jnp.where(pid >= 0, bt, rays.tmax)
    if with_conv:
        return t, pid, conv
    return t, pid


def any_hit(rays: Rays, tb: TreeletBvh, frame=None, with_conv=False):
    """Occlusion query over [tmin, tmax]."""
    _, bp, conv = _run(rays, tb, frame, any_hit=True)
    if with_conv:
        return bp > 0.0, conv
    return bp > 0.0
