"""Tile-packet traversal over a treelet-cut BVH (tracer.accel.treelet).

A redesign of the reference's per-thread BVH walk
(``/root/reference/res/shaders/bvh.wgsl:154-191``): instead of one
divergent stack per ray (per-lane gathers + scatters), a *tile* of
spatially coherent rays (a 16x8 pixel block by default) shares one
traversal of the top tree:

* node fetch = one 64-word row per **tile** per step (a (C,) gather over
  the tile-chunk, thousands of times fewer rows than per-ray traversal);
* the 8-wide slab test runs for all rays of the tile at once — dense
  (C, 8, TILE) math;
* treelet hits are not descended but **emitted** to a per-tile worklist in
  near order; the dense ray-tile x triangle-block intersection runs in a
  separate stage (``_phase_b_xla``, a scan over emission slots).

Rounds: a tile pauses when its emission buffer fills; after the hits stage
updates per-ray best-t, traversal resumes with the tighter pruning bound.
Coherent primary/shadow tiles finish in one round; incoherent bounce tiles
take a few more, each cheaper than the last because ``best_t`` culls.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tracer.accel.treelet import TreeletBvh
from tracer.kernels.intersect import Rays
from tracer.util import pytree_dataclass

_INF = np.float32(3.0e38)  # NumPy scalar: see tracer.accel.flat._INF
MAX_IT = 1 << 17
TILE_H = 8
TILE_W = 16  # 16x8 pixel packets: TILE = 128 rays
TILE = TILE_H * TILE_W
K_EMIT = 64  # per-round treelet emission capacity per tile
CHUNK_TILES = 4096  # lockstep tile-chunk (phase A retires chunks independently)
MAX_ROUNDS = 256


# ---------------------------------------------------------------------------
# Tile ordering: row-major pixels <-> (n_tiles, TILE) packets.
# ---------------------------------------------------------------------------


def _pads(W: int, H: int):
    Hp = -(-H // TILE_H) * TILE_H
    Wp = -(-W // TILE_W) * TILE_W
    return Hp, Wp


def to_tiles(x: jnp.ndarray, W: int, H: int, fill):
    """(H*W, ...) row-major -> (n_tiles, TILE, ...), zero-cost layout ops."""
    Hp, Wp = _pads(W, H)
    rest = x.shape[1:]
    img = x.reshape(H, W, *rest)
    pad = ((0, Hp - H), (0, Wp - W)) + ((0, 0),) * len(rest)
    img = jnp.pad(img, pad, constant_values=fill)
    img = img.reshape(Hp // TILE_H, TILE_H, Wp // TILE_W, TILE_W, *rest)
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(rest)))
    return img.transpose(perm).reshape(-1, TILE, *rest)


def from_tiles(x: jnp.ndarray, W: int, H: int):
    Hp, Wp = _pads(W, H)
    rest = x.shape[2:]
    img = x.reshape(Hp // TILE_H, Wp // TILE_W, TILE_H, TILE_W, *rest)
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(rest)))
    img = img.transpose(perm).reshape(Hp, Wp, *rest)
    return img[:H, :W].reshape(H * W, *rest)


def _linear_tiles(x: jnp.ndarray, fill):
    """Fallback tiling for non-frame wavefronts: consecutive lanes."""
    n = x.shape[0]
    pad = (-n) % TILE
    rest = x.shape[1:]
    x = jnp.concatenate(
        [x, jnp.full((pad, *rest), fill, x.dtype)]
    ) if pad else x
    return x.reshape(-1, TILE, *rest)


# ---------------------------------------------------------------------------
# Phase A: lockstep packet traversal of the top tree (per tile-chunk).
# ---------------------------------------------------------------------------


@pytree_dataclass
class TravState:
    """Resumable per-tile traversal state, stacked (n_chunks, C, ...)."""

    cur: jnp.ndarray  # (..., C) i32 current top row
    level: jnp.ndarray  # (..., C) i32
    asc: jnp.ndarray  # (..., C) bool — ascending (pop next sibling)
    done: jnp.ndarray  # (..., C) bool — traversal exhausted
    paused: jnp.ndarray  # (..., C) bool — emission buffer filled
    snear: jnp.ndarray  # (..., C, D, 8) f32 sibling-stack nears
    sref: jnp.ndarray  # (..., C, D, 8) i32 sibling-stack row refs


def _init_state(n_chunks: int, C: int, D: int) -> TravState:
    z = lambda *s, **kw: jnp.zeros((n_chunks, C, *s), **kw)
    return TravState(
        cur=z(dtype=jnp.int32),
        level=z(dtype=jnp.int32),
        asc=z(dtype=bool),
        done=z(dtype=bool),
        paused=z(dtype=bool),
        snear=jnp.full((n_chunks, C, D, 8), _INF, jnp.float32),
        sref=jnp.full((n_chunks, C, D, 8), -1, jnp.int32),
    )


def _unpack_i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _phase_a_chunk(top, D: int, K: int, st: TravState, o, d, tmin, prune):
    """Run one chunk of tiles until everyone is done or paused.

    ``prune``: per-ray upper bound on useful t (best-t so far for closest
    hit; -inf for already-occluded lanes in any-hit mode). Returns the
    resumable state and this round's emissions (ids, nears, count).
    """
    C, TILE_ = o.shape[0], o.shape[1]
    R = top.shape[0]
    inv_d = 1.0 / d

    eids0 = jnp.zeros((C, K), jnp.int32)
    enear0 = jnp.full((C, K), _INF, jnp.float32)
    en0 = jnp.zeros((C,), jnp.int32)
    st = dataclasses.replace(st, paused=jnp.zeros_like(st.paused))

    def cond(s):
        it = s[0]
        stt = s[1]
        return (it < MAX_IT) & jnp.any(~stt.done & ~stt.paused)

    def body(s):
        it, stt, eids, enear, en = s
        cur, level, asc, done, paused = (
            stt.cur,
            stt.level,
            stt.asc,
            stt.done,
            stt.paused,
        )
        snear, sref = stt.snear, stt.sref
        active = ~done & ~paused
        visit = active & ~asc

        row = top[jnp.clip(cur, 0, R - 1)]  # (C, 8, 8)
        lo = row[:, :, 0:3]
        hi = row[:, :, 3:6]
        ref = _unpack_i32(row[:, :, 6])  # (C, 8)

        # 8-wide slab test against every ray of the tile: (C, 8, TILE).
        t0 = (lo[:, :, None, :] - o[:, None, :, :]) * inv_d[:, None, :, :]
        t1 = (hi[:, :, None, :] - o[:, None, :, :]) * inv_d[:, None, :, :]
        near = jnp.max(jnp.minimum(t0, t1), axis=-1)
        far = jnp.min(jnp.maximum(t0, t1), axis=-1)
        ray_ok = (
            (near <= far)
            & (far >= tmin[:, None, :])
            & (near < prune[:, None, :])
        )
        child_hit = jnp.any(ray_ok, axis=-1)  # (C, 8)
        child_near = jnp.min(
            jnp.where(ray_ok, jnp.maximum(near, 0.0), _INF), axis=-1
        )  # (C, 8)

        is_tre = ref <= -2
        is_inner = ref >= 0
        tre_key = jnp.where(
            visit[:, None] & child_hit & is_tre, child_near, _INF
        )
        ikey = jnp.where(
            visit[:, None] & child_hit & is_inner, child_near, _INF
        )

        # --- Emit treelet children in near order (selection over 8 slots —
        # dense argmin+one-hot, no per-lane gathers).
        tids = -2 - ref
        kiota = jax.lax.broadcasted_iota(jnp.int32, (C, K), 1)
        n_add = jnp.zeros((C,), jnp.int32)
        for _ in range(8):
            a = jnp.argmin(tre_key, axis=1)
            sel = jax.nn.one_hot(a, 8, dtype=bool)
            mn = jnp.min(tre_key, axis=1)
            live = mn < _INF
            tid = jnp.sum(jnp.where(sel, tids, 0), axis=1)
            wslot = kiota == (en + n_add)[:, None]
            w = wslot & live[:, None]
            eids = jnp.where(w, tid[:, None], eids)
            enear = jnp.where(w, mn[:, None], enear)
            n_add = n_add + live.astype(jnp.int32)
            tre_key = jnp.where(sel, _INF, tre_key)
        en = en + n_add

        # --- Descend into nearest inner child; park siblings at stack[level].
        c_arg = jnp.argmin(ikey, axis=1)
        c_sel = jax.nn.one_hot(c_arg, 8, dtype=bool)
        c_min = jnp.min(ikey, axis=1)
        has_child = visit & (c_min < _INF)
        c_ref = jnp.sum(jnp.where(c_sel, ref, 0), axis=1)

        # Ascend: pop nearest unconsumed sibling at this level, pruned
        # against the loosest per-ray bound (conservative).
        amax = jnp.max(prune, axis=1)  # (C,)
        lvl = jnp.clip(level, 0, D - 1)
        lvl_hot = (
            jax.lax.broadcasted_iota(jnp.int32, (C, D), 1) == lvl[:, None]
        )
        s_near = jnp.sum(jnp.where(lvl_hot[:, :, None], snear, 0.0), axis=1)
        s_ref = jnp.sum(jnp.where(lvl_hot[:, :, None], sref, 0), axis=1)
        a_key = jnp.where(s_near < amax[:, None], s_near, _INF)
        a_arg = jnp.argmin(a_key, axis=1)
        a_sel = jax.nn.one_hot(a_arg, 8, dtype=bool)
        a_min = jnp.min(a_key, axis=1)
        a_has = asc & active & (a_min < _INF)
        a_ref = jnp.sum(jnp.where(a_sel, s_ref, 0), axis=1)

        new_near = jnp.where(
            has_child[:, None],
            jnp.where(c_sel, _INF, ikey),
            jnp.where(a_has[:, None] & a_sel, _INF, s_near),
        )
        new_ref = jnp.where(has_child[:, None], ref, s_ref)
        snear = jnp.where(lvl_hot[:, :, None], new_near[:, None, :], snear)
        sref = jnp.where(lvl_hot[:, :, None], new_ref[:, None, :], sref)

        # --- Transitions.
        go_asc = (visit & ~has_child) | (asc & active & ~a_has)
        descend = has_child | a_has
        cur = jnp.where(has_child, c_ref, jnp.where(a_has, a_ref, cur))
        level = jnp.where(descend, lvl + 1, jnp.where(go_asc, level - 1, level))
        asc = jnp.where(descend, False, jnp.where(go_asc, True, asc))
        done = done | (go_asc & (level < 0))
        # Pause before visiting a node that might not fit 8 more emissions.
        paused = paused | (active & ~done & (en > K - 8))
        stt = TravState(cur, level, asc, done, paused, snear, sref)
        return it + 1, stt, eids, enear, en

    out = jax.lax.while_loop(cond, body, (jnp.int32(0), st, eids0, enear0, en0))
    _, st, eids, enear, en = out
    return st, (eids, enear, en)


# ---------------------------------------------------------------------------
# Phase B: dense ray-tile x treelet-block intersection.
# ---------------------------------------------------------------------------


def _moller_block(blk, o, d, tmin, upper):
    """Dense Moller test of a ray set against a triangle block.

    blk (..., 16, T) feature-major per tracer.accel.treelet; rays
    (..., TILE, 3). Returns (t, pid) per ray: min valid t within the block
    (INF on none) and its primitive id as f32 (-1 on none). Plane-form t
    (k - o.n)/(d.n) with barycentric inside tests — algebraically the
    Moller-style test of the reference (``w9e2.wgsl:309-351``) with n, k
    precomputed per triangle.
    """
    c = lambda j: blk[..., j, :][..., :, None]  # (..., T, 1)
    rx = lambda j: o[..., None, :, j]  # (..., 1, TILE)
    dx = lambda j: d[..., None, :, j]
    nx, ny, nz = c(11), c(12), c(13)
    denom = nx * dx(0) + ny * dx(1) + nz * dx(2)
    inv = 1.0 / denom
    t = (c(14) - (nx * rx(0) + ny * rx(1) + nz * rx(2))) * inv
    sx = c(0) - rx(0)
    sy = c(1) - rx(1)
    sz = c(2) - rx(2)
    # nom = cross(v0 - o, d)
    nomx = sy * dx(2) - sz * dx(1)
    nomy = sz * dx(0) - sx * dx(2)
    nomz = sx * dx(1) - sy * dx(0)
    beta = (nomx * c(6) + nomy * c(7) + nomz * c(8)) * inv
    gamma = -(nomx * c(3) + nomy * c(4) + nomz * c(5)) * inv
    ok = (
        (beta >= 0.0)
        & (gamma >= 0.0)
        & (beta + gamma <= 1.0)
        & (t >= tmin[..., None, :])
        & (t < upper[..., None, :])
        & (blk[..., 10, :][..., :, None] > 0.5)
    )
    tc = jnp.where(ok, t, _INF)
    tbest = jnp.min(tc, axis=-2)  # (..., TILE)
    pid = jnp.where(tc <= tbest[..., None, :], c(9), _INF)
    pbest = jnp.min(pid, axis=-2)
    pbest = jnp.where(tbest < _INF, pbest, -1.0)
    return tbest, pbest


def _phase_b_xla(tb: TreeletBvh, eids, en, o, d, tmin, best_t, best_pid, any_hit):
    """Scan over emission slots; one (n_tiles, T, TILE) dense test per slot."""
    NT = tb.blocks.shape[0]
    K = eids.shape[1]

    def step(carry, k):
        bt, bp = carry
        ids = eids[:, k]
        live = k < en
        blk = tb.blocks[jnp.clip(ids, 0, NT - 1)]  # (n_tiles, T, 16)
        upper = jnp.where(live[:, None], bt, -_INF)
        t, pid = _moller_block(blk, o, d, tmin, upper)
        if any_hit:
            bp = jnp.where(t < _INF, 1.0, bp)
        else:
            better = t < bt
            bt = jnp.where(better, t, bt)
            bp = jnp.where(better, pid, bp)
        return (bt, bp), None

    (bt, bp), _ = jax.lax.scan(step, (best_t, best_pid), jnp.arange(K))
    return bt, bp


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def _run(rays: Rays, tb: TreeletBvh, frame, any_hit: bool):
    n = rays.o.shape[0]
    if frame is not None and frame[0] * frame[1] == n:
        W, H = frame
        tile = partial(to_tiles, W=W, H=H)
        untile = partial(from_tiles, W=W, H=H)
    else:
        tile = _linear_tiles
        untile = lambda x: x.reshape(-1)[:n]

    # Dead padding rays: origin far outside, window empty -> all masks false.
    o = tile(rays.o, fill=1.0e30)
    d = tile(rays.d, fill=1.0)
    tmin = tile(rays.tmin, fill=1.0)
    tmax = tile(rays.tmax, fill=0.0)
    n_tiles = o.shape[0]

    C = min(CHUNK_TILES, n_tiles)
    pad = (-n_tiles) % C
    if pad:
        o = jnp.concatenate([o, jnp.full((pad, TILE, 3), 1.0e30, o.dtype)])
        d = jnp.concatenate([d, jnp.ones((pad, TILE, 3), d.dtype)])
        tmin = jnp.concatenate([tmin, jnp.ones((pad, TILE), tmin.dtype)])
        tmax = jnp.concatenate([tmax, jnp.zeros((pad, TILE), tmax.dtype)])
    nc = (n_tiles + pad) // C
    och = o.reshape(nc, C, TILE, 3)
    dch = d.reshape(nc, C, TILE, 3)
    tminch = tmin.reshape(nc, C, TILE)
    tmaxch = tmax.reshape(nc, C, TILE)

    D = max(tb.depth, 1)
    st0 = _init_state(nc, C, D)
    bt0 = tmaxch  # closest: prune at current best; any-hit: window top
    bp0 = jnp.full((nc, C, TILE), -1.0, jnp.float32)
    top = tb.top

    def phase_a_all(st, prune):
        def f(args):
            s, oo, dd, tn, pr = args
            return _phase_a_chunk(top, D, K_EMIT, s, oo, dd, tn, pr)

        return jax.lax.map(f, (st, och, dch, tminch, prune))

    def round_body(carry):
        st, bt, bp, r = carry
        if any_hit:
            prune = jnp.where(bp > 0.0, -_INF, tmaxch)
        else:
            prune = bt
        st, (eids, enear, en) = phase_a_all(st, prune)
        flat = lambda x: x.reshape(nc * C, *x.shape[2:])
        bt2, bp2 = _phase_b_xla(
            tb,
            flat(eids),
            flat(en),
            flat(och),
            flat(dch),
            flat(tminch),
            flat(bt),
            flat(bp),
            any_hit,
        )
        bt = bt2.reshape(nc, C, TILE)
        bp = bp2.reshape(nc, C, TILE)
        return st, bt, bp, r + 1

    carry = round_body((st0, bt0, bp0, jnp.int32(0)))

    # Round bound scaled to the structure: a pathological tile may need to
    # emit every treelet, i.e. ceil(NT / K_EMIT) rounds (advisor finding:
    # a fixed 256-round cap could silently drop intersections on large
    # meshes with small T).
    NT_ = tb.blocks.shape[0]
    max_rounds = max(MAX_ROUNDS, -(-NT_ * 2 // K_EMIT) + 8)

    def cond(c):
        return jnp.any(c[0].paused) & (c[3] < max_rounds)

    st, bt, bp, _ = jax.lax.while_loop(cond, round_body, carry)

    bt = untile(bt.reshape(nc * C, TILE)[:n_tiles])
    bp = untile(bp.reshape(nc * C, TILE)[:n_tiles])
    # A tile whose walk finished has done=True; one cut off by the round
    # cap (still paused) or the in-chunk iteration cap (neither done nor
    # paused) is truncated — surface it (reference analog: the deliberate
    # loud hang of bvh.wgsl:139-148).
    conv_tile = st.done.reshape(nc * C)[:n_tiles]
    conv = untile(
        jnp.broadcast_to(
            conv_tile[:, None], (n_tiles, TILE)
        ).astype(jnp.float32)
    ) > 0.5
    return bt, bp, conv


def closest_hit(rays: Rays, tb: TreeletBvh, frame=None, with_conv=False):
    """(t, prim_id) closest hit; prim_id == -1 on miss.

    ``frame=(W, H)``: when the wavefront is a full row-major frame, rays are
    regrouped into 8x8 pixel packets (pure layout ops); otherwise packets
    are consecutive lanes. ``with_conv=True`` additionally returns the
    per-ray truncation flag (False = walk was cut off by a cap).
    """
    bt, bp, conv = _run(rays, tb, frame, any_hit=False)
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
