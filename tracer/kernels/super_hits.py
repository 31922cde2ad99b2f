"""Pallas (Triton) kernel: gated, early-breaking hits for coherent rays.

The hot half of the flat frustum engine (``tracer.accel.flat``). The XLA
side culls treelet blocks per 2048-ray super-tile, expands the survivors to
a near-ordered list of quarter-blocks (``tb.qblocks``, T/NQ triangles
each) and packs, per emission, one 16-bit gate word: bit ``s`` set iff
sub-tile ``s`` (128 rays) may intersect that quarter-block.

One program serves one 128-ray sub-tile (grid = super-tiles x 16
sub-tiles). It walks its super-tile's emission list in near order:

* entries whose gate bit for this sub-tile is clear are skipped;
* the walk stops once the next entry's conservative entry distance
  reaches the sub-tile's current bound (the largest best-t over its live
  rays, kept in registers) — no later block can improve any of its rays;
* a gated entry runs the Möller test of the 128 rays against the
  quarter-block, loaded in ``TC``-triangle chunks sized for registers.

The arithmetic is the plane-form Möller test of
``tracer.accel.packet._moller_block`` (the plain-XLA reference that
``tracer.accel.flat._phase_b_xla_q`` runs). Reference analog: the
per-thread BVH walk + leaf loop of ``res/shaders/bvh.wgsl:154-191``, with
a sub-tile of rays in place of one thread.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

SUB = 128  # rays per sub-tile (8x16 pixels)
NSUB = 16  # sub-tiles per super-tile
SUPER = SUB * NSUB  # rays per super-tile (32x64 pixels)

# Triangles per Möller chunk, so (SUB, TC) tiles stay in registers, and
# warps per program: the fastest pair of a sweep on the H100 (tc 4-64,
# 2-8 warps); Triton's pipeline-stage count made no measurable difference.
TC = 8
NUM_WARPS = 4

_INF = 3.0e38  # plain float: a jnp scalar would be a captured constant


def _kernel(ids_ref, enear_ref, gm_ref, en_ref, qblk_ref, rays_ref,
            best_ref, out_ref, *, K: int, TQ: int, tc: int, any_hit: bool):
    s = pl.program_id(0)
    sub = pl.program_id(1)
    lanes = pl.ds(sub * SUB, SUB)
    ray = lambda j: rays_ref[s, j, lanes][:, None]  # (SUB, 1)
    ox, oy, oz = ray(0), ray(1), ray(2)
    dx, dy, dz = ray(3), ray(4), ray(5)
    tn = ray(6)
    top = best_ref[s, 0, lanes]
    bp0 = best_ref[s, 1, lanes]
    # Any-hit: occluded lanes drop out of every window test and of the
    # break bound.
    bt0 = jnp.where(bp0 > 0.0, -_INF, top) if any_hit else top
    n = en_ref[s]

    def chunk(eid, j, carry):
        bt, bp = carry
        cols = pl.ds(j * tc, tc)
        c = lambda r: qblk_ref[eid, r, cols][None, :]  # (1, tc)
        nx, ny, nz = c(11), c(12), c(13)
        inv = 1.0 / (nx * dx + ny * dy + nz * dz)  # (SUB, tc)
        t = (c(14) - (nx * ox + ny * oy + nz * oz)) * inv
        sx = c(0) - ox
        sy = c(1) - oy
        sz = c(2) - oz
        nomx = sy * dz - sz * dy
        nomy = sz * dx - sx * dz
        nomz = sx * dy - sy * dx
        beta = (nomx * c(6) + nomy * c(7) + nomz * c(8)) * inv
        gamma = -(nomx * c(3) + nomy * c(4) + nomz * c(5)) * inv
        ok = (
            (beta >= 0.0)
            & (gamma >= 0.0)
            & (beta + gamma <= 1.0)
            & (t >= tn)
            & (t < bt[:, None])
            & (c(10) > 0.5)
        )
        tc_ = jnp.where(ok, t, _INF)
        tbest = jnp.min(tc_, axis=1)  # (SUB,)
        if any_hit:
            hit = tbest < _INF
            return jnp.where(hit, -_INF, bt), jnp.where(hit, 1.0, bp)
        pid = jnp.min(
            jnp.where(tc_ <= tbest[:, None], c(9), _INF), axis=1
        )
        better = tbest < bt
        return jnp.where(better, tbest, bt), jnp.where(better, pid, bp)

    def cond(carry):
        k, bt, _ = carry
        near = enear_ref[s, jnp.minimum(k, K - 1)]
        return (k < n) & (near < jnp.max(bt))

    def body(carry):
        k, bt, bp = carry
        eid = ids_ref[s, k]
        gated = ((gm_ref[s, k] >> sub) & 1) != 0
        bt, bp = jax.lax.cond(
            gated,
            lambda c: jax.lax.fori_loop(
                0, TQ // tc, functools.partial(chunk, eid), c
            ),
            lambda c: c,
            (bt, bp),
        )
        return k + 1, bt, bp

    _, bt, bp = jax.lax.while_loop(cond, body, (jnp.int32(0), bt0, bp0))
    out_ref[s, 0, lanes] = top if any_hit else bt
    out_ref[s, 1, lanes] = bp


def hits(tb, eids, enear, en, gatemask, o, d, tmin, best_t, best_pid,
         any_hit: bool, *, interpret: bool = False, tc: int = TC):
    """Consume one near-ordered quarter-block emission list per super-tile.

    o, d: (n_super, SUPER, 3); tmin/best_t/best_pid: (n_super, SUPER);
    eids/enear/gatemask: (n_super, K) quarter ids (tid*NQ + q), their
    conservative entry distances (non-decreasing) and gate words; en:
    (n_super,) live entries. best_pid is carried as f32 (ids are exact
    below 2^24); for any-hit it is the occlusion flag (> 0). Returns the
    updated (best_t, best_pid).

    ``interpret=True`` runs the kernel in the Pallas interpreter (tests);
    ``tc`` is the triangle chunk width (clamped to the quarter-block).
    """
    n_super = tmin.shape[0]
    K = eids.shape[1]
    TQ = tb.qblocks.shape[2]
    tc = min(tc, TQ)
    assert TQ % tc == 0, (TQ, tc)
    rays8 = jnp.stack(
        [o[..., 0], o[..., 1], o[..., 2], d[..., 0], d[..., 1], d[..., 2],
         tmin, best_t],
        axis=1,
    )  # (n_super, 8, SUPER)
    best = jnp.stack([best_t, best_pid], axis=1)  # (n_super, 2, SUPER)
    ids = jnp.clip(eids, 0, tb.qblocks.shape[0] - 1).astype(jnp.int32)
    out = pl.pallas_call(
        functools.partial(_kernel, K=K, TQ=TQ, tc=tc, any_hit=any_hit),
        grid=(n_super, NSUB),
        out_shape=jax.ShapeDtypeStruct((n_super, 2, SUPER), jnp.float32),
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="flat_hits",
    )(ids, enear.astype(jnp.float32), gatemask.astype(jnp.int32),
      en.astype(jnp.int32), tb.qblocks, rays8, best)
    return out[:, 0], out[:, 1]
