"""Vectorized BVH/BSP traversal (jnp) — the wavefront analog of the WGSL
per-thread stack loops.

The reference traverses with a ``var<private>`` node stack per GPU thread
(``/root/reference/res/shaders/bvh.wgsl:127-191``) and a branch stack for the
BSP (``bsp.wgsl:7-81``). Here a wavefront of N rays advances in *lockstep*:
the stack is an (N, DEPTH) array, every iteration gathers each lane's current
node, tests the slab, and either descends or pops — divergence is handled by
masks, not branches. The loop is a ``lax.while_loop`` bounded by an iteration
cap (the reference caps at 1000, ``bvh.wgsl:164``).

Traversal is intentionally non-differentiable: it returns integer primitive
ids (+ hit t for bookkeeping); hit attributes are re-derived differentiably
from the ids by the integrator, which is what makes the custom VJP cheap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tracer.accel.lbvh import BvhBuffers
from tracer.kernels.intersect import INF, Rays, triangle_t

STACK_DEPTH = 64  # radix-trie depth bound for 64-bit keys
MAX_ITERS = 1000  # safety bound, mirroring bvh.wgsl:164


def _leaf_hit(rays, best_t, vertices, indices, prim_ids, first, count, max_leaf):
    """Test up to ``max_leaf`` primitives of each lane's leaf; returns
    (t, prim) best candidates. Static unroll over the leaf slots — every
    lane tests its own gathered triangle per slot."""
    t_best = best_t
    id_best = jnp.full(best_t.shape, -1, jnp.int32)
    for k in range(max_leaf):
        slot_ok = k < count
        pid = prim_ids[jnp.clip(first + k, 0, prim_ids.shape[0] - 1)]
        tri = indices[pid]
        v0 = vertices[tri[:, 0]]
        v1 = vertices[tri[:, 1]]
        v2 = vertices[tri[:, 2]]
        sub = Rays(o=rays.o, d=rays.d, tmin=rays.tmin, tmax=t_best)
        t, _, _, ok = triangle_t(sub, v0, v1, v2)
        ok = ok & slot_ok
        id_best = jnp.where(ok & (t < t_best), pid, id_best)
        t_best = jnp.where(ok, jnp.minimum(t, t_best), t_best)
    return t_best, id_best


def bvh_closest_hit(rays: Rays, bvh: BvhBuffers, vertices, indices, max_leaf: int = 8):
    """Closest-hit traversal; returns (t, prim_id) with prim_id -1 on miss.

    Chunked (tracer.accel.bsp._chunked): each 16k-ray chunk runs its own
    while_loop, so worst-lane convergence is bounded per chunk."""
    from tracer.accel.bsp import _chunked

    return _chunked(
        rays,
        lambda r: _bvh_closest(r, bvh, vertices, indices, max_leaf),
    )


def _bvh_closest(rays: Rays, bvh: BvhBuffers, vertices, indices, max_leaf: int = 8):
    n = rays.o.shape[0]
    inv_d = 1.0 / rays.d

    def cond(state):
        it, cur, sp, stack, best_t, best_id = state
        return (it < MAX_ITERS) & jnp.any(cur >= 0)

    def body(state):
        it, cur, sp, stack, best_t, best_id = state
        active = cur >= 0
        node = jnp.clip(cur, 0, bvh.left.shape[0] - 1)
        lo = bvh.node_min[node]
        hi = bvh.node_max[node]
        t0 = (lo - rays.o) * inv_d
        t1 = (hi - rays.o) * inv_d
        near = jnp.max(jnp.minimum(t0, t1), axis=-1)
        far = jnp.min(jnp.maximum(t0, t1), axis=-1)
        box_hit = active & (near <= far) & (far >= rays.tmin) & (near <= best_t)

        count = bvh.count[node]
        is_leaf = count > 0
        do_leaf = box_hit & is_leaf

        # Leaf test (masked; lanes not at a leaf test garbage slots that are
        # masked out by do_leaf).
        lt, lid = _leaf_hit(
            rays,
            jnp.where(do_leaf, best_t, -INF),
            vertices,
            indices,
            bvh.prim_ids,
            bvh.first[node],
            jnp.where(do_leaf, count, 0),
            max_leaf,
        )
        got = do_leaf & (lid >= 0)
        best_id = jnp.where(got, lid, best_id)
        best_t = jnp.where(got, lt, best_t)

        # Descend: near child first (distance-ordered by child box entry t).
        descend = box_hit & ~is_leaf
        lchild = bvh.left[node]
        rchild = bvh.right[node]
        l_lo = bvh.node_min[lchild]
        l_hi = bvh.node_max[lchild]
        c0 = (l_lo - rays.o) * inv_d
        c1 = (l_hi - rays.o) * inv_d
        l_near = jnp.max(jnp.minimum(c0, c1), axis=-1)
        r_lo = bvh.node_min[rchild]
        r_hi = bvh.node_max[rchild]
        d0 = (r_lo - rays.o) * inv_d
        d1 = (r_hi - rays.o) * inv_d
        r_near = jnp.max(jnp.minimum(d0, d1), axis=-1)
        left_first = l_near <= r_near
        first_child = jnp.where(left_first, lchild, rchild)
        second_child = jnp.where(left_first, rchild, lchild)

        # Push the far child where descending (O(N) row scatter).
        row = jnp.arange(n)
        push = descend & (sp < STACK_DEPTH)
        sp_clamped = jnp.clip(sp, 0, STACK_DEPTH - 1)
        old_slot = stack[row, sp_clamped]
        stack = stack.at[row, sp_clamped].set(
            jnp.where(push, second_child, old_slot)
        )
        sp = jnp.where(push, sp + 1, sp)

        # Next node: descend -> first child; otherwise pop (or terminate).
        pop_needed = active & ~descend
        can_pop = pop_needed & (sp > 0)
        sp = jnp.where(can_pop, sp - 1, sp)
        popped = stack[row, jnp.clip(sp, 0, STACK_DEPTH - 1)]
        cur = jnp.where(
            descend,
            first_child,
            jnp.where(can_pop, popped, -1),
        )
        return it + 1, cur, sp, stack, best_t, best_id

    state = (
        jnp.int32(0),
        jnp.zeros(n, jnp.int32),  # cur = root
        jnp.zeros(n, jnp.int32),  # sp
        jnp.zeros((n, STACK_DEPTH), jnp.int32),
        rays.tmax,
        jnp.full(n, -1, jnp.int32),
    )
    _, _, _, _, best_t, best_id = jax.lax.while_loop(cond, body, state)
    return best_t, best_id


def bvh_any_hit(rays: Rays, bvh: BvhBuffers, vertices, indices, max_leaf: int = 8):
    """Occlusion query: True where any primitive blocks [tmin, tmax].

    The analog of ``intersect_trimesh_immediate_return`` (``bsp.wgsl:83``) —
    lanes that find a hit retire immediately (cur = -1), so the whole
    wavefront exits as soon as every ray is either blocked or exhausted.
    Chunked like bvh_closest_hit."""
    from tracer.accel.bsp import _chunked

    return _chunked(
        rays,
        lambda r: _bvh_anyhit(r, bvh, vertices, indices, max_leaf),
    )


def _bvh_anyhit(rays: Rays, bvh: BvhBuffers, vertices, indices, max_leaf: int = 8):
    n = rays.o.shape[0]
    inv_d = 1.0 / rays.d

    def cond(state):
        it, cur, sp, stack, blocked = state
        return (it < MAX_ITERS) & jnp.any(cur >= 0)

    def body(state):
        it, cur, sp, stack, blocked = state
        active = cur >= 0
        node = jnp.clip(cur, 0, bvh.left.shape[0] - 1)
        lo = bvh.node_min[node]
        hi = bvh.node_max[node]
        t0 = (lo - rays.o) * inv_d
        t1 = (hi - rays.o) * inv_d
        near = jnp.max(jnp.minimum(t0, t1), axis=-1)
        far = jnp.min(jnp.maximum(t0, t1), axis=-1)
        box_hit = (
            active & (near <= far) & (far >= rays.tmin) & (near <= rays.tmax)
        )

        count = bvh.count[node]
        is_leaf = count > 0
        do_leaf = box_hit & is_leaf
        _, lid = _leaf_hit(
            rays,
            jnp.where(do_leaf, rays.tmax, -INF),
            vertices,
            indices,
            bvh.prim_ids,
            bvh.first[node],
            jnp.where(do_leaf, count, 0),
            max_leaf,
        )
        newly = do_leaf & (lid >= 0)
        blocked = blocked | newly

        descend = box_hit & ~is_leaf & ~blocked
        lchild = bvh.left[node]
        rchild = bvh.right[node]
        row = jnp.arange(n)
        push = descend & (sp < STACK_DEPTH)
        sp_clamped = jnp.clip(sp, 0, STACK_DEPTH - 1)
        old_slot = stack[row, sp_clamped]
        stack = stack.at[row, sp_clamped].set(
            jnp.where(push, rchild, old_slot)
        )
        sp = jnp.where(push, sp + 1, sp)

        pop_needed = active & ~descend & ~blocked
        can_pop = pop_needed & (sp > 0)
        sp = jnp.where(can_pop, sp - 1, sp)
        popped = stack[row, jnp.clip(sp, 0, STACK_DEPTH - 1)]
        cur = jnp.where(
            descend, lchild, jnp.where(can_pop, popped, -1)
        )
        return it + 1, cur, sp, stack, blocked

    state = (
        jnp.int32(0),
        jnp.zeros(n, jnp.int32),
        jnp.zeros(n, jnp.int32),
        jnp.zeros((n, STACK_DEPTH), jnp.int32),
        jnp.zeros(n, bool),
    )
    _, _, _, _, blocked = jax.lax.while_loop(cond, body, state)
    return blocked
