"""Wide (8-ary) BVH — a fat-row traversal structure.

Why this exists: a binary BVH walk over a lockstep wavefront does many
narrow per-lane gathers plus stack scatters per step. This structure
trades them for fewer, wider accesses:

* **one fat row per traversal step**: a node row packs EITHER 8 children
  AABBs + refs (inner) OR up to 8 whole triangles + their ids (leaf) into a
  single 96-word gather;
* **zero scatters**: ordered depth-first traversal uses a base-8 *trail*
  integer (Laine-style restart trail) + parent refs instead of a stack;
* **8-wide slab tests and rank selection** are dense array arithmetic.

The reference's analogous component is the flattened binary ``GpuNode`` BVH +
per-thread stack (``/root/reference/src/data_structures/hlbvh.rs:195-234``,
``res/shaders/bvh.wgsl:127-191``); this is a wavefront redesign of it, built by
collapsing the binary LBVH from ``tracer.accel.lbvh``.

Row layout (width 96 f32, ints bitcast):
  [0]  parent ref (i32; -1 at root)
  [1]  leaf count (i32; 0 => inner node)
  inner: [2 .. 50)  8 children x (minx,miny,minz,maxx,maxy,maxz)
         [50 .. 58) 8 children refs (i32; -1 empty, else row index)
  leaf:  [2 .. 74)  8 triangles x 9 vertex floats (v0,v1,v2)
         [74 .. 82) 8 original triangle ids (i32; -1 padding)
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from tracer.accel.lbvh import BvhBuffers
from tracer.kernels.intersect import Rays
from tracer.util import pytree_dataclass

ROW = 96
B = 8  # branching factor
K = 8  # max triangles per leaf row
# 4-bit trail digits (rank can reach 8) packed into TWO int32 words:
# levels 0..7 in the low word, 8..15 in the high word.
MAX_LEVELS = 16
_INF = np.float32(3.0e38)


@pytree_dataclass(static=("depth",))
class WideBvh:
    table: jnp.ndarray  # (M, 96) f32
    depth: int = MAX_LEVELS


def _subtree_prims(bvh: BvhBuffers):
    """Contiguous sorted-prim range (first, count) of every node — Karras
    ranges are contiguous, so any subtree is a slice of prim_ids."""
    M = bvh.left.shape[0]
    first = bvh.first.astype(np.int64).copy()
    count = bvh.count.astype(np.int64).copy()
    internal = bvh.count == 0
    il = bvh.left[internal].astype(np.int64)
    ir = bvh.right[internal].astype(np.int64)
    ii = np.nonzero(internal)[0]
    for _ in range(64):
        nf = np.minimum(first[il], first[ir])
        nc = count[il] + count[ir]
        if np.array_equal(nf, first[ii]) and np.array_equal(nc, count[ii]):
            break
        first[ii] = nf
        count[ii] = nc
    return first, count


def build(bvh: BvhBuffers, vertices: np.ndarray, indices: np.ndarray) -> WideBvh:
    """Collapse a binary LBVH into the wide single-table layout.

    Greedy expansion: starting from a binary node, repeatedly split the
    child subtree with the most primitives until 8 slots are filled; any
    slot whose subtree holds <= 8 primitives becomes a packed leaf row.
    """
    sub_first, sub_count = _subtree_prims(bvh)
    verts = np.asarray(vertices, np.float32)
    idx = np.asarray(indices, np.int64)
    prim_ids = bvh.prim_ids.astype(np.int64)

    rows: list[np.ndarray] = []

    def new_row(parent: int) -> int:
        r = np.zeros(ROW, np.float32)
        r[0] = np.int32(parent).view(np.float32)
        rows.append(r)
        return len(rows) - 1

    def fill_leaf(row_id: int, first: int, count: int) -> None:
        r = rows[row_id]
        r[1] = np.int32(count).view(np.float32)
        ids = prim_ids[first : first + count]
        tri = idx[ids]
        v = verts[tri.reshape(-1)].reshape(count, 9)
        r[2 : 2 + count * 9] = v.reshape(-1)
        pid = np.full(K, -1, np.int32)
        pid[:count] = ids.astype(np.int32)
        r[74:82] = pid.view(np.float32)

    def node_bbox(i: int):
        return bvh.node_min[i], bvh.node_max[i]

    max_depth = 0

    def emit(node: int, parent_row: int, depth: int) -> int:
        """Emit binary subtree `node` as one wide row; returns row id."""
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        me = new_row(parent_row)
        if sub_count[node] <= K:
            fill_leaf(me, int(sub_first[node]), int(sub_count[node]))
            return me
        # Inner: greedily split the largest slots until B children.
        slots = [node]
        while len(slots) < B:
            # pick the splittable slot with the most primitives
            cand = [s for s in slots if bvh.count[s] == 0 and sub_count[s] > K]
            if not cand:
                break
            s = max(cand, key=lambda x: sub_count[x])
            slots.remove(s)
            slots.extend([int(bvh.left[s]), int(bvh.right[s])])
        r = rows[me]
        refs = np.full(B, -1, np.int32)
        for ci, s in enumerate(slots):
            lo, hi = node_bbox(s)
            r[2 + ci * 6 : 2 + ci * 6 + 3] = lo
            r[2 + ci * 6 + 3 : 2 + ci * 6 + 6] = hi
            refs[ci] = emit(s, me, depth + 1)
        rows[me][50:58] = refs.view(np.float32)
        return me

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        emit(0, -1, 1)
    finally:
        sys.setrecursionlimit(old)
    assert max_depth <= MAX_LEVELS, f"wide BVH depth {max_depth} > {MAX_LEVELS}"
    table = np.stack(rows)
    return WideBvh(table=jnp.asarray(table), depth=max_depth)


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------

# Safety cap far above any real traversal (every row is visited at most once
# and each ascend step consumes a stack slot, so iterations are bounded by
# ~2x rows-intersected); the reference uses the same belt-and-braces bound
# idea at 1000 (``bvh.wgsl:164``).
MAX_ITERS = 1 << 17

# Wavefront chunk: the while-loop runs to its *worst* lane, so traversal is
# tiled into chunks that retire independently — coherent chunks (sky tiles,
# shallow regions) exit after a handful of iterations instead of riding along
# with the deepest ray in the frame.
CHUNK = 16384


def _unpack_i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _traverse(rays: Rays, wb: WideBvh, any_hit: bool):
    """Ordered DFS with a per-level sibling stack — each row visited once.

    Per-lane state: current row, level, and a (depth, 8) stack of the sibling
    (near, ref) rows written on the way down. Visiting an inner row slab-tests
    all 8 children, descends into the nearest, and parks the rest at
    ``stack[level]``; when a subtree finishes, ascend steps argmin-pick the
    next unconsumed sibling (pruned against the shrinking ``best_t``) without
    ever re-gathering the parent table row. This replaces the earlier
    restart-trail walk, which paid one parent-row revisit per child (~5x the
    iterations). Any-hit retires a lane at its first confirmed intersection.
    """
    n = rays.o.shape[0]
    table = wb.table
    D = max(int(wb.depth), 1)
    o = rays.o
    d = rays.d
    inv_d = 1.0 / d
    tmin0 = rays.tmin

    def cond(st):
        it, cur, level, asc, done, snear, sref, best_t, best_id = st
        return (it < MAX_ITERS) & jnp.any(~done)

    def body(st):
        it, cur, level, asc, done, snear, sref, best_t, best_id = st
        visit = ~done & ~asc
        row = table[jnp.clip(cur, 0, table.shape[0] - 1)]  # (N, 96)
        leaf_count = _unpack_i32(row[:, 1])
        is_leaf = visit & (leaf_count > 0)

        # ---- Leaf: test K triangles, vectorized over the slot axis (dense
        # math; the data is already in-row from the single table gather).
        tri = row[:, 2:74].reshape(n, K, 9)
        pid = _unpack_i32(row[:, 74:82])  # (N, K)
        v0 = tri[:, :, 0:3]
        v1 = tri[:, :, 3:6]
        v2 = tri[:, :, 6:9]
        e0 = v1 - v0
        e1 = v2 - v0
        o_to_v0 = v0 - o[:, None, :]
        nrm = jnp.cross(e0, e1)
        nom = jnp.cross(o_to_v0, d[:, None, :])
        denom = jnp.sum(d[:, None, :] * nrm, axis=-1)
        inv = 1.0 / denom
        beta = jnp.sum(nom * e1, axis=-1) * inv
        gamma = -jnp.sum(nom * e0, axis=-1) * inv
        t = jnp.sum(o_to_v0 * nrm, axis=-1) * inv
        slot = jax.lax.broadcasted_iota(jnp.int32, (n, K), 1)
        ok = (
            is_leaf[:, None]
            & (slot < leaf_count[:, None])
            & (pid >= 0)
            & (beta >= 0.0)
            & (gamma >= 0.0)
            & (beta + gamma <= 1.0)
            & (t >= tmin0[:, None])
            & (t <= best_t[:, None])
        )
        tcand = jnp.where(ok, t, _INF)
        karg = jnp.argmin(tcand, axis=1)
        ksel = jax.nn.one_hot(karg, K, dtype=bool)
        kmin = jnp.min(tcand, axis=1)
        got = kmin < best_t
        best_id = jnp.where(
            got, jnp.sum(jnp.where(ksel, pid, 0), axis=1), best_id
        )
        best_t = jnp.where(got, kmin, best_t)

        # ---- Inner: 8-wide slab test, descend into the nearest child.
        boxes = row[:, 2:50].reshape(n, B, 6)
        refs = _unpack_i32(row[:, 50:58])  # (N, 8)
        t0 = (boxes[:, :, 0:3] - o[:, None, :]) * inv_d[:, None, :]
        t1 = (boxes[:, :, 3:6] - o[:, None, :]) * inv_d[:, None, :]
        near = jnp.max(jnp.minimum(t0, t1), axis=-1)  # (N, 8)
        far = jnp.min(jnp.maximum(t0, t1), axis=-1)
        child_ok = (
            (refs >= 0)
            & (near <= far)
            & (far >= tmin0[:, None])
            & (near < best_t[:, None])
        )
        tkey = jnp.where(child_ok, jnp.maximum(near, 0.0), _INF)
        c_arg = jnp.argmin(tkey, axis=1)
        c_sel = jax.nn.one_hot(c_arg, B, dtype=bool)
        c_key = jnp.min(tkey, axis=1)
        has_child = visit & ~is_leaf & (c_key < _INF)
        c_ref = jnp.sum(jnp.where(c_sel, refs, 0), axis=1)

        # ---- Per-level sibling stack row at this lane's level. The stack is
        # small and dense (N, D, 8); reads/writes go through one-hot level
        # masks — dense selects — instead of per-lane gathers/scatters.
        lvl = jnp.clip(level, 0, D - 1)
        lvl_hot = (
            jax.lax.broadcasted_iota(jnp.int32, (n, D), 1) == lvl[:, None]
        )  # (N, D)
        s_near = jnp.sum(jnp.where(lvl_hot[:, :, None], snear, 0.0), axis=1)
        s_ref = jnp.sum(jnp.where(lvl_hot[:, :, None], sref, 0), axis=1)
        a_key = jnp.where(s_near < best_t[:, None], s_near, _INF)
        a_arg = jnp.argmin(a_key, axis=1)
        a_sel = jax.nn.one_hot(a_arg, B, dtype=bool)
        a_min = jnp.min(a_key, axis=1)
        a_has = asc & ~done & (a_min < _INF)
        a_ref = jnp.sum(jnp.where(a_sel, s_ref, 0), axis=1)

        # Stack writes: inner-descend lanes park the non-chosen siblings at
        # stack[level]; ascend-pick lanes consume their chosen slot (INF);
        # everyone else's row is rewritten with its own unchanged value.
        new_near = jnp.where(
            has_child[:, None],
            jnp.where(c_sel, _INF, tkey),
            jnp.where((a_has[:, None] & a_sel), _INF, s_near),
        )
        new_ref = jnp.where(has_child[:, None], refs, s_ref)
        snear = jnp.where(lvl_hot[:, :, None], new_near[:, None, :], snear)
        sref = jnp.where(lvl_hot[:, :, None], new_ref[:, None, :], sref)

        # ---- Transitions.
        go_asc = (visit & ~has_child) | (asc & ~done & ~a_has)
        descend = has_child | a_has
        if any_hit:
            retired = ~done & (best_id >= 0)
            go_asc = go_asc & ~retired
            descend = descend & ~retired
            done = done | retired
        cur = jnp.where(has_child, c_ref, jnp.where(a_has, a_ref, cur))
        level = jnp.where(
            descend, lvl + 1, jnp.where(go_asc, level - 1, level)
        )
        asc = jnp.where(descend, False, jnp.where(go_asc, True, asc))
        done = done | (go_asc & (level < 0))
        return it + 1, cur, level, asc, done, snear, sref, best_t, best_id

    st = (
        jnp.int32(0),
        jnp.zeros(n, jnp.int32),  # cur = root row 0
        jnp.zeros(n, jnp.int32),  # level
        jnp.zeros(n, bool),  # ascending
        jnp.zeros(n, bool),  # done
        jnp.full((n, D, B), _INF, jnp.float32),  # stack nears
        jnp.full((n, D, B), -1, jnp.int32),  # stack refs
        rays.tmax,
        jnp.full(n, -1, jnp.int32),
    )
    out = jax.lax.while_loop(cond, body, st)
    best_t, best_id = out[-2], out[-1]
    # Lanes still walking when MAX_ITERS tripped are truncated — surface
    # it (reference analog: deliberate loud hang, bvh.wgsl:139-148).
    conv = out[4]
    return best_t, best_id, conv


def _traverse_chunked(rays: Rays, wb: WideBvh, any_hit_flag: bool, chunk: int):
    n = rays.o.shape[0]
    if n <= chunk:
        return _traverse(rays, wb, any_hit_flag)
    pad = (-n) % chunk
    c = (n + pad) // chunk

    def padded(x, fill):
        if x.ndim == 1:
            x = jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)])
            return x.reshape(c, chunk)
        x = jnp.concatenate([x, jnp.full((pad, x.shape[1]), fill, x.dtype)])
        return x.reshape(c, chunk, x.shape[1])

    # Padding rays: origin far outside the scene with tmax < tmin, so the
    # root expansion prunes every child and the lane retires immediately.
    chunks = Rays(
        o=padded(rays.o, 1.0e30),
        d=padded(rays.d, 1.0),
        tmin=padded(rays.tmin, 1.0),
        tmax=padded(rays.tmax, 0.0),
    )
    t, pid, conv = jax.lax.map(lambda r: _traverse(r, wb, any_hit_flag), chunks)
    return (
        t.reshape(-1)[:n],
        pid.reshape(-1)[:n],
        conv.reshape(-1)[:n],
    )


def closest_hit(rays: Rays, wb: WideBvh, chunk: int = CHUNK, with_conv=False):
    """(t, prim_id) closest hit; prim_id == -1 on miss. ``with_conv=True``
    adds the per-lane truncation flag (False = cut off by the iteration
    cap)."""
    t, pid, conv = _traverse_chunked(rays, wb, False, chunk)
    if with_conv:
        return t, pid, conv
    return t, pid


def any_hit(rays: Rays, wb: WideBvh, chunk: int = CHUNK, with_conv=False):
    """Occlusion query over [tmin, tmax]."""
    _, pid, conv = _traverse_chunked(rays, wb, True, chunk)
    if with_conv:
        return pid >= 0, conv
    return pid >= 0
