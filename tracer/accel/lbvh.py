"""LBVH builder — fully vectorized (no recursion), NumPy host path.

The reference builds a PBRT-4 HLBVH: parallel Morton codes, radix sort,
per-treelet recursive emit, sequential upper tree, preorder flatten
(``/root/reference/src/data_structures/hlbvh.rs:36-239``). Recursive emits do
not vectorize, so this builder replaces the treelet recursion with the
Karras 2012 parallel binary radix tree: every internal node's range/split is
computed independently with bit tricks over the sorted Morton keys — the
construction is a handful of O(n) vectorized passes, which is both the fast
shape for NumPy on host and the *only* reasonable shape for an on-device JAX
build (see ``lbvh_device``). Leaves holding up to ``max_prims`` primitives
are formed by collapsing maximal subtrees, mirroring the reference's
``max_prims=4`` default (``/root/reference/src/mesh.rs:233-239``).

Stage timing keeps the reference taxonomy (morton / sort / radix_tree /
collapse / bbox) so benchmarks compare stage-by-stage with
``journal/src/benchmark.md``.
"""

from __future__ import annotations

import numpy as np

from tracer.util import StageTimer, pytree_dataclass

MORTON_BITS = 10  # bits per axis; 30-bit codes like encode_morton_3
# (hlbvh.rs:489-503), scale 1024.


def expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of each u32 so there are 2 zero bits between
    consecutive bits (PBRT LeftShift3 / hlbvh.rs:489-497)."""
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """30-bit Morton code from per-axis coords already scaled to [0, 1024)."""
    xi = np.clip(x, 0, (1 << MORTON_BITS) - 1).astype(np.uint32)
    yi = np.clip(y, 0, (1 << MORTON_BITS) - 1).astype(np.uint32)
    zi = np.clip(z, 0, (1 << MORTON_BITS) - 1).astype(np.uint32)
    return (
        (expand_bits(xi) << np.uint32(2))
        | (expand_bits(yi) << np.uint32(1))
        | expand_bits(zi)
    )


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """Morton codes of primitive centroids normalized to the centroid bound
    (hlbvh.rs:42-68)."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    extent = np.maximum(hi - lo, 1e-30)
    scaled = (centroids - lo) / extent * (1 << MORTON_BITS)
    return morton3(scaled[:, 0], scaled[:, 1], scaled[:, 2])


@pytree_dataclass
class BvhBuffers:
    """Flattened BVH SoA for device traversal.

    Node 0 is the root. ``left``/``right`` index child nodes for internal
    nodes; a leaf has ``count > 0`` and covers ``prim_ids[first : first+count]``
    — the same information as the reference ``GpuNode {min, offset_ptr, max,
    n_prims}`` (hlbvh.rs:195-234) with explicit child links instead of the
    preorder +1 convention (gather-based traversal gets no locality win from
    preorder).
    """

    node_min: np.ndarray  # (M, 3) f32
    node_max: np.ndarray  # (M, 3) f32
    left: np.ndarray  # (M,) i32
    right: np.ndarray  # (M,) i32
    first: np.ndarray  # (M,) i32 — leaf range start into prim_ids
    count: np.ndarray  # (M,) i32 — 0 for internal nodes
    prim_ids: np.ndarray  # (T,) i32 — leaf-ordered primitive ids


def _common_prefix(keys: np.ndarray, i: np.ndarray, j: np.ndarray, n: int):
    """delta(i, j): length of the common bit prefix of keys i and j;
    -1 when j is out of range (Karras 2012)."""
    j_ok = (j >= 0) & (j < n)
    j_safe = np.clip(j, 0, n - 1)
    x = keys[i] ^ keys[j_safe]
    # 64-bit clz via float trick is unsafe; use bit_length via log2 on
    # nonzero, with x==0 meaning full 64-bit match.
    nz = x != 0
    # np.uint64 -> bit length: use 64 - (floor(log2(x)) + 1)
    with np.errstate(divide="ignore"):
        bl = np.zeros_like(x, dtype=np.int64)
        xh = (x >> np.uint64(32)).astype(np.uint32)
        xl = x.astype(np.uint64).astype(np.uint32)  # low 32
        hi_nz = xh != 0
        bl_hi = 32 + _bit_length_u32(xh)
        bl_lo = _bit_length_u32(xl)
        bl = np.where(hi_nz, bl_hi, bl_lo)
    clz = 64 - bl
    delta = np.where(nz, clz, 64)
    return np.where(j_ok, delta, -1)


def _bit_length_u32(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint32)
    out = np.zeros(v.shape, np.int64)
    cur = v.astype(np.uint64)
    for shift in (16, 8, 4, 2, 1):
        mask = cur >= (np.uint64(1) << np.uint64(shift))
        out = np.where(mask, out + shift, out)
        cur = np.where(mask, cur >> np.uint64(shift), cur)
    return out + (cur != 0)


def build_radix_tree(keys: np.ndarray):
    """Karras binary radix tree over sorted unique 64-bit keys.

    Returns (left, right, leaf_mask_child) where internal node i in
    [0, n-2] has children encoded as (index, is_leaf). Fully vectorized:
    the range search runs in O(log n) passes over all nodes at once.
    """
    n = keys.shape[0]
    if n == 1:
        z = np.zeros(0, np.int64)
        zb = np.zeros(0, bool)
        return z, z, zb, zb, z, z
    i = np.arange(n - 1, dtype=np.int64)
    d = np.sign(
        _common_prefix(keys, i, i + 1, n) - _common_prefix(keys, i, i - 1, n)
    ).astype(np.int64)
    delta_min = _common_prefix(keys, i, i - d, n)

    # Exponential search for the range length upper bound.
    lmax = np.full(n - 1, 2, np.int64)
    while True:
        probe = _common_prefix(keys, i, i + lmax * d, n) > delta_min
        if not probe.any():
            break
        lmax = np.where(probe, lmax * 2, lmax)
        if (lmax > 4 * n).all():
            break

    # Binary search for the exact range end.
    l = np.zeros(n - 1, np.int64)
    t = lmax // 2
    while (t >= 1).any():
        tt = np.maximum(t, 1)
        cond = (t >= 1) & (
            _common_prefix(keys, i, i + (l + tt) * d, n) > delta_min
        )
        l = np.where(cond, l + tt, l)
        t = t // 2
    j = i + l * d

    # Binary search for the split point.
    delta_node = _common_prefix(keys, i, j, n)
    s = np.zeros(n - 1, np.int64)
    t = -(-l // 2)  # ceil(l / 2)
    while True:
        tt = np.maximum(t, 1)
        cond = (t >= 1) & (
            _common_prefix(keys, i, i + (s + tt) * d, n) > delta_node
        )
        s = np.where(cond, s + tt, s)
        if (t <= 1).all():
            break
        t = -(-t // 2)
    gamma = i + s * d + np.minimum(d, 0)

    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    left = gamma
    right = gamma + 1
    left_is_leaf = lo == gamma
    right_is_leaf = hi == gamma + 1
    return left, right, left_is_leaf, right_is_leaf, lo, hi


def build(
    prim_lo: np.ndarray,
    prim_hi: np.ndarray,
    max_prims: int = 4,
    timer: StageTimer | None = None,
) -> BvhBuffers:
    """Build an LBVH over primitive AABBs; returns flattened SoA buffers."""
    timer = timer if timer is not None else StageTimer()
    T = prim_lo.shape[0]
    assert T >= 1
    centroids = 0.5 * (prim_lo + prim_hi)
    codes = morton_codes(centroids)
    timer.mark("morton")

    order = np.argsort(codes, kind="stable").astype(np.int64)
    timer.mark("sort")

    if T <= max_prims:
        # Root is a single leaf.
        node_min = prim_lo.min(axis=0, keepdims=True)
        node_max = prim_hi.max(axis=0, keepdims=True)
        return BvhBuffers(
            node_min=node_min.astype(np.float32),
            node_max=node_max.astype(np.float32),
            left=np.full(1, -1, np.int32),
            right=np.full(1, -1, np.int32),
            first=np.zeros(1, np.int32),
            count=np.full(1, T, np.int32),
            prim_ids=order.astype(np.int32),
        )

    # Unique 64-bit keys: morton in the high bits, index below (PBRT trick
    # for duplicate codes).
    keys = (codes[order].astype(np.uint64) << np.uint64(32)) | np.arange(
        T, dtype=np.uint64
    )
    left, right, left_leaf, right_leaf, lo, hi = build_radix_tree(keys)
    timer.mark("radix_tree")

    # --- Collapse maximal subtrees with <= max_prims primitives into leaves.
    # Internal node k covers sorted primitive range [lo[k], hi[k]].
    size = hi - lo + 1
    n_int = T - 1
    parent = np.full(n_int, -1, np.int64)
    pi = np.arange(n_int)
    parent_of_left = left[~left_leaf]
    parent[parent_of_left] = pi[~left_leaf]
    parent_of_right = right[~right_leaf]
    parent[parent_of_right] = pi[~right_leaf]

    small = size <= max_prims
    root_small = np.zeros(n_int, bool)
    has_parent = parent >= 0
    parent_small = np.zeros(n_int, bool)
    parent_small[has_parent] = small[parent[has_parent]]
    cut = small & ~parent_small  # maximal small subtree -> leaf
    keep = ~small  # effective internal nodes
    # Node 0 (root) is internal here because T > max_prims.

    # Re-index effective internal nodes, then leaves after them.
    new_id = np.full(n_int, -1, np.int64)
    n_keep = int(keep.sum())
    new_id[keep] = np.arange(n_keep)
    leaf_src = np.nonzero(cut)[0]  # internal nodes that became leaves
    n_cut_leaves = leaf_src.shape[0]

    # Child links of kept nodes. A child can be:
    #  - a kept internal node -> its new id
    #  - a cut internal node -> leaf id
    #  - a radix leaf (single primitive) -> also a leaf, range [g, g]
    leaf_lookup = np.full(n_int, -1, np.int64)
    leaf_lookup[leaf_src] = np.arange(n_cut_leaves)

    kept_idx = np.nonzero(keep)[0]
    kl, kr = left[kept_idx], right[kept_idx]
    kll, krl = left_leaf[kept_idx], right_leaf[kept_idx]

    # Single-primitive leaves referenced directly by kept parents.
    single_left = kl[kll]
    single_right = kr[krl]
    n_single = single_left.shape[0] + single_right.shape[0]

    M = n_keep + n_cut_leaves + n_single
    out_left = np.full(M, -1, np.int64)
    out_right = np.full(M, -1, np.int64)
    out_first = np.zeros(M, np.int64)
    out_count = np.zeros(M, np.int64)

    # Cut leaves: range [lo, hi] of the cut internal node.
    out_first[n_keep : n_keep + n_cut_leaves] = lo[leaf_src]
    out_count[n_keep : n_keep + n_cut_leaves] = size[leaf_src]

    # Single-prim leaves.
    base = n_keep + n_cut_leaves
    sl_ids = base + np.arange(single_left.shape[0])
    sr_ids = base + single_left.shape[0] + np.arange(single_right.shape[0])
    out_first[sl_ids] = single_left
    out_count[sl_ids] = 1
    out_first[sr_ids] = single_right
    out_count[sr_ids] = 1

    # Wire children of kept nodes.
    lchild = np.empty(n_keep, np.int64)
    rchild = np.empty(n_keep, np.int64)
    li = ~kll
    ci = kl[li]
    lchild[li] = np.where(keep[ci], new_id[ci], n_keep + leaf_lookup[ci])
    lchild[kll] = sl_ids
    ri = ~krl
    cj = kr[ri]
    rchild[ri] = np.where(keep[cj], new_id[cj], n_keep + leaf_lookup[cj])
    rchild[krl] = sr_ids
    out_left[:n_keep] = lchild
    out_right[:n_keep] = rchild
    timer.mark("collapse")

    # --- Bounding boxes.
    # Leaf bboxes: range-reduce over sorted primitive bounds.
    slo = prim_lo[order]
    shi = prim_hi[order]
    node_min = np.full((M, 3), np.float32(np.inf))
    node_max = np.full((M, 3), np.float32(-np.inf))
    leaf_mask = out_count > 0
    leaf_ids = np.nonzero(leaf_mask)[0]
    starts = out_first[leaf_ids]
    # reduceat needs sorted starts; leaves cover disjoint ranges. Sort by
    # start, reduce, then scatter back.
    ord_leaf = np.argsort(starts, kind="stable")
    sorted_starts = starts[ord_leaf]
    mins = np.minimum.reduceat(slo, sorted_starts, axis=0)
    maxs = np.maximum.reduceat(shi, sorted_starts, axis=0)
    # reduceat reduces to the *next* start (or end) — exactly the leaf range
    # because leaf ranges tile [0, T).
    node_min[leaf_ids[ord_leaf]] = mins
    node_max[leaf_ids[ord_leaf]] = maxs

    # Internal bboxes: fixed-point union-of-children sweeps (tree depth
    # bounded by 64 for 64-bit keys; typically ~2 log2 T).
    int_ids = np.nonzero(~leaf_mask)[0]
    il = out_left[int_ids]
    ir = out_right[int_ids]
    for _ in range(64):
        new_lo = np.minimum(node_min[il], node_min[ir])
        new_hi = np.maximum(node_max[il], node_max[ir])
        if np.array_equal(new_lo, node_min[int_ids]) and np.array_equal(
            new_hi, node_max[int_ids]
        ):
            break
        node_min[int_ids] = new_lo
        node_max[int_ids] = new_hi
    timer.mark("bbox")

    return BvhBuffers(
        node_min=node_min.astype(np.float32),
        node_max=node_max.astype(np.float32),
        left=out_left.astype(np.int32),
        right=out_right.astype(np.int32),
        first=out_first.astype(np.int32),
        count=out_count.astype(np.int32),
        prim_ids=order.astype(np.int32),
    )


def build_for_mesh(
    mesh,
    max_prims: int = 4,
    timer: StageTimer | None = None,
    prefer_native: bool = True,
):
    """LBVH over a ``MeshData``'s triangle AABBs.

    Uses the native C++ builder (tracer.accel.native) when available — the
    analog of the reference's native Rust builder — with this NumPy
    implementation as the always-available reference path.
    """
    lo, hi = mesh.bboxes()
    if prefer_native:
        try:
            from tracer.accel import native

            if native.available():
                return native.build(lo, hi, max_prims, timer=timer)
        except Exception:
            pass
    return build(lo, hi, max_prims=max_prims, timer=timer)


def validate(bvh: BvhBuffers, num_prims: int) -> None:
    """Builder invariants, mirroring the reference tests: every primitive id
    appears exactly once across leaves (``bsp_tree.rs:357-420`` analog for
    the BVH), leaf ranges tile [0, T), child links in range."""
    M = bvh.left.shape[0]
    leaf = bvh.count > 0
    covered = np.zeros(num_prims, np.int64)
    for i in np.nonzero(leaf)[0]:
        ids = bvh.prim_ids[bvh.first[i] : bvh.first[i] + bvh.count[i]]
        covered[ids] += 1
    assert (covered == 1).all(), "every primitive must be in exactly one leaf"
    internal = ~leaf
    assert (bvh.left[internal] >= 0).all() and (bvh.left[internal] < M).all()
    assert (bvh.right[internal] >= 0).all() and (bvh.right[internal] < M).all()
    # AABB containment: child boxes inside parent boxes.
    il = np.nonzero(internal)[0]
    for cid in (bvh.left[il], bvh.right[il]):
        assert (bvh.node_min[il] <= bvh.node_min[cid] + 1e-6).all()
        assert (bvh.node_max[il] >= bvh.node_max[cid] - 1e-6).all()
