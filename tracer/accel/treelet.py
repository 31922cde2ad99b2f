"""Treelet-cut BVH — the acceleration structure of the "bvh" traversal.

A per-ray BVH walk gathers one random node row per ray per step and keeps
a private stack per ray. This structure splits the tree at a *treelet
cut* so that most of that work becomes dense:

* **Top tree** (above the cut): an 8-ary collapse of the binary LBVH,
  small (tens of KB for an 870k-triangle mesh). The packet engine
  (``tracer.accel.packet``) walks it once per *tile of rays*, so node
  fetches are per-tile rows and the 8-wide slab tests are dense
  (8, TILE) array ops; the flat engine (``tracer.accel.flat``) skips it
  and culls the treelet boxes directly.
* **Treelet blocks** (below the cut): each treelet packs <= T triangles
  into one dense feature-major (16, T) f32 block — a whole ray tile is
  tested against a whole block (or a T/NQ quarter of it) as one dense
  (rays, triangles) Möller evaluation, with no per-ray gather.

The reference's analogous component is the flattened binary ``GpuNode`` BVH
walked per GPU thread with a private stack
(``/root/reference/src/data_structures/hlbvh.rs:195-234``,
``res/shaders/bvh.wgsl:154-191``).

Block layout is **feature-major** (16 feature rows, T triangles along the
last axis), so one feature of a run of triangles is contiguous:
  row 0:3   v0            row 9     prim id (exact float, ids < 2^24)
  row 3:6   e0 = v1 - v0  row 10    valid (1.0 / 0.0)
  row 6:9   e1 = v2 - v0  row 11:14 geometric normal n = cross(e0, e1)
                          row 14    k = dot(v0, n)   row 15 pad

Top-tree row layout (R, 8 children, 8 fields):
  [0:3] child AABB lo   [3:6] child AABB hi
  [6]   ref (i32 bitcast): >= 0 child row id; -1 empty; <= -2 treelet id
        encoded as -(tid + 2)
  [7]   pad
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from tracer.accel.lbvh import BvhBuffers
from tracer.accel.wide import _subtree_prims
from tracer.util import pytree_dataclass

_INF = np.float32(3.0e38)
BLOCK_COLS = 16


NQ = 4  # quarter-blocks per block: Möller gating granularity (T/NQ tris)


@pytree_dataclass(static=("depth", "T"))
class TreeletBvh:
    top: jnp.ndarray  # (R, 8, 8) f32
    blocks: jnp.ndarray  # (NT, 16, T) f32, feature-major
    t_lo: jnp.ndarray  # (NT, 3) f32 treelet root AABB lo (flat phase A)
    t_hi: jnp.ndarray  # (NT, 3) f32 treelet root AABB hi
    box_table: jnp.ndarray  # (NT, 8) f32 [lo3, hi3, pad2]
    qbox: jnp.ndarray  # (NT, NQ, 6) f32 quarter-block AABBs (Morton-local)
    qblocks: jnp.ndarray  # (NT*NQ, 16, T/NQ) f32 contiguous quarter view
    depth: int  # max top-tree descent depth (stack bound)
    T: int  # triangles per block


@dataclass(frozen=True)
class TreeletHost:
    """Host-side treelet build product: everything *except* the big
    (NT, 16, T) block table, which is assembled on device from ``pids``
    (``assemble_blocks``) — packing 870k triangles into feature-major
    blocks is one device gather, where host NumPy is slow. Also the unit
    that the scene disk cache persists (small: ~6 MB vs the 94 MB block
    table)."""

    top: np.ndarray  # (R, 8, 8) f32
    pids: np.ndarray  # (NT, T) i32 primitive id per block slot
    counts: np.ndarray  # (NT,) i32 valid slots per block
    t_lo: np.ndarray  # (NT, 3) f32
    t_hi: np.ndarray  # (NT, 3) f32
    box_table: np.ndarray  # (NT, 8) f32
    depth: int
    T: int


@jax.jit
def assemble_blocks(verts, idx, pids, valid):
    """Gather + edge/normal precompute for the (NT, 16, T) block table and
    the (NT, NQ, 6) quarter-block AABBs, on device (one fused gather per
    vertex slot)."""
    NT, T = pids.shape
    tri = idx[pids]  # (NT, T, 3)
    v = verts[tri]  # (NT, T, 3, 3)
    v0 = v[:, :, 0]
    e0 = v[:, :, 1] - v0
    e1 = v[:, :, 2] - v0
    nrm = jnp.cross(e0, e1)
    kpl = jnp.sum(v0 * nrm, axis=-1)
    pidf = jnp.where(valid, pids, -1).astype(jnp.float32)
    rows = [
        v0[..., 0], v0[..., 1], v0[..., 2],
        e0[..., 0], e0[..., 1], e0[..., 2],
        e1[..., 0], e1[..., 1], e1[..., 2],
        pidf,
        valid.astype(jnp.float32),
        nrm[..., 0], nrm[..., 1], nrm[..., 2],
        kpl,
        jnp.zeros_like(kpl),  # row 15: sublane padding
    ]
    blocks = jnp.stack(rows, axis=1)  # (NT, 16, T)
    # Contiguous quarter-block view (NT*NQ, 16, T/NQ): the hits kernel
    # loads one quarter-block's rows as contiguous runs.
    qblocks = (
        blocks.reshape(NT, 16, NQ, T // NQ)
        .transpose(0, 2, 1, 3)
        .reshape(NT * NQ, 16, T // NQ)
    )
    # Quarter AABBs: consecutive slots are Morton-adjacent, so each T/NQ
    # run is spatially local — the finer boxes gate the Möller work inside
    # an already-loaded block at no extra traffic.
    vq = v.reshape(NT, NQ, T // NQ, 3, 3)
    vmask = valid.reshape(NT, NQ, T // NQ, 1, 1)
    qlo = jnp.min(jnp.where(vmask, vq, jnp.float32(3e38)), axis=(2, 3))
    qhi = jnp.max(jnp.where(vmask, vq, jnp.float32(-3e38)), axis=(2, 3))
    # Empty quarters (partial blocks) collapse to a far point box, NOT the
    # +/-3e38 sentinels: those overflow the interval slab products to inf
    # and an inverted-infinite box *passes* the gate, spuriously gating
    # every sub-tile against every partial block.
    empty = ~jnp.any(valid.reshape(NT, NQ, T // NQ), axis=-1)  # (NT, NQ)
    far_pt = jnp.float32(1.0e30)
    qlo = jnp.where(empty[..., None], far_pt, qlo)
    qhi = jnp.where(empty[..., None], far_pt, qhi)
    return blocks, jnp.concatenate([qlo, qhi], axis=-1), qblocks


def from_host(
    host: TreeletHost, verts_dev: jnp.ndarray, idx_dev: jnp.ndarray,
    dev: list | None = None,
) -> TreeletBvh:
    """TreeletHost + device geometry -> TreeletBvh (blocks gathered on
    device). ``dev``: [pids, top, t_lo, t_hi, box_table, counts] already
    on device (they ride the packed geometry upload, one transfer instead
    of six — see ``device.pack_upload``)."""
    T = host.T
    if dev:
        pids, top, t_lo, t_hi, box_table, counts = dev
    else:
        pids = jnp.asarray(host.pids, jnp.int32)
        top = jnp.asarray(host.top)
        t_lo = jnp.asarray(host.t_lo, jnp.float32)
        t_hi = jnp.asarray(host.t_hi, jnp.float32)
        box_table = jnp.asarray(host.box_table, jnp.float32)
        counts = jnp.asarray(host.counts, jnp.int32)
    valid = (
        jnp.arange(T, dtype=jnp.int32)[None, :] < counts[:, None]
    )
    blocks, qbox, qblocks = assemble_blocks(
        jnp.asarray(verts_dev, jnp.float32), jnp.asarray(idx_dev, jnp.int32),
        pids, valid,
    )
    return TreeletBvh(
        top=top,
        blocks=blocks,
        t_lo=t_lo,
        t_hi=t_hi,
        box_table=box_table,
        qbox=qbox,
        qblocks=qblocks,
        depth=int(host.depth),
        T=T,
    )


def build(
    bvh: BvhBuffers,
    vertices: np.ndarray,
    indices: np.ndarray,
    T: int = 1024,
    verts_dev=None,
    idx_dev=None,
) -> TreeletBvh:
    """Cut the binary LBVH into <=T-triangle treelets and an 8-ary top tree.

    ``verts_dev``/``idx_dev``: already-uploaded geometry buffers to reuse
    for the device-side block assembly (avoids a second host->device copy).
    """
    host = build_host(bvh, T)
    return from_host(
        host,
        verts_dev if verts_dev is not None else np.asarray(vertices, np.float32),
        idx_dev if idx_dev is not None else np.asarray(indices, np.int32),
    )


def build_host(bvh: BvhBuffers, T: int = 1024) -> TreeletHost:
    """Host half of the treelet build: cut selection + top-tree collapse.

    Fully vectorized (the subtree ranges of a Karras radix tree are
    contiguous in sorted-primitive order, so every treelet is a slice of
    ``prim_ids``); the top-tree collapse is a small host loop over ~NT/7
    rows.
    """
    prim_ids = bvh.prim_ids.astype(np.int64)
    n = bvh.left.shape[0]
    count = bvh.count
    left = bvh.left.astype(np.int64)
    right = bvh.right.astype(np.int64)
    sub_first, sub_count = _subtree_prims(bvh)
    # A leaf with count > T would not be "small": the collapse below would
    # try to expand it through left/right == -1 and silently wrap-index the
    # last node (advisor finding). The LBVH always splits down to
    # max_prims <= 4 << T, so this is a build invariant, not a limitation.
    assert int(count.max(initial=0)) <= T, (
        f"LBVH leaf with {int(count.max())} prims exceeds treelet size {T}"
    )

    # --- Treelet cut: maximal subtrees with <= T primitives.
    internal = count == 0
    parent = np.full(n, -1, np.int64)
    ii = np.nonzero(internal)[0]
    parent[left[ii]] = ii
    parent[right[ii]] = ii
    small = sub_count <= T
    parent_small = np.zeros(n, bool)
    has_p = parent >= 0
    parent_small[has_p] = small[parent[has_p]]
    is_cut = small & ~parent_small
    cut_nodes = np.nonzero(is_cut)[0]
    order = np.argsort(sub_first[cut_nodes], kind="stable")
    cut_nodes = cut_nodes[order]  # DFS (sorted-prim) order
    NT = cut_nodes.shape[0]
    firsts = sub_first[cut_nodes].astype(np.int64)
    counts = sub_count[cut_nodes].astype(np.int64)
    tid_of = np.full(n, -1, np.int64)
    tid_of[cut_nodes] = np.arange(NT)

    # --- Block slot -> primitive id matrix (the only per-triangle work).
    slot = np.arange(T)
    mat = firsts[:, None] + slot[None, :]  # (NT, T) indices into prim_ids
    valid = slot[None, :] < counts[:, None]
    pids = np.where(valid, prim_ids[np.clip(mat, 0, prim_ids.shape[0] - 1)], 0)

    # --- Top tree: 8-ary collapse of everything above the cut.
    rows_box: list[np.ndarray] = []
    rows_ref: list[np.ndarray] = []
    max_depth = 1

    if is_cut[0]:
        # Whole mesh fits one treelet: a single row pointing at it.
        box = np.full((8, 6), 0.0, np.float32)
        box[:, 0:3] = _INF
        box[:, 3:6] = -_INF
        box[0, 0:3] = bvh.node_min[0]
        box[0, 3:6] = bvh.node_max[0]
        refs = np.full(8, -1, np.int32)
        refs[0] = -2
        rows_box.append(box)
        rows_ref.append(refs)
    else:
        pending: deque = deque()
        pending.append((0, 1))  # (binary node, depth); row id == pop order
        next_row = 1
        while pending:
            node, dep = pending.popleft()
            max_depth = max(max_depth, dep)
            slots = [int(node)]
            while len(slots) < 8:
                cand = [s for s in slots if not is_cut[s]]
                if not cand:
                    break
                s = max(cand, key=lambda x: sub_count[x])
                slots.remove(s)
                slots.extend((int(left[s]), int(right[s])))
            box = np.zeros((8, 6), np.float32)
            box[:, 0:3] = _INF
            box[:, 3:6] = -_INF
            refs = np.full(8, -1, np.int32)
            for ci, s in enumerate(slots):
                box[ci, 0:3] = bvh.node_min[s]
                box[ci, 3:6] = bvh.node_max[s]
                if is_cut[s]:
                    refs[ci] = np.int32(-2 - tid_of[s])
                else:
                    refs[ci] = next_row
                    pending.append((s, dep + 1))
                    next_row += 1
            rows_box.append(box)
            rows_ref.append(refs)

    R = len(rows_box)
    top = np.zeros((R, 8, 8), np.float32)
    top[:, :, 0:6] = np.stack(rows_box)
    top[:, :, 6] = np.stack(rows_ref).view(np.float32)
    box_table = np.zeros((NT, 8), np.float32)
    box_table[:, 0:3] = bvh.node_min[cut_nodes]
    box_table[:, 3:6] = bvh.node_max[cut_nodes]
    return TreeletHost(
        top=top,
        pids=pids.astype(np.int32),
        counts=counts.astype(np.int32),
        t_lo=np.asarray(bvh.node_min[cut_nodes], np.float32),
        t_hi=np.asarray(bvh.node_max[cut_nodes], np.float32),
        box_table=box_table,
        depth=int(max_depth),
        T=T,
    )


def validate(tb_top: np.ndarray, tb_blocks: np.ndarray, num_prims: int):
    """Builder invariants (reference test analog, ``bsp_tree.rs:357-420``):
    every primitive id appears exactly once across blocks; top refs and
    child boxes well-formed."""
    pid = tb_blocks[:, 9, :].astype(np.int64)
    valid = tb_blocks[:, 10, :] > 0.5
    covered = np.zeros(num_prims, np.int64)
    np.add.at(covered, pid[valid], 1)
    assert (covered == 1).all(), "every primitive in exactly one treelet"
    refs = tb_top[:, :, 6].view(np.int32)
    R = tb_top.shape[0]
    NT = tb_blocks.shape[0]
    inner = refs >= 0
    tre = refs <= -2
    assert (refs[inner] < R).all()
    assert ((-2 - refs[tre]) < NT).all()
    # Each row / treelet referenced at most once; all reachable from row 0.
    assert np.bincount(refs[inner], minlength=R)[1:].max(initial=0) <= 1
    assert np.bincount(-2 - refs[tre], minlength=NT).max() == 1
