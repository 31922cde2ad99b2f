"""Device-resident scene buffers (JAX pytrees, SoA, static shapes).

The reference uploads WGSL storage buffers per scene
(``/root/reference/src/bindings/storage_mesh.rs``); here every buffer is a
``jnp`` array inside a registered pytree so the whole scene streams through
``jax.jit`` as ordinary traced inputs — replicated (or sharded) across the
device mesh by ``jax.sharding`` without any bespoke upload layer.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from tracer.geometry.obj import MeshData
from tracer.util import pytree_dataclass

# Shader ids — exact parity with the reference's WGSL constants
# (e.g. /root/reference/res/shaders/w9e2.wgsl:7-15) and the UI enum
# (/root/reference/src/command.rs:39-47).
SHADER_LAMBERTIAN = 0
SHADER_PHONG = 1
SHADER_MIRROR = 2
SHADER_TRANSMIT = 3
SHADER_GLOSSY = 4
SHADER_NORMAL = 5
SHADER_BASECOLOR = 6
SHADER_TRANSPARENT = 7  # Fresnel-weighted reflect/refract (+Beer-Lambert)
SHADER_HOLDOUT = 8
SHADER_NO_RENDER = 255


@pytree_dataclass
class GeometryBuffers:
    """Triangle mesh SoA — the analog of the reference's split/combined
    vertex storage buffers (``storage_mesh.rs:76-301``)."""

    vertices: jnp.ndarray  # (V, 3) f32
    normals: jnp.ndarray  # (V, 3) f32
    indices: jnp.ndarray  # (T, 3) i32
    mat_ids: jnp.ndarray  # (T,) i32
    # Per-triangle attribute rows for the non-differentiable render path:
    # [0:3] v0 [3:6] v1 [6:9] v2 [9:12] n0 [12:15] n1 [15:18] n2
    # [18] mat id (exact f32) [19:20] pad. One row gather replaces seven
    # scattered per-vertex gathers.
    tri_table: jnp.ndarray  # (T, 20) f32


@pytree_dataclass
class MaterialTable:
    """Material SoA — ``Material`` structs (``/root/reference/src/mesh.rs:12-31``).

    ``emission`` is the MTL ``Ka`` channel (the reference shades emitters with
    ``material.ambient``), ``illum`` the raw illumination-model id whose value
    1 marks an area light.
    """

    diffuse: jnp.ndarray  # (M, 3) f32
    emission: jnp.ndarray  # (M, 3) f32
    specular: jnp.ndarray  # (M, 3) f32
    illum: jnp.ndarray  # (M,) i32
    shininess: jnp.ndarray  # (M,) f32
    ior: jnp.ndarray  # (M,) f32


@pytree_dataclass
class Spheres:
    """Analytic spheres with per-sphere shading setup (the reference hardcodes
    these per scene, e.g. ``w8e3.wgsl:293-305``)."""

    center: jnp.ndarray  # (S, 3) f32
    radius: jnp.ndarray  # (S,) f32
    shader: jnp.ndarray  # (S,) i32
    base_color: jnp.ndarray  # (S, 3) f32
    ior: jnp.ndarray  # (S,) f32 — ior1_over_ior2 assigned at hit
    extinction: jnp.ndarray  # (S, 3) f32 — Beer-Lambert rho_t


@pytree_dataclass
class Planes:
    """Analytic planes with an ONB for texturing (``w9e2.wgsl:383-404``)."""

    position: jnp.ndarray  # (P, 3) f32
    normal: jnp.ndarray  # (P, 3) f32
    tangent: jnp.ndarray  # (P, 3) f32
    binormal: jnp.ndarray  # (P, 3) f32
    shader: jnp.ndarray  # (P,) i32
    base_color: jnp.ndarray  # (P, 3) f32
    textured: jnp.ndarray  # (P,) i32 — sample the bound texture for albedo


@pytree_dataclass
class AnalyticTriangles:
    """Standalone triangles (worksheet-1 scenes, ``w1e6.wgsl:145-149``)."""

    verts: jnp.ndarray  # (R, 3, 3) f32
    shader: jnp.ndarray  # (R,) i32
    base_color: jnp.ndarray  # (R, 3) f32


def empty_spheres() -> Spheres:
    z3 = jnp.zeros((0, 3), jnp.float32)
    z1 = jnp.zeros((0,), jnp.float32)
    zi = jnp.zeros((0,), jnp.int32)
    return Spheres(z3, z1, zi, z3, z1, z3)


def empty_planes() -> Planes:
    z3 = jnp.zeros((0, 3), jnp.float32)
    zi = jnp.zeros((0,), jnp.int32)
    return Planes(z3, z3, z3, z3, zi, z3, zi)


def empty_triangles() -> AnalyticTriangles:
    return AnalyticTriangles(
        jnp.zeros((0, 3, 3), jnp.float32),
        jnp.zeros((0,), jnp.int32),
        jnp.zeros((0, 3), jnp.float32),
    )


TRI_COLS = 20  # (T, 20): 9 vertex + 9 normal + 1 mat id + 1 pad

@jax.custom_vjp
def fetch_tri_rows(vertices, normals, tri_table, idx, tri_c):
    """Differentiable per-hit attribute fetch: ONE row gather from the
    precomputed (T, 20) table forward, ONE stacked (V, 6) scatter-add
    backward.

    The naive differentiable formulation gathers each hit's three corners
    from (V, 3) vertex and normal tables (3N indices, six gathers). This
    custom VJP keeps the forward at one N-index row gather: the primal
    reads ``tri_table`` (derived from vertices/normals at upload), and the
    backward scatters the row cotangent directly into (V, 6) at
    ``idx[tri_c]``.

    Contract: ``tri_table`` must be consistent with vertices/normals
    (it is derived data; gradients flow to vertices/normals and the
    table's own cotangent is zero). Anything mutating vertices must
    rebuild the table — see ``upload_mesh``/``refresh_tri_table``.
    """
    del vertices, normals, idx
    return tri_table[tri_c]


def _fetch_fwd(vertices, normals, tri_table, idx, tri_c):
    rows = tri_table[tri_c]
    res = (idx[tri_c], vertices.shape[0], tri_table.shape,
           idx.shape, tri_c.shape)
    return rows, res


def _corner_cotangents(g):
    n = g.shape[0]
    gv = g[:, 0:9].reshape(n, 3, 3)
    gn = g[:, 9:18].reshape(n, 3, 3)
    return jnp.concatenate([gv, gn], axis=-1)  # (N, 3, 6)


def scatter_add_vn(idx_n, gvn, V, dtype):
    """(N, 3) corner ids + (N, 3, 6) cotangents -> (V, 6) sum.

    One scatter-add over the 3N corner rows. On the GPU it lowers to
    atomic adds, so sums over shared vertices are taken in no fixed
    order; under a sharded trace it partitions as a per-device scatter
    plus a psum."""
    flat_idx = idx_n.reshape(-1).astype(jnp.int32)  # (3N,)
    return jnp.zeros((V, 6), dtype).at[flat_idx].add(gvn.reshape(-1, 6))


def _fetch_bwd(res, g):
    import numpy as _np

    from jax import dtypes as _dtypes

    idx_n, V, table_shape, idx_shape, tric_shape = res
    gvn = _corner_cotangents(g)
    dvn = scatter_add_vn(idx_n, gvn, V, g.dtype)
    f0 = _dtypes.float0
    return (
        dvn[:, 0:3],
        dvn[:, 3:6],
        jnp.zeros(table_shape, g.dtype),  # derived data: no gradient
        _np.zeros(idx_shape, f0),
        _np.zeros(tric_shape, f0),
    )


fetch_tri_rows.defvjp(_fetch_fwd, _fetch_bwd)


def refresh_tri_table(geom: "GeometryBuffers") -> "GeometryBuffers":
    """Rebuild the derived (T, 20) attribute table after mutating
    vertices/normals (e.g. an optimization step or an FD probe). Same
    contract as the accel block tables: derived caches follow the
    canonical buffers; gradients flow to the canonical buffers only."""
    from tracer.util import replace as _replace

    return _replace(
        geom,
        tri_table=_tri_table(
            geom.vertices, geom.normals, geom.indices, geom.mat_ids
        ),
    )


@jax.jit
def _tri_table(verts, norms, idx, mat_ids):
    """Per-triangle attribute rows gathered on device (one fused row gather
    per vertex slot). Row layout: v0 v1 v2 (9), n0 n1 n2 (9), mat id (1),
    padding to TRI_COLS."""
    cols = [verts[idx[:, c]] for c in range(3)]
    cols += [norms[idx[:, c]] for c in range(3)]
    cols.append(mat_ids.astype(jnp.float32)[:, None])
    cols.append(jnp.zeros((idx.shape[0], TRI_COLS - 19), jnp.float32))
    return jnp.concatenate(cols, axis=1)


def pack_upload(parts_h: list) -> list:
    """Ship a list of host arrays (f32/i32, any shape) as ONE packed f32
    transfer, returning device arrays with original dtype/shape: one
    host-to-device copy and one jitted split instead of one transfer and
    one dispatch per array."""
    flats = []
    metas = []
    for a in parts_h:
        a = np.ascontiguousarray(a)
        if a.dtype == np.int32:
            flats.append(a.reshape(-1).view(np.float32))
        elif a.dtype == np.float32:
            flats.append(a.reshape(-1))
        else:
            raise TypeError(f"pack_upload: unsupported dtype {a.dtype}")
        metas.append((a.dtype, a.shape))
    packed = jnp.asarray(np.concatenate(flats) if flats else np.zeros(0, np.float32))
    offs = np.concatenate([[0], np.cumsum([f.size for f in flats])]).tolist()

    # One jitted split: eager per-piece slicing would dispatch one
    # compiled program per piece.
    def _split(p):
        out = []
        for i, (dt, shape) in enumerate(metas):
            piece = jax.lax.slice(p, (offs[i],), (offs[i + 1],))
            if dt == np.int32:
                piece = jax.lax.bitcast_convert_type(piece, jnp.int32)
            out.append(piece.reshape(shape))
        return tuple(out)

    return list(jax.jit(_split)(packed))


def upload_mesh(
    mesh: MeshData, extra: Optional[list] = None
) -> tuple[GeometryBuffers, MaterialTable, jnp.ndarray, list]:
    """MeshData -> (geometry, materials, light_indices, extra_dev) buffers.

    Unlike wgpu, zero-length buffers are legal, so the reference's
    ``u32::MAX`` sentinel prepend (``storage_mesh.rs:330-332``) is dropped;
    the light list holds exactly the emissive-triangle ids.

    Everything ships as one ``pack_upload`` transfer; ``extra`` host
    arrays (e.g. the treelet-cut product) ride the same transfer.
    """
    # Cast on host before upload: shipping int64 intermediates doubles
    # the index-buffer transfer.
    mat32 = np.where(mesh.mat_ids == 0xFFFFFFFF, 0, mesh.mat_ids).astype(
        np.int32
    )
    mats = mesh.materials
    parts = [
        np.asarray(mesh.vertices, np.float32),
        np.asarray(mesh.normals, np.float32),
        mesh.indices.astype(np.int32),
        mat32,
        np.stack([m.diffuse for m in mats]).astype(np.float32),
        np.stack([m.ambient for m in mats]).astype(np.float32),
        np.stack([m.specular for m in mats]).astype(np.float32),
        np.asarray([m.illum for m in mats], np.int32),
        np.asarray([m.shininess for m in mats], np.float32),
        np.asarray([m.ior for m in mats], np.float32),
        mesh.light_indices().astype(np.int32),
    ] + list(extra or [])
    dev = pack_upload(parts)
    (verts_d, norms_d, idx_d, mat_d, diff_d, emis_d, spec_d, illum_d,
     shin_d, ior_d, lights) = dev[:11]
    extra_d = dev[11:]
    geom = GeometryBuffers(
        vertices=verts_d,
        normals=norms_d,
        indices=idx_d,
        mat_ids=mat_d,
        # Assembled on device: the (T, 20) table is 70 MB for dragon-sized
        # meshes, gathered from the 10 MB vertex/index buffers instead of
        # built on the host and shipped.
        tri_table=_tri_table(verts_d, norms_d, idx_d, mat_d),
    )
    table = MaterialTable(
        diffuse=diff_d,
        emission=emis_d,
        specular=spec_d,
        illum=illum_d,
        shininess=shin_d,
        ior=ior_d,
    )
    return geom, table, lights, extra_d
