"""Wavefront OBJ/MTL loader with the reference's exact semantics.

Reproduces the behavior of ``Mesh::load`` + tobj with
``single_index + triangulate`` (``/root/reference/src/mesh.rs:78-202``):

* one index stream — a vertex is the (position, normal, texcoord) triple; each
  distinct ``v/vt/vn`` combination becomes one output vertex;
* polygon faces fan-triangulated;
* per-triangle material id carried alongside the 3 vertex indices (the ``w``
  lane of the reference's ``vec4u`` index — ``mesh.rs:39,184``);
* material fields: ``Kd`` -> diffuse (default 1,1,1), ``Ka`` -> ambient
  (doubles as radiance for emitters, default 0), ``Ks`` -> specular
  (default 0), and — faithfully to the reference — ``emissive`` is the
  **illum model number** (``mesh.rs:114-119``); a triangle is a light source
  iff its material has ``illum == 1``
  (``/root/reference/src/bindings/storage_mesh.rs:316-332``);
* meshes with a normal count mismatching the position count get all-zero
  normals (``mesh.rs:159-166``);
* multiple ``o``/``g`` models are concatenated with index offsetting
  (``mesh.rs:171-184``).

Pure-NumPy host code: mesh parsing is I/O-bound setup, not a device hot path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class MaterialData:
    """Host-side mirror of the reference ``Material`` (``mesh.rs:12-31``)."""

    diffuse: np.ndarray  # (3,) f32, MTL Kd
    ambient: np.ndarray  # (3,) f32, MTL Ka (emitted radiance for lights)
    specular: np.ndarray  # (3,) f32, MTL Ks
    illum: int = 0  # MTL illum model; the reference stores it as `emissive`
    shininess: float = 0.0  # MTL Ns (reference drops it; kept for Phong)
    ior: float = 1.5  # MTL Ni
    name: str = ""

    @staticmethod
    def default() -> "MaterialData":
        return MaterialData(
            diffuse=np.array([0.5, 0.5, 0.5], np.float32),
            ambient=np.zeros(3, np.float32),
            specular=np.zeros(3, np.float32),
            illum=0,
        )


@dataclass
class MeshData:
    """Host-side triangle mesh in flat arrays (SoA), pre-upload."""

    vertices: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (V, 3) f32 (zeros when the OBJ has no normals)
    indices: np.ndarray  # (T, 3) u32
    mat_ids: np.ndarray  # (T,) u32  (u32::MAX -> no material, like mesh.rs:186)
    materials: list[MaterialData] = field(default_factory=list)

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    def scale(self, factor: float) -> "MeshData":
        """Uniform vertex scale — ``Mesh::scale`` (``mesh.rs:246-252``)."""
        return MeshData(
            vertices=self.vertices * np.float32(factor),
            normals=self.normals,
            indices=self.indices,
            mat_ids=self.mat_ids,
            materials=self.materials,
        )

    def light_indices(self) -> np.ndarray:
        """Triangle ids whose material has illum == 1 — the reference's
        emissive-triangle list (``storage_mesh.rs:316-332``), *without* the
        wgpu empty-buffer sentinel."""
        if not self.materials:
            return np.zeros(0, np.uint32)
        illum = np.array(
            [m.illum for m in self.materials] + [0], np.int64
        )  # +sentinel slot for invalid ids
        mid = np.minimum(self.mat_ids.astype(np.int64), len(self.materials))
        return np.nonzero(illum[mid] == 1)[0].astype(np.uint32)

    def triangle_vertices(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        v = self.vertices
        i = self.indices.astype(np.int64)
        return v[i[:, 0]], v[i[:, 1]], v[i[:, 2]]

    def bboxes(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-triangle AABBs, shape ((T,3) lo, (T,3) hi) —
        ``Mesh::bboxes`` (``mesh.rs:212-227``)."""
        a, b, c = self.triangle_vertices()
        lo = np.minimum(np.minimum(a, b), c)
        hi = np.maximum(np.maximum(a, b), c)
        return lo, hi


def _parse_floats(parts: list[str], n: int) -> list[float]:
    vals = [float(p) for p in parts[:n]]
    while len(vals) < n:
        vals.append(0.0)
    return vals


def load_mtl(path: str) -> dict[str, MaterialData]:
    """Parse an MTL file into named materials."""
    materials: dict[str, MaterialData] = {}
    cur: MaterialData | None = None
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl":
                name = parts[1] if len(parts) > 1 else ""
                cur = MaterialData(
                    diffuse=np.array([1.0, 1.0, 1.0], np.float32),
                    ambient=np.zeros(3, np.float32),
                    specular=np.zeros(3, np.float32),
                    illum=0,
                    name=name,
                )
                materials[name] = cur
            elif cur is None:
                continue
            elif key == "Kd":
                cur.diffuse = np.array(_parse_floats(parts[1:], 3), np.float32)
            elif key == "Ka":
                cur.ambient = np.array(_parse_floats(parts[1:], 3), np.float32)
            elif key == "Ks":
                cur.specular = np.array(_parse_floats(parts[1:], 3), np.float32)
            elif key == "illum":
                cur.illum = int(float(parts[1]))
            elif key == "Ns":
                cur.shininess = float(parts[1])
            elif key == "Ni":
                cur.ior = float(parts[1])
    return materials


def load_obj(path: str) -> MeshData:
    """Load an OBJ (+ its MTL) into flat single-index arrays.

    Behavioral parity target: tobj ``single_index=true, triangulate=true``
    as consumed by ``Mesh::load`` (``mesh.rs:94-202``). Note tobj's
    single-index mode produces one vertex per unique ``v/vt/vn`` face corner,
    in first-use order; positions referenced with different normals are
    duplicated. We reproduce that so acceleration structures and light lists
    index identically.
    """
    positions: list[list[float]] = []
    normals_in: list[list[float]] = []
    # texcoords parsed for completeness of the vertex key (UV support)
    texcoords: list[list[float]] = []

    mtl: dict[str, MaterialData] = {}
    mat_order: list[str] = []

    # Per-model accumulation (models concatenated with index offsets).
    out_vertices: list[list[float]] = []
    out_normals: list[list[float]] = []
    out_uvs: list[list[float]] = []
    out_indices: list[tuple[int, int, int]] = []
    out_matids: list[int] = []

    corner_cache: dict[tuple[int, int, int], int] = {}
    cur_material = -1

    def model_break():
        # A new `o`/`g` statement starts a new tobj model: the vertex
        # dedup cache resets (indices keep growing — offsetting is implicit
        # because out_vertices is shared and the cache is cleared).
        corner_cache.clear()

    def corner_index(spec: str) -> int:
        toks = spec.split("/")
        vi = int(toks[0])
        ti = int(toks[1]) if len(toks) > 1 and toks[1] else 0
        ni = int(toks[2]) if len(toks) > 2 and toks[2] else 0
        # OBJ is 1-based; negatives are relative.
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ti - 1 if ti > 0 else (len(texcoords) + ti if ti < 0 else -1)
        ni = ni - 1 if ni > 0 else (len(normals_in) + ni if ni < 0 else -1)
        key = (vi, ti, ni)
        idx = corner_cache.get(key)
        if idx is None:
            idx = len(out_vertices)
            corner_cache[key] = idx
            out_vertices.append(positions[vi])
            out_normals.append(normals_in[ni] if ni >= 0 else None)  # type: ignore[arg-type]
            out_uvs.append(texcoords[ti] if ti >= 0 else [0.0, 0.0])
        return idx

    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "v":
                positions.append(_parse_floats(parts[1:], 3))
            elif key == "vn":
                normals_in.append(_parse_floats(parts[1:], 3))
            elif key == "vt":
                texcoords.append(_parse_floats(parts[1:], 2))
            elif key == "f":
                corners = [corner_index(p) for p in parts[1:]]
                for k in range(1, len(corners) - 1):  # fan triangulation
                    out_indices.append((corners[0], corners[k], corners[k + 1]))
                    out_matids.append(cur_material)
            elif key == "usemtl":
                name = parts[1] if len(parts) > 1 else ""
                if name in mtl:
                    cur_material = mat_order.index(name)
                else:
                    cur_material = -1
            elif key == "mtllib":
                mtl_path = os.path.join(base_dir, " ".join(parts[1:]))
                if os.path.exists(mtl_path):
                    loaded = load_mtl(mtl_path)
                    for name, m in loaded.items():
                        if name not in mtl:
                            mat_order.append(name)
                        mtl[name] = m
            elif key in ("o", "g"):
                model_break()

    num_v = len(out_vertices)
    vertices = np.asarray(out_vertices, np.float32).reshape(num_v, 3)
    # tobj semantics: if the model's normal stream doesn't cover every vertex,
    # the reference zero-fills ALL normals for that model (mesh.rs:159-166).
    # With a shared vertex pool we apply the rule per-vertex: missing -> zero.
    have_all = all(n is not None for n in out_normals)
    if num_v and have_all:
        normals = np.asarray(out_normals, np.float32).reshape(num_v, 3)
    else:
        normals = np.zeros((num_v, 3), np.float32)
        if num_v:
            for i, n in enumerate(out_normals):
                if n is not None:
                    normals[i] = n

    indices = np.asarray(out_indices, np.uint32).reshape(-1, 3)
    mat_ids = np.asarray(
        [m if m >= 0 else 0xFFFFFFFF for m in out_matids], np.uint32
    )

    materials = [mtl[name] for name in mat_order]
    if not materials:
        materials = [MaterialData.default()]
        # unreferenced ids stay MAX like the reference (mesh.rs:186)

    return MeshData(
        vertices=vertices,
        normals=normals,
        indices=indices,
        mat_ids=mat_ids,
        materials=materials,
    )
