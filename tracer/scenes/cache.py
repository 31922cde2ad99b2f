"""Disk cache for scene-build products (mesh + treelet accel).

The reference rebuilds its accel structures on every scene switch in ~50 ms
native Rust (``journal/src/benchmark.md:25-32``); this build's host half
(OBJ parse / procedural gen + LBVH + treelet cut) costs seconds of Python,
so warm scene loads memoize it on disk:

* mesh entries key on (path, scale, mtime) — or the generator version for
  procedural stand-ins — and store the raw SoA arrays + material table;
* treelet entries key on the mesh *content* fingerprint + build params and
  store the small ``TreeletHost`` product (~6 MB); the 94 MB block table is
  re-gathered on device in ~ms (``tracer.accel.treelet.assemble_blocks``).

Set ``TRACER_SCENE_CACHE`` to relocate, ``TRACER_NO_SCENE_CACHE=1`` to
disable (both halves fall back to a full rebuild).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np


def _cache_dir() -> str | None:
    if os.environ.get("TRACER_NO_SCENE_CACHE"):
        return None
    d = os.environ.get(
        "TRACER_SCENE_CACHE", os.path.expanduser("~/.cache/tracer-scenes")
    )
    try:
        os.makedirs(d, exist_ok=True)
        return d
    except OSError:
        return None


def _atomic_savez(path: str, **arrays) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def mesh_fingerprint(mesh) -> str:
    """Content hash of the geometry that determines accel structure."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(mesh.vertices).tobytes())
    h.update(np.ascontiguousarray(mesh.indices).tobytes())
    return h.hexdigest()


# --- Mesh cache -------------------------------------------------------------

_MESH_V = "m1"


def _mesh_key(path: str, scale: float) -> str:
    try:
        tag = f"{path}|{scale}|{os.stat(path).st_mtime_ns}|{_MESH_V}"
    except OSError:
        # Procedural stand-in for a missing file: key on the full path
        # (distinct missing paths must not collide) and the generator
        # version so regenerated stand-ins invalidate stale entries.
        from tracer.geometry.procedural import STANDIN_V

        tag = f"{path}|{scale}|proc{STANDIN_V}|{_MESH_V}"
    return hashlib.sha1(tag.encode()).hexdigest()


def load_mesh(path: str, scale: float):
    d = _cache_dir()
    if d is None:
        return None
    f = os.path.join(d, f"mesh-{_mesh_key(path, scale)}.npz")
    if not os.path.exists(f):
        return None
    from tracer.geometry.obj import MaterialData, MeshData

    try:
        with np.load(f, allow_pickle=False) as z:
            mats = [
                MaterialData(
                    diffuse=z["mat_diffuse"][i],
                    ambient=z["mat_ambient"][i],
                    specular=z["mat_specular"][i],
                    illum=int(z["mat_illum"][i]),
                    shininess=float(z["mat_shininess"][i]),
                    ior=float(z["mat_ior"][i]),
                )
                for i in range(z["mat_illum"].shape[0])
            ]
            return MeshData(
                vertices=z["vertices"],
                normals=z["normals"],
                indices=z["indices"],
                mat_ids=z["mat_ids"],
                materials=mats,
            )
    except Exception:
        return None


def save_mesh(path: str, scale: float, mesh) -> None:
    d = _cache_dir()
    if d is None:
        return
    f = os.path.join(d, f"mesh-{_mesh_key(path, scale)}.npz")
    mats = mesh.materials or []
    _atomic_savez(
        f,
        vertices=mesh.vertices,
        normals=mesh.normals,
        indices=mesh.indices,
        mat_ids=mesh.mat_ids,
        mat_diffuse=np.stack([m.diffuse for m in mats])
        if mats else np.zeros((0, 3), np.float32),
        mat_ambient=np.stack([m.ambient for m in mats])
        if mats else np.zeros((0, 3), np.float32),
        mat_specular=np.stack([m.specular for m in mats])
        if mats else np.zeros((0, 3), np.float32),
        mat_illum=np.asarray([m.illum for m in mats], np.int64),
        mat_shininess=np.asarray([m.shininess for m in mats], np.float32),
        mat_ior=np.asarray([m.ior for m in mats], np.float32),
    )


# --- Treelet cache ----------------------------------------------------------

_TB_V = "t1"


def load_treelet_host(fingerprint: str, max_prims: int, T: int):
    d = _cache_dir()
    if d is None:
        return None
    f = os.path.join(d, f"tb-{fingerprint}-{max_prims}-{T}-{_TB_V}.npz")
    if not os.path.exists(f):
        return None
    from tracer.accel.treelet import TreeletHost

    try:
        with np.load(f, allow_pickle=False) as z:
            return TreeletHost(
                top=z["top"],
                pids=z["pids"],
                counts=z["counts"],
                t_lo=z["t_lo"],
                t_hi=z["t_hi"],
                box_table=z["box_table"],
                depth=int(z["depth"]),
                T=int(z["T"]),
            )
    except Exception:
        return None


def save_treelet_host(fingerprint: str, max_prims: int, host) -> None:
    d = _cache_dir()
    if d is None:
        return
    f = os.path.join(d, f"tb-{fingerprint}-{max_prims}-{host.T}-{_TB_V}.npz")
    _atomic_savez(
        f,
        top=host.top,
        pids=host.pids,
        counts=host.counts,
        t_lo=host.t_lo,
        t_hi=host.t_hi,
        box_table=host.box_table,
        depth=np.int64(host.depth),
        T=np.int64(host.T),
    )
