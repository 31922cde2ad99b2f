"""Small shared utilities: pytree dataclasses and timers."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import jax


def pytree_dataclass(cls=None, *, static: tuple[str, ...] = ()):
    """Register a dataclass as a JAX pytree.

    Fields named in ``static`` become aux (hashable, trigger recompiles on
    change); everything else is traced array data. Fields may be ``None``
    (treated as an empty subtree by JAX).
    """

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        data_fields = [
            f.name for f in dataclasses.fields(c) if f.name not in static
        ]
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=list(static)
        )
        return c

    return wrap if cls is None else wrap(cls)


def replace(obj, **kwargs):
    """dataclasses.replace that works on frozen pytree dataclasses."""
    return dataclasses.replace(obj, **kwargs)


class StageTimer:
    """Per-stage wall timer mirroring the reference's build profilers
    (``BvhConstructionTime``, ``/root/reference/src/data_structures/bvh_util.rs:4-57``)."""

    def __init__(self) -> None:
        self.stages: dict[str, float] = {}
        self._t0 = time.perf_counter()

    def mark(self, name: str) -> None:
        t = time.perf_counter()
        self.stages[name] = self.stages.get(name, 0.0) + (t - self._t0)
        self._t0 = t

    @property
    def total(self) -> float:
        return sum(self.stages.values())

    def display(self) -> str:
        lines = [f"  {k}: {v * 1e3:.3f} ms" for k, v in self.stages.items()]
        lines.append(f"  total: {self.total * 1e3:.3f} ms")
        return "\n".join(lines)

    def merged(self, other: "StageTimer") -> "StageTimer":
        out = StageTimer()
        out.stages = dict(self.stages)
        for k, v in other.stages.items():
            out.stages[k] = out.stages.get(k, 0.0) + v
        return out


def timed(fn: Callable[..., Any], *args, **kwargs) -> tuple[Any, float]:
    """Run ``fn``, blocking on JAX outputs, and return (result, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    out = jax.block_until_ready(out)
    return out, time.perf_counter() - t0


class BackendError(RuntimeError):
    """Raised by :func:`self_test` when no usable accelerator backend is
    present (the reference's adapter-probe panic,
    ``/root/reference/src/gpu_handles.rs:72-92``, as a typed error)."""


def self_test(verbose: bool = False) -> str:
    """Probe the JAX backend: device present, platform named, one tiny
    jitted op executed. Returns a one-line device description; raises
    :class:`BackendError` with an actionable message otherwise.

    The analog of ``GPUHandles::self_test`` + the startup panic in the
    reference (``src/gpu_handles.rs:72-92``, ``src/lib.rs:244-246``):
    a missing accelerator backend should surface as one clear sentence,
    not a raw runtime traceback from the middle of the first render.
    """
    import sys

    import jax
    import jax.numpy as jnp

    try:
        devs = jax.devices()
    except Exception as e:  # no backend initialised at all
        raise BackendError(
            "tracer: no JAX backend available "
            f"({type(e).__name__}: {e}). For GPU runs make sure JAX's CUDA "
            "plugin is installed; for CPU runs set JAX_PLATFORMS=cpu."
        ) from e
    if not devs:
        raise BackendError("tracer: jax.devices() returned no devices.")
    d = devs[0]
    desc = (
        f"{d.platform} x{len(devs)} ({getattr(d, 'device_kind', 'unknown')})"
    )
    try:
        out = jax.jit(lambda x: x * 2.0 + 1.0)(jnp.float32(1.5))
        assert float(out) == 4.0
    except Exception as e:
        raise BackendError(
            f"tracer: backend '{desc}' failed the smoke jit "
            f"({type(e).__name__}: {e}) — the device is visible but not "
            "usable."
        ) from e
    if verbose:
        print(f"tracer: backend OK: {desc}", file=sys.stderr)
    return desc
