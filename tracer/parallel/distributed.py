"""Multi-process runtime bring-up (SURVEY section 5.8).

The reference is single-process/single-GPU; the scale-out path here is
``jax.distributed`` + a global device mesh. This module is the entry point
the CLI and benches call before any jax computation when running as one
process of several:

* the standard env triplet (``JAX_COORDINATOR_ADDRESS``,
  ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) is passed to
  ``jax.distributed.initialize``; nothing is discovered automatically;
* single-process runs (the common case, incl. tests and one host driving
  all of its GPUs) are a no-op.

After initialization, ``tracer.parallel.shard.make_ray_mesh`` over
``jax.devices()`` spans all processes: the "rays" axis crosses hosts,
scene buffers replicate per device, and each process feeds/reads only its
addressable shard (``shard.gather_image`` assembles via an all-gather when
needed).
"""

from __future__ import annotations

import os

import jax

_initialized = False


def initialize_from_env(force: bool = False) -> bool:
    """Bring up jax.distributed if the environment asks for it.

    Returns True when a multi-process runtime was initialized. Safe to call
    more than once and in single-process runs.
    """
    global _initialized
    if _initialized:
        return True
    num = os.environ.get("JAX_NUM_PROCESSES")
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not force and not num and not coord:
        return False  # single-process run
    kwargs = {}
    if coord:
        kwargs["coordinator_address"] = coord
    if num:
        kwargs["num_processes"] = int(num)
        kwargs["process_id"] = int(os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(**kwargs)
    _initialized = True
    return True


def process_info() -> tuple[int, int]:
    """(process_index, process_count) for shard bookkeeping/logging."""
    return jax.process_index(), jax.process_count()
