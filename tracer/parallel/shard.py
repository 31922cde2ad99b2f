"""Multi-device rendering: pixel-tile sharding over a ``jax.sharding.Mesh``.

The reference is single-GPU; its parallelism is the rasterizer over pixels
(SURVEY.md section 2.3). The scale-out maps that same data axis onto the
device mesh:

* pixels shard over the ``"rays"`` mesh axis in bands of whole image rows,
  each a whole number of the flat engine's 32-row super-tiles, so every
  device traces the super-tiles one device would. Each band is rendered
  under ``shard_map``: scene + accel buffers are replicated on every
  device, so the walk moves no data between devices;
* the progressive accumulator shards the same way, so accumulation is
  device-local (the all_gather happens only at image export);
* gradients of replicated scene parameters are each device's band
  gradient, ``psum``-reduced over the mesh.

The mesh is 1-D: the GPUs of a host reach each other all to all, so its
shape follows the algorithm alone. Multi-host: the same code runs under
``jax.distributed.initialize``, the "rays" axis spans every process's
devices, and each process feeds only its addressable shard.
"""

from __future__ import annotations

import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tracer.accel.flat import SUP_H
from tracer.diff.grad import render_mean
from tracer.render import integrator
from tracer.render.progressive import ProgressiveState
from tracer.render.scene import Scene, SceneConfig
from tracer.util import replace

RAY_AXIS = "rays"

COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "collective-permute",
    "all-to-all",
    "reduce-scatter",
)
_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "s64": 8, "s32": 4, "u64": 8, "u32": 4, "pred": 1,
}
_SHAPE = re.compile(r"\b([a-z]+[0-9]*)\[([0-9,]*)\]")


def make_ray_mesh(devices=None) -> Mesh:
    """1-D device mesh over which pixel tiles shard."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (RAY_AXIS,))


def band_rows(height: int, k: int) -> int:
    """Image rows per device: the fewest whole super-tile rows that cover
    ``height`` over ``k`` devices."""
    return -(-height // (SUP_H * k)) * SUP_H


def shard_rows(x, cfg: SceneConfig, mesh: Mesh):
    """Lay out a per-pixel (H*W, ...) array in the banded layout: pad with
    zero rows to ``k * band_rows * W`` and shard over the ray axis. The
    first H*W rows stay the image in row-major order."""
    k = mesh.devices.size
    n = cfg.width * cfg.height
    n_pad = k * band_rows(cfg.height, k) * cfg.width
    x = jnp.asarray(x)[:n]
    x = jnp.pad(x, ((0, n_pad - n),) + ((0, 0),) * (x.ndim - 1))
    # P(RAY_AXIS) names the leading axis only: the layout shard_map hands
    # back, so a step's output feeds the next call without a retrace.
    return jax.device_put(x, NamedSharding(mesh, P(RAY_AXIS)))


def shard_state(state: ProgressiveState, cfg: SceneConfig,
                mesh: Mesh) -> ProgressiveState:
    """Lay out the accumulator (and seed) in the banded layout."""
    # Commit the iteration counter replicated too: otherwise call 2 of the
    # step (iteration now a committed device array) retraces with a new
    # input layout.
    iteration = jax.device_put(state.iteration, NamedSharding(mesh, P()))
    return ProgressiveState(accum=shard_rows(state.accum, cfg, mesh),
                            iteration=iteration,
                            seed_t=shard_rows(state.seed_t, cfg, mesh))


def replicate_scene(scene: Scene, mesh: Mesh) -> Scene:
    """Replicate every scene buffer on all devices (the reference uploads a
    copy per GPU; here a single logical copy with replicated sharding)."""
    spec = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, spec), scene)


# Scene fields that hold traversal structures only.
ACCEL_FIELDS = ("bvh", "wide", "tb", "bsp")


def _zero_cotangent(x):
    """The zero gradient ``jax.grad(allow_int=True)`` gives a leaf."""
    if jnp.issubdtype(x.dtype, jnp.floating):
        return jnp.zeros_like(x)
    return np.zeros(x.shape, jax.dtypes.float0)


def _with_derived(scene: Scene, derived) -> Scene:
    """``scene`` with its derived data (the traversal structures and the
    (T, 20) attribute table) set to ``derived``."""
    accel, table = derived
    scene = replace(scene, **accel)
    if scene.geom is None:
        return scene
    return replace(scene, geom=replace(scene.geom, tri_table=table))


def _derived(scene: Scene):
    accel = {f: getattr(scene, f) for f in ACCEL_FIELDS}
    return accel, None if scene.geom is None else scene.geom.tri_table


def _band(cfg: SceneConfig, mesh: Mesh):
    """This device's (row0, rows) inside ``shard_map``."""
    rows = band_rows(cfg.height, mesh.devices.size)
    return jax.lax.axis_index(RAY_AXIS) * rows, rows


def sharded_step(mesh: Mesh, donate: bool = True):
    """Build the jitted sharded progressive step for ``mesh``: each device
    renders and accumulates its band of rows, with the same temporal
    seeding as ``progressive.step`` (state from ``shard_state``)."""

    @partial(
        jax.jit,
        static_argnames=("cfg",),
        **({"donate_argnames": ("state",)} if donate else {}),
    )
    def step(scene: Scene, cfg: SceneConfig, state: ProgressiveState):
        def band(scene, accum, seed_t, iteration):
            scene = replace(
                scene, uniforms=replace(scene.uniforms, iteration=iteration)
            )
            result, seed_t = integrator.render_sample_seeded(
                scene, cfg, seed_t, _band(cfg, mesh)
            )
            return integrator.accumulate(result, accum, iteration), seed_t

        rows = P(RAY_AXIS)
        accum, seed_t = jax.shard_map(
            band, mesh=mesh, in_specs=(P(), rows, rows, P()),
            out_specs=(rows, rows), check_vma=False,
        )(scene, state.accum, state.seed_t, state.iteration)
        return ProgressiveState(
            accum=accum, iteration=state.iteration + 1, seed_t=seed_t
        )

    return step


def sharded_grad(mesh: Mesh):
    """Build the jitted sharded form of ``tracer.diff.grad.grad_scene``:
    ``grad(scene, cfg, target, num_samples=1)`` with a replicated scene and
    the target laid out by ``shard_rows``. Each device differentiates the
    L2 loss of its band (rows past H masked out); the scene gradient is the
    ``psum`` of the band gradients."""

    @partial(jax.jit, static_argnames=("cfg", "num_samples"))
    def grad(scene: Scene, cfg: SceneConfig, target, num_samples: int = 1):
        count = jnp.float32(cfg.width * cfg.height * 3)

        def band(scene, target):
            row0, rows = _band(cfg, mesh)
            live = jnp.repeat(row0 + jnp.arange(rows) < cfg.height,
                              cfg.width)[:, None]
            derived = _derived(scene)

            def loss(s):
                img = render_mean(_with_derived(s, derived), cfg, num_samples,
                                  (row0, rows))
                return jnp.sum(jnp.where(live, (img - target) ** 2, 0.0)) / count

            rest = _with_derived(
                scene, (dict.fromkeys(ACCEL_FIELDS), None))
            g = jax.grad(loss, allow_int=True)(rest)
            g = jax.tree.map(
                lambda x: jax.lax.psum(x, RAY_AXIS)
                if jnp.issubdtype(x.dtype, jnp.floating) else x, g)
            # Derived data has a zero gradient by contract (traversal runs
            # under stop_gradient; the attribute table's cotangent goes to
            # vertices and normals): it is made on each device, not summed.
            return _with_derived(g, jax.tree.map(_zero_cotangent, derived))

        return jax.shard_map(
            band, mesh=mesh, in_specs=(P(), P(RAY_AXIS)),
            out_specs=P(), check_vma=False,
        )(scene, target)

    return grad


def collective_census(hlo_text: str) -> dict:
    """Count the inter-device collectives in compiled HLO text and sum
    their payload bytes (every shape of each result)."""
    counts = dict.fromkeys(COLLECTIVES, 0)
    total = 0
    for line in hlo_text.splitlines():
        for k in COLLECTIVES:
            m = re.search(rf"=(.*?)\b{k}(-start)?\(", line)
            if m:
                counts[k] += 1
                for dtype, dims in _SHAPE.findall(m.group(1)):
                    n = 1
                    for d in dims.split(","):
                        n *= int(d) if d else 1
                    total += n * _DTYPE_BYTES.get(dtype, 4)
                break
    counts["payload_bytes"] = total
    return counts


def gather_image(state: ProgressiveState, cfg: SceneConfig) -> np.ndarray:
    """Assemble the full image on host (the reference's surface present)."""
    n = cfg.width * cfg.height
    acc = np.asarray(state.accum)[:n]
    disp = integrator.to_display(jnp.asarray(acc), cfg)
    return np.asarray(disp).reshape(cfg.height, cfg.width, 3)


def render_progressive_sharded(
    scene: Scene,
    cfg: SceneConfig,
    num_samples: int,
    mesh: Mesh | None = None,
):
    """Multi-device progressive render; returns the sharded final state."""
    from tracer.render.progressive import init_state

    mesh = mesh if mesh is not None else make_ray_mesh()
    scene = replicate_scene(scene, mesh)
    state = shard_state(init_state(cfg), cfg, mesh)
    step = sharded_step(mesh)
    for _ in range(num_samples):
        state = step(scene, cfg, state)
    return state
