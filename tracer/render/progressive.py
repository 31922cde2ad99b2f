"""Progressive rendering state, checkpoint/resume, and the frame driver.

The reference's progressive state is the ping-pong Rgba32Float texture pair +
host iteration counter (``/root/reference/src/bindings/texture.rs:285-407``,
``uniform.rs:93-104``), never persisted. Here it is a single device-resident
``(accum, iteration)`` pytree that

* updates in place via buffer donation (no ping-pong copy — XLA aliases the
  accumulator), and
* checkpoints to disk so a preempted multi-host render resumes mid-image
  (SURVEY.md section 5.4's identified gap).
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tracer.render import integrator
from tracer.render.scene import Scene, SceneConfig
from tracer.util import pytree_dataclass, replace


@pytree_dataclass
class ProgressiveState:
    accum: jnp.ndarray  # (H*W, 3) f32 running mean (linear radiance)
    iteration: jnp.ndarray  # () u32
    # (H*W,) f32 last frame's primary mesh-hit distance (0 = no hint):
    # temporal t-bound seed for the flat engine's break bounds. Pure
    # accelerator state — the render is bit-identical with it zeroed
    # (exactness via the repair pass, tracer.accel.flat._run).
    seed_t: jnp.ndarray


def init_state(cfg: SceneConfig) -> ProgressiveState:
    n = cfg.height * cfg.width
    return ProgressiveState(
        accum=jnp.zeros((n, 3), jnp.float32),
        iteration=jnp.zeros((), jnp.uint32),
        seed_t=jnp.zeros((n,), jnp.float32),
    )


@partial(jax.jit, static_argnames=("cfg",), donate_argnames=("state",))
def step(scene: Scene, cfg: SceneConfig, state: ProgressiveState) -> ProgressiveState:
    """One progressive frame = one sample pass + accumulation.

    The accumulator is donated: XLA updates it in place, which is the
    analog of the reference's render-to-texture + copy ping-pong
    (``render_state.rs:541-555``) without the copy.
    """
    scene = replace(
        scene, uniforms=replace(scene.uniforms, iteration=state.iteration)
    )
    result, seed_t = integrator.render_sample_seeded(scene, cfg, state.seed_t)
    accum = integrator.accumulate(result, state.accum, state.iteration)
    return ProgressiveState(
        accum=accum, iteration=state.iteration + 1, seed_t=seed_t
    )


def render_progressive(
    scene: Scene,
    cfg: SceneConfig,
    num_samples: int,
    state: ProgressiveState | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
) -> ProgressiveState:
    """Drive ``num_samples`` progressive frames (the rendering_thread loop,
    ``src/lib.rs:321-363``, headless)."""
    if state is None:
        state = init_state(cfg)
    start = int(state.iteration)
    for i in range(start, num_samples):
        state = step(scene, cfg, state)
        if (
            checkpoint_path
            and checkpoint_every
            and (i + 1) % checkpoint_every == 0
        ):
            save_checkpoint(checkpoint_path, state, cfg)
    return state


def save_checkpoint(path: str, state: ProgressiveState, cfg: SceneConfig) -> None:
    """Persist (accum, iteration, scene name/shape) — resumable render."""
    tmp = path + ".tmp"
    np.savez(
        tmp if tmp.endswith(".npz") else tmp + ".npz",
        accum=np.asarray(state.accum),
        iteration=np.asarray(state.iteration),
        seed_t=np.asarray(state.seed_t),
        width=cfg.width,
        height=cfg.height,
        name=cfg.name,
    )
    src = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(src, path)


def load_checkpoint(path: str, cfg: SceneConfig) -> ProgressiveState:
    with np.load(path, allow_pickle=False) as z:
        assert int(z["width"]) == cfg.width and int(z["height"]) == cfg.height, (
            "checkpoint resolution mismatch"
        )
        n = cfg.height * cfg.width
        seed = (
            jnp.asarray(z["seed_t"]) if "seed_t" in z.files
            else jnp.zeros((n,), jnp.float32)  # checkpoints without a seed
        )
        return ProgressiveState(
            accum=jnp.asarray(z["accum"]),
            iteration=jnp.asarray(z["iteration"], jnp.uint32),
            seed_t=seed,
        )


def image(state: ProgressiveState, cfg: SceneConfig) -> np.ndarray:
    """Display-transformed (H, W, 3) image in [0, 1]."""
    disp = integrator.to_display(state.accum, cfg)
    return np.asarray(disp).reshape(cfg.height, cfg.width, 3)
