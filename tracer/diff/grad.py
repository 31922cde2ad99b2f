"""Differentiable rendering: losses, parameter gradients, FD checks.

The whole forward light transport (``tracer.render.integrator``) is built to
be differentiable end-to-end: traversal emits integer primitive ids under
``stop_gradient`` and every hit attribute is re-derived from the ids, so
reverse-mode AD gives pixel gradients wrt

* mesh vertex positions (through the Möller re-derivation + normals),
* material albedo / emission (through shading + NEE),
* light triangles (through the area-light sampler),
* analytic primitive parameters (centers, radii, plane frames),
* camera parameters (through ray generation).

Discrete events (RR decisions, Fresnel branch picks, light index draws, BVH
topology) are treated as fixed by the sample — the standard detached-sampling
estimator: unbiased for interior-smooth parameters, biased at visibility
silhouettes (SURVEY.md section 7 step 6's stated gate).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tracer.render import integrator
from tracer.render.scene import Scene, SceneConfig
from tracer.util import replace


def _diffable(cfg: SceneConfig) -> SceneConfig:
    """Reverse-mode AD needs the scan bounce driver (while_loop is
    forward-only in JAX)."""
    if cfg.loop == "scan":
        return cfg
    import dataclasses

    return dataclasses.replace(cfg, loop="scan")


def render_radiance(scene: Scene, cfg: SceneConfig, iteration=0, band=None):
    """(N, 3) linear radiance for one sample pass at ``iteration`` (over the
    rows ``band`` selects, as in ``integrator.render_sample``)."""
    cfg = _diffable(cfg)
    scene = replace(
        scene,
        uniforms=replace(
            scene.uniforms, iteration=jnp.asarray(iteration, jnp.uint32)
        ),
    )
    return integrator.render_sample(scene, cfg, band)


def render_mean(scene: Scene, cfg: SceneConfig, num_samples: int = 1,
                band=None):
    """Mean radiance over ``num_samples`` progressive passes (all
    differentiable; more samples = lower-variance gradients)."""
    acc = 0.0
    for it in range(num_samples):
        acc = acc + render_radiance(scene, cfg, it, band)
    return acc / jnp.float32(num_samples)


def l2_loss(scene: Scene, cfg: SceneConfig, target, num_samples: int = 1):
    img = render_mean(scene, cfg, num_samples)
    return jnp.mean((img - target) ** 2)


@partial(jax.jit, static_argnames=("cfg", "num_samples"))
def grad_scene(scene: Scene, cfg: SceneConfig, target, num_samples: int = 1):
    """Full Scene-pytree gradient of the L2 loss (float leaves only).

    One device; ``tracer.parallel.shard.sharded_grad`` is the same gradient
    with the rays split over a device mesh."""

    def loss_fn(s):
        return l2_loss(s, cfg, target, num_samples)

    return jax.grad(loss_fn, allow_int=True)(scene)


def directional_derivative_ad(scene, cfg, target, get, set_, direction,
                              num_samples: int = 1):
    """AD directional derivative of the loss along ``direction`` applied to
    the leaf addressed by get/set_ closures."""

    def loss_of(theta):
        leaf = get(scene) + theta * direction
        return l2_loss(set_(scene, leaf), cfg, target, num_samples)

    return jax.grad(loss_of)(jnp.float32(0.0))


def directional_derivative_fd(scene, cfg, target, get, set_, direction,
                              eps: float = 1e-3, num_samples: int = 1):
    """Central finite-difference along the same direction (same RNG stream
    on both sides, so the stochastic estimate differences cancel)."""

    def loss_of(theta):
        leaf = get(scene) + theta * direction
        return float(l2_loss(set_(scene, leaf), cfg, target, num_samples))

    return (loss_of(eps) - loss_of(-eps)) / (2.0 * eps)


def fd_check(scene, cfg, target, get, set_, direction, eps=1e-3,
             num_samples: int = 1, rtol=0.08, atol=1e-7):
    """Assert the AD and FD directional derivatives agree; returns both."""
    ad = float(
        directional_derivative_ad(
            scene, cfg, target, get, set_, direction, num_samples
        )
    )
    fd = directional_derivative_fd(
        scene, cfg, target, get, set_, direction, eps, num_samples
    )
    denom = max(abs(ad), abs(fd), atol)
    assert abs(ad - fd) / denom <= rtol or abs(ad - fd) <= atol, (
        f"gradient check failed: ad={ad:.6g} fd={fd:.6g}"
    )
    return ad, fd
