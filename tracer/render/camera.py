"""Pinhole camera and primary-ray generation.

The reference camera is a look-at pinhole with a focal "constant"
(``/root/reference/src/camera.rs:13-34``); rays are built in the fragment
shader from the quad UV (``get_camera_ray``,
``/root/reference/res/shaders/w9e2.wgsl:224-241``):

    v = normalize(look_at - eye); b1 = normalize(cross(v, up)); b2 = cross(b1, v)
    q = normalize(b1 * (u + jx) * aspect + b2 * (v_uv + jy) + v * d)

Here the whole W x H grid is generated at once as a batched jnp op.
"""

from __future__ import annotations

import jax.numpy as jnp

from tracer.math import vec
from tracer.util import pytree_dataclass
from tracer.kernels.intersect import Rays, make_rays


@pytree_dataclass
class Camera:
    """Look-at pinhole camera (all fields traced f32 arrays/scalars)."""

    eye: jnp.ndarray  # (3,)
    target: jnp.ndarray  # (3,)
    up: jnp.ndarray  # (3,)
    constant: jnp.ndarray  # () focal distance
    aspect: jnp.ndarray  # () width/height of the *uv* frustum


def make_camera(eye, target, up=(0.0, 1.0, 0.0), constant=1.0, aspect=1.0) -> Camera:
    f32 = jnp.float32
    return Camera(
        eye=jnp.asarray(eye, f32),
        target=jnp.asarray(target, f32),
        up=jnp.asarray(up, f32),
        constant=jnp.asarray(constant, f32),
        aspect=jnp.asarray(aspect, f32),
    )


def pixel_uv(width: int, height: int, row0=0, rows: int | None = None):
    """Per-pixel quad coords uv in [-1/2, 1/2), matching the rasterized
    full-screen quad: ``coords`` is NDC in [-1, 1] scaled by 0.5
    (``w9e2.wgsl:251-253``), with y up and pixel centers at half-texel.

    Returns (u, v) each shaped (H*W,), row-major with row 0 at the top (same
    as ``clip_position.y`` indexing for launch_idx, ``w9e2.wgsl:255-258``).
    ``row0``/``rows`` select the band of ``rows`` image rows from ``row0``
    (which may be traced); rows past ``height`` continue the same grid.
    """
    rows = height if rows is None else rows
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width  # [0,1)
    iy = row0 + jnp.arange(rows, dtype=jnp.int32)
    ys = (iy.astype(jnp.float32) + 0.5) / height
    u = xs - 0.5
    v = 0.5 - ys  # screen row 0 is top => +v up
    uu, vv = jnp.meshgrid(u, v, indexing="xy")  # (H, W)
    return uu.reshape(-1), vv.reshape(-1)


def camera_rays(cam: Camera, u, v, jitter=None) -> Rays:
    """Generate primary rays for uv coords (+ optional per-ray jitter (N,2))."""
    fwd = vec.normalize(cam.target - cam.eye)
    b1 = vec.normalize(vec.cross(fwd, cam.up))
    b2 = vec.cross(b1, fwd)
    if jitter is not None:
        u = u + jitter[..., 0]
        v = v + jitter[..., 1]
    q = (
        b1 * (u * cam.aspect)[..., None]
        + b2 * v[..., None]
        + fwd * cam.constant
    )
    d = vec.normalize(q)
    o = jnp.broadcast_to(cam.eye, d.shape)
    return make_rays(o, d)
