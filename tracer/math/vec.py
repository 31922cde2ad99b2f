"""Vector math over trailing-axis-3 arrays.

The reference keeps a generic ``Vec3<T>``/``Vec4<T>`` tuple type with
elementwise ops (``/root/reference/src/data_structures/vector.rs:5-242``).
Here the natural representation is a batched array whose *leading* axes are
the ray/pixel batch and whose trailing axis is the component axis of size 3 —
XLA vectorizes over the batch and the component axis unrolls.
All helpers below are shape-polymorphic over leading axes and work for both
``jax.numpy`` and ``numpy`` inputs (used by the CPU oracle).
"""

from __future__ import annotations

import jax.numpy as jnp


def vec3(x, y, z, dtype=jnp.float32):
    """Build a (..., 3) array by stacking components on the last axis."""
    return jnp.stack(
        [jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)],
        axis=-1,
    )


def dot(a, b, keepdims: bool = False):
    """Batched dot product over the trailing component axis."""
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    """Batched 3D cross product (trailing axis 3)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length(a, keepdims: bool = False):
    return jnp.sqrt(jnp.sum(a * a, axis=-1, keepdims=keepdims))


def normalize(a, eps: float = 0.0):
    """Normalize over the trailing axis.

    With ``eps=0`` this matches WGSL ``normalize`` (inf/nan on zero vectors);
    pass a small eps for gradient-safe normalization in differentiable paths.
    """
    n2 = jnp.sum(a * a, axis=-1, keepdims=True)
    if eps:
        n2 = jnp.maximum(n2, eps)
    return a / jnp.sqrt(n2)


def reflect(d, n):
    """WGSL ``reflect``: ``d - 2*dot(d, n)*n`` (d points toward surface)."""
    return d - 2.0 * dot(d, n, keepdims=True) * n


def saturate(x):
    """WGSL ``saturate``: clamp to [0, 1]."""
    return jnp.clip(x, 0.0, 1.0)


def where(mask, a, b):
    """``jnp.where`` with the mask broadcast over a trailing component axis."""
    return jnp.where(mask[..., None], a, b)


def mean3(a):
    """Mean over the component axis — reference's RR albedo average
    (``/root/reference/res/shaders/w8e3.wgsl:484``)."""
    return jnp.mean(a, axis=-1)
