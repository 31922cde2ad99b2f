"""Orthonormal-basis utilities.

``rotate_to_normal`` is the Frisvad/Duff branchless ONB rotation used by the
reference for cosine-hemisphere sampling
(``/root/reference/res/shaders/w9e2.wgsl:169-181``). It is branch-free by
construction — every lane of a wavefront executes the same code.
"""

from __future__ import annotations

import jax.numpy as jnp

from tracer.math import vec


def rotate_to_normal(normal, v):
    """Rotate ``v`` (sampled around +z) so +z maps to ``normal``.

    [Frisvad, JGT 16, 2012; Duff et al., JCGT 6, 2017] — matches
    ``rotate_to_normal`` (``w9e2.wgsl:173-181``) including the 1e-16 sign
    epsilon.
    """
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    signbit = jnp.sign(nz + 1.0e-16)
    a = -1.0 / (1.0 + jnp.abs(nz))
    b = nx * ny * a
    t0 = vec.vec3(1.0 + nx * nx * a, b, -signbit * nx)
    t1 = vec.vec3(signbit * b, signbit * (1.0 + ny * ny * a), -ny)
    return (
        t0 * v[..., 0:1] + t1 * v[..., 1:2] + normal * v[..., 2:3]
    )


def spherical_direction(sin_theta, cos_theta, phi):
    """Direction from spherical coords (polar theta, azimuthal phi) —
    ``spherical_direction`` (``w9e2.wgsl:186-191``)."""
    return vec.vec3(
        sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta
    )
