"""Differentiability: pixel gradients to materials, lights, geometry, camera.

The BASELINE gate: gradient allclose (AD vs finite difference) on the
Cornell-box scene for interior-smooth parameters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracer.diff import grad as G
from tracer.scenes import build_scene, get_scene
from tracer.util import replace


def _scene(w=10, h=10, traversal="bvh", name="W8 E3 Absorption"):
    d = get_scene(name)
    d = dataclasses.replace(
        d, cfg=dataclasses.replace(d.cfg, width=w, height=h, traversal=traversal)
    )
    return build_scene(d)


@pytest.fixture(scope="module")
def cornell():
    return _scene()


@pytest.fixture(scope="module")
def target(cornell):
    scene, cfg = cornell
    return jnp.clip(G.render_radiance(scene, cfg) * 0.9, 0.0, 10.0)


def test_grad_albedo_fd(cornell, target):
    scene, cfg = cornell
    direction = jnp.ones_like(scene.materials.diffuse) * 0.01

    def get(s):
        return s.materials.diffuse

    def set_(s, leaf):
        return replace(s, materials=replace(s.materials, diffuse=leaf))

    G.fd_check(scene, cfg, target, get, set_, direction, eps=3e-2, rtol=0.15)


def test_grad_emission_fd(cornell, target):
    scene, cfg = cornell
    direction = jnp.ones_like(scene.materials.emission)

    def get(s):
        return s.materials.emission

    def set_(s, leaf):
        return replace(s, materials=replace(s.materials, emission=leaf))

    G.fd_check(scene, cfg, target, get, set_, direction, eps=1e-1, rtol=0.12)


def test_grad_vertices_fd(cornell, target):
    scene, cfg = cornell
    # Interior-smooth probe: rigid translation along z of all vertices by a
    # small amount (silhouette-biased pixels are a tiny fraction at eps).
    direction = jnp.zeros_like(scene.geom.vertices).at[:, 2].set(1.0)

    def get(s):
        return s.geom.vertices

    def set_(s, leaf):
        # tri_table is a derived cache of vertices/normals — the FD probe
        # must refresh it (the AD path's custom VJP reads it; gradients
        # flow to vertices, the table's own cotangent is zero).
        from tracer.geometry.device import refresh_tri_table

        return replace(s, geom=refresh_tri_table(
            replace(s.geom, vertices=leaf)
        ))

    G.fd_check(scene, cfg, target, get, set_, direction, eps=5e-1, rtol=0.25)


def test_grad_sphere_center_fd(cornell, target):
    scene, cfg = cornell
    direction = jnp.zeros_like(scene.spheres.center).at[0, 1].set(1.0)

    def get(s):
        return s.spheres.center

    def set_(s, leaf):
        return replace(s, spheres=replace(s.spheres, center=leaf))

    G.fd_check(scene, cfg, target, get, set_, direction, eps=5e-1, rtol=0.3)


def test_grad_camera_fd(cornell, target):
    scene, cfg = cornell
    direction = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)

    def get(s):
        return s.camera.eye

    def set_(s, leaf):
        return replace(s, camera=replace(s.camera, eye=leaf))

    G.fd_check(scene, cfg, target, get, set_, direction, eps=5e-1, rtol=0.3)


def test_grad_full_pytree_nonzero(cornell, target):
    scene, cfg = cornell
    g = G.grad_scene(scene, cfg, target)
    assert np.abs(np.asarray(g.materials.diffuse)).sum() > 0
    assert np.abs(np.asarray(g.geom.vertices)).sum() > 0
    assert np.abs(np.asarray(g.camera.eye)).sum() > 0


def test_grad_deterministic(cornell, target):
    """Material gradients are bit-identical run to run (also on the H100).
    Vertex/normal gradients go through one scatter-add, which the GPU
    lowers to atomic adds summed in no fixed order: on the card they
    differ run to run in the last bits (max 9.3e-10 on the dragon), so
    they are held to rtol 1e-5, atol 1e-6 * max|g|."""
    scene, cfg = cornell
    g1 = G.grad_scene(scene, cfg, target)
    g2 = G.grad_scene(scene, cfg, target)
    assert np.array_equal(
        np.asarray(g1.materials.diffuse), np.asarray(g2.materials.diffuse)
    )
    v1 = np.asarray(g1.geom.vertices)
    v2 = np.asarray(g2.geom.vertices)
    assert np.allclose(v1, v2, rtol=1e-5, atol=1e-6 * np.abs(v1).max())
