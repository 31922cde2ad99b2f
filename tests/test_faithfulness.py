"""Regression pins for shading semantics re-derived from the WGSL itself.

These exist because the oracle and integrator were once written from the
same misreading: both scaled the ``directional_n``
contribution by the light count, while the reference's lightIndices loop
``break``s after one iteration (project.wgsl:286-293, w6e1 lambertian).
Each test below pins a property derivable from the WGSL *without* trusting
either implementation.
"""

import dataclasses

import numpy as np

from tracer.render import integrator as I
from tracer.scenes import build_scene, get_scene


def _render(desc):
    scene, cfg = build_scene(desc)
    return np.asarray(I.render_sample(scene, cfg)).reshape(
        cfg.height, cfg.width, 3
    )


def _small(desc, w=16, h=16, **cfg_kw):
    cfg = dataclasses.replace(desc.cfg, width=w, height=h, **cfg_kw)
    return dataclasses.replace(desc, cfg=cfg)


def test_directional_n_is_one_unscaled_sample():
    """The Cornell project scene has 2 emissive triangles; the old bug
    scaled the directional term by L+1 = 3x. The reference loop breaks
    after the first sample, so ``directional_n`` must render *identically*
    to a plain single ``directional`` light (shadows are off in both)."""
    base = get_scene("Project: Cornell Box")
    d_n = _small(base)
    d_1 = _small(base, lights=("directional",), shadows=False)
    img_n = _render(d_n)
    img_1 = _render(d_1)
    assert img_n.std() > 0.01
    np.testing.assert_allclose(img_n, img_1, atol=1e-6)


def test_mix_ka_ambient_uses_material_ka():
    """w6e1.wgsl:295-297: ambient = material.ambient (Ka), mixed as
    0.9*diffuse + 0.1*Ka. Pin with a constructed hit whose normal is
    orthogonal to the light (zero diffuse): output must be exactly 0.1*Ka,
    not 0.1*albedo."""
    import jax.numpy as jnp

    from tracer.kernels.intersect import Rays
    from tracer.render.scene import SceneConfig, make_scene
    from tracer.render.camera import make_camera

    cfg = SceneConfig(
        lights=("directional_n",),
        shadows=False,
        ambient="mix_ka",
        dir_light_direction=(-1.0, 0.0, 0.0),
        dir_light_intensity=(np.pi, np.pi, np.pi),
    )
    cam = make_camera(
        eye=(0.0, 0.0, 1.0), target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
        constant=1.0, aspect=1.0,
    )
    scene = make_scene(cam)
    n = 2
    f32 = jnp.float32
    ka = jnp.asarray([[0.2, 0.3, 0.4]] * n, f32)
    albedo = jnp.asarray([[0.9, 0.8, 0.7]] * n, f32)
    hit = I.Hit(
        valid=jnp.ones(n, bool),
        t=jnp.ones(n, f32),
        position=jnp.zeros((n, 3), f32),
        # light w_i = +x; normal = +y -> dot = 0 -> diffuse term vanishes
        normal=jnp.asarray([[0.0, 1.0, 0.0]] * n, f32),
        shader=jnp.zeros(n, jnp.int32),
        albedo=albedo,
        emission=ka,
        specular=jnp.zeros(n, f32),
        shininess=jnp.zeros(n, f32),
        ior=jnp.ones(n, f32),
        extinction=jnp.zeros((n, 3), f32),
        uv=jnp.zeros((n, 2), f32),
        textured=jnp.zeros(n, bool),
        is_mesh=jnp.ones(n, bool),
        converged=jnp.ones(n, bool),
    )
    rays = Rays(
        o=jnp.zeros((n, 3), f32),
        d=jnp.asarray([[0.0, 0.0, -1.0]] * n, f32),
        tmin=jnp.zeros(n, f32),
        tmax=jnp.full(n, 100.0, f32),
    )
    out = np.asarray(
        I._shade_lambertian_direct(scene, cfg, rays, hit, albedo)[0]
    )
    np.testing.assert_allclose(out, 0.1 * np.asarray(ka), atol=1e-6)
