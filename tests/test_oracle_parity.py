"""Golden-image tests: wavefront integrator vs the scalar CPU oracle.

The correctness gate from BASELINE.md: rendered images allclose vs a CPU
reference tracer. Both implementations consume identical PRNG streams, so
images should agree to float32 tolerance even for stochastic scenes.
"""

import dataclasses

import numpy as np
import pytest

from tracer.render import integrator as I
from tracer.scenes import build_oracle_scene, build_scene, get_scene
from tracer.oracle import cpu_tracer as oracle


def _small(desc, w=24, h=24, **cfg_kw):
    cfg = dataclasses.replace(desc.cfg, width=w, height=h, **cfg_kw)
    return dataclasses.replace(desc, cfg=cfg)


def _render_both(desc, iteration=0):
    scene, cfg = build_scene(desc)
    import jax.numpy as jnp

    from tracer.util import replace as rep

    scene = rep(
        scene,
        uniforms=rep(scene.uniforms, iteration=jnp.asarray(iteration, jnp.uint32)),
    )
    img = np.asarray(I.render_sample(scene, cfg)).reshape(
        cfg.height, cfg.width, 3
    )
    osc, ocfg, cam = build_oracle_scene(desc)
    ref = oracle.render(osc, ocfg, cam, iteration=iteration)
    return img, ref


def assert_close(img, ref, atol=2e-3, frac=0.999):
    """Allclose with a tiny allowance for fp-order divergence at silhouettes."""
    ok = np.isclose(img, ref, atol=atol, rtol=1e-3).all(axis=-1)
    assert ok.mean() >= frac, (
        f"only {ok.mean():.4f} of pixels match; "
        f"max abs diff {np.abs(img - ref).max():.4g}"
    )


def test_w1e6_matches_oracle():
    desc = _small(get_scene("W1 E6"))
    img, ref = _render_both(desc)
    assert img.std() > 0.05  # non-trivial image
    assert_close(img, ref)


def test_w1e4_basecolor_matches_oracle():
    desc = _small(get_scene("W1 E4"))
    img, ref = _render_both(desc)
    assert_close(img, ref)


def test_w2_mirror_and_shadows_match_oracle():
    # W2 E2 with sphere=mirror, plane=lambertian via selections.
    desc = _small(get_scene("W2 E2"))
    desc = dataclasses.replace(desc, selection1=2, selection2=0)
    img, ref = _render_both(desc)
    assert_close(img, ref)


def test_w2_transmit_matches_oracle():
    desc = _small(get_scene("W2 E3"))
    desc = dataclasses.replace(desc, selection1=3, selection2=0)
    img, ref = _render_both(desc)
    assert_close(img, ref)


def test_w2_phong_glossy_match_oracle():
    desc = _small(get_scene("W2 E5"))
    desc = dataclasses.replace(desc, selection1=4, selection2=1)
    img, ref = _render_both(desc)
    assert_close(img, ref)


def test_w5e5_area_lights_match_oracle():
    desc = _small(get_scene("W5 E5 Cornell Box"), 16, 16, traversal="brute")
    img, ref = _render_both(desc)
    assert img.std() > 0.01
    # frac < 1: XLA fuses with FMA, scalar NumPy doesn't — last-ulp t
    # differences flip shadow-ray visibility at silhouette pixels.
    assert_close(img, ref, frac=0.99)


def test_w5e2_directional_matches_oracle():
    desc = _small(get_scene("W5 E2 Teapot"), 16, 16, traversal="brute")
    img, ref = _render_both(desc)
    assert_close(img, ref)


@pytest.mark.parametrize("iteration", [0, 3])
def test_cornell_path_matches_oracle(iteration):
    # W8 E3: full path tracer with NEE + RR + Fresnel/Beer dielectric.
    desc = _small(get_scene("W8 E3 Absorption"), 16, 16, traversal="brute")
    img, ref = _render_both(desc, iteration=iteration)
    assert img.std() > 0.01
    assert_close(img, ref, atol=5e-3, frac=0.99)


def test_cornell_path_bvh_equals_brute():
    desc_b = _small(get_scene("W8 E3 Absorption"), 16, 16, traversal="brute")
    desc_v = _small(get_scene("W8 E3 Absorption"), 16, 16, traversal="bvh")
    img_b, _ = _render_both(desc_b)
    img_v, _ = _render_both(desc_v)
    assert_close(img_v, img_b, atol=1e-4, frac=1.0)


def test_cornell_path_bsp_equals_brute():
    desc_b = _small(get_scene("W8 E3 Absorption"), 16, 16, traversal="brute")
    desc_s = _small(get_scene("W8 E3 Absorption"), 16, 16, traversal="bsp")
    img_b, _ = _render_both(desc_b)
    img_s, _ = _render_both(desc_s)
    assert_close(img_s, img_b, atol=1e-4, frac=0.995)


def test_w3e3_textured_plane_stratified_matches_oracle():
    # W3 E3: grass-textured plane + 4x4 stratified sub-pixel AA
    # (w3e3.wgsl:150-165). Exercises bilinear sampling + fract(uv*scale).
    desc = _small(get_scene("W3 E3"))
    img, ref = _render_both(desc)
    assert img.std() > 0.05
    assert_close(img, ref)


def test_w3e4_nearest_sampler_matches_oracle():
    # W3 E4 sampler-mode switch (w3e4.wgsl:196-216): nearest vs oracle.
    import jax.numpy as jnp

    from tracer.render import texture as tex
    from tracer.util import replace as rep

    desc = _small(get_scene("W3 E4"))
    scene, cfg = build_scene(desc)
    scene = rep(
        scene,
        uniforms=rep(
            scene.uniforms,
            use_texture=jnp.asarray(tex.TEX_NEAREST, jnp.int32),
            uv_scale=jnp.asarray((2.0, 2.0), jnp.float32),
        ),
    )
    img = np.asarray(I.render_sample(scene, cfg)).reshape(
        cfg.height, cfg.width, 3
    )
    osc, ocfg, cam = build_oracle_scene(desc)
    osc.tex_mode = tex.TEX_NEAREST
    osc.uv_scale = np.array([2.0, 2.0], np.float32)
    ref = oracle.render(osc, ocfg, cam)
    assert_close(img, ref)


def test_w6e1_mix_ka_matches_oracle():
    # W6 E1: mix_ka ambient + directional_n over the BSP-configured teapot
    # (w6e1.wgsl:288-297); the oracle traces brute-force, so this also
    # gates BSP traversal against an independent implementation.
    desc = _small(get_scene("W6 E1 Teapot"), 16, 16)
    img, ref = _render_both(desc)
    assert img.std() > 0.01
    assert_close(img, ref, frac=0.99)


def test_w9e1_env_map_matches_oracle():
    # W9 E1: lat-long jpg environment lighting on miss (w9e2.wgsl:234-246
    # uv math, LDR decode), path mode.
    desc = _small(get_scene("W9 E1 Teapot"), 16, 16)
    img, ref = _render_both(desc)
    assert img.std() > 0.01
    assert_close(img, ref, atol=5e-3, frac=0.99)


def test_w9e2_holdout_matches_oracle():
    # W9 E2: holdout/shadow-catcher plane with hemisphere AO probe
    # (w9e2.wgsl:514-538). The RGBE asset is missing from the mount, so
    # point the scene at the LDR campus jpg to make the env term live.
    desc = get_scene("W9 E2 Teapot")
    desc = dataclasses.replace(
        desc,
        hdri=desc.hdri.replace(".hdr.png", ".jpg"),
        hdri_rgbe=False,
    )
    desc = _small(desc, 16, 16)
    img, ref = _render_both(desc)
    assert img.std() > 0.01
    assert_close(img, ref, atol=5e-3, frac=0.99)


def test_accumulate_formula():
    import jax.numpy as jnp

    r = jnp.ones((4, 3)) * 2.0
    acc = jnp.ones((4, 3))
    out = I.accumulate(r, acc, jnp.uint32(3))
    assert np.allclose(out, (2.0 + 3.0) / 4.0)


def test_to_display_guards():
    import jax.numpy as jnp
    from tracer.render.scene import SceneConfig

    cfg = SceneConfig(gamma=1.5)
    acc = jnp.asarray([[0.5, 0.5, 0.5], [-0.1, 0.2, 0.3]])
    disp = np.asarray(I.to_display(acc, cfg))
    assert np.allclose(disp[0], 0.5**1.5, atol=1e-6)
    assert np.allclose(disp[1], [0.7, 0.0, 0.7])  # magenta sentinel


def test_bsp_fast_execution_matches_walk():
    """BSP-configured scenes execute through the treelet engines by
    default (cfg.bsp_execution == "fast"); the faithful per-ray BSP walk
    must produce the same image — closest-hit is traversal-independent.
    This is the parity gate for routing the reference's default w6-w8
    engine (res/shaders/bsp.wgsl) through the treelet engines."""
    desc = _small(get_scene("W6 E1 Teapot"), 16, 16)
    scene_f, cfg_f = build_scene(desc)
    assert cfg_f.traversal == "bsp" and scene_f.tb is not None
    img_fast = np.asarray(I.render_sample(scene_f, cfg_f)).reshape(16, 16, 3)

    desc_w = dataclasses.replace(
        desc, cfg=dataclasses.replace(desc.cfg, bsp_execution="walk")
    )
    scene_w, cfg_w = build_scene(desc_w)
    img_walk = np.asarray(I.render_sample(scene_w, cfg_w)).reshape(16, 16, 3)
    # frac < 1: equal-t tie-breaking between engines may differ on shared
    # edges; everything else must match exactly.
    assert_close(img_fast, img_walk, atol=1e-5, frac=0.995)
