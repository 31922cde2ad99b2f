"""Multi-device sharding on virtual CPU devices (conftest forces 8)."""

import dataclasses

import jax
import numpy as np
import pytest

from tracer.parallel import shard as S
from tracer.parallel.shard import collective_census
from tracer.render import progressive as P
from tracer.scenes import build_scene, get_scene

def _desc(w=16, h=16):
    """The ``Project: Bunny`` stand-in (treelet traversal, built from the
    repository alone) at a tiny resolution."""
    d = get_scene("Project: Bunny")
    return dataclasses.replace(
        d, cfg=dataclasses.replace(d.cfg, width=w, height=h)
    )


@pytest.fixture(scope="module")
def bunny():
    return build_scene(_desc())


@pytest.fixture(scope="module", params=[8, 4], ids=["8dev", "4dev"])
def mesh(request):
    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    return S.make_ray_mesh(jax.devices()[: request.param])


def test_sharded_matches_single_device(mesh, bunny):
    scene, cfg = bunny
    single = P.render_progressive(scene, cfg, 2)
    sharded = S.render_progressive_sharded(scene, cfg, 2, mesh=mesh)
    img_single = P.image(single, cfg)
    img_sharded = S.gather_image(sharded, cfg)
    assert np.allclose(img_single, img_sharded, atol=1e-5)


def test_sharded_step_compiles_once(mesh, bunny):
    """Each step's output state has the layout its input had, so the
    progressive loop never retraces after the first frame."""
    scene, cfg = bunny
    scene_r = S.replicate_scene(scene, mesh)
    state = S.shard_state(P.init_state(cfg), cfg, mesh)
    step = S.sharded_step(mesh)
    for _ in range(3):
        state = step(scene_r, cfg, state)
    assert step._cache_size() == 1


def test_sharded_layout(mesh, bunny):
    _, cfg = bunny
    k = mesh.devices.size
    st = S.shard_state(P.init_state(cfg), cfg, mesh)
    # padded to k bands of whole super-tile rows, sharded over the ray axis
    rows = S.band_rows(cfg.height, k)
    assert rows % 32 == 0 and k * rows >= cfg.height
    assert st.accum.shape[0] == k * rows * cfg.width
    shard_shapes = {s.data.shape for s in st.accum.addressable_shards}
    assert len(shard_shapes) == 1
    assert next(iter(shard_shapes))[0] == st.accum.shape[0] // k


def test_sharded_gradient_psum(mesh):
    """Gradients wrt replicated scene params reduce over the sharded ray
    axis (the psum of the per-band gradients)."""
    import jax.numpy as jnp

    from tracer.diff.grad import grad_scene

    scene, cfg = build_scene(_desc())
    target = jnp.zeros((cfg.height * cfg.width, 3), jnp.float32)
    g_single = grad_scene(scene, cfg, target)
    scene_r = S.replicate_scene(scene, mesh)
    target_r = S.shard_rows(target, cfg, mesh)
    g_sharded = S.sharded_grad(mesh)(scene_r, cfg, target_r)
    for leaf in ("diffuse", "emission"):
        gd_s = np.asarray(getattr(g_single.materials, leaf))
        gd_m = np.asarray(getattr(g_sharded.materials, leaf))
        assert np.allclose(gd_s, gd_m, atol=1e-5)
    assert np.abs(np.asarray(g_single.materials.diffuse)).sum() > 0
    gv_s = np.asarray(g_single.geom.vertices)
    assert np.abs(gv_s).sum() > 0  # non-trivial geometry gradient
    # Every leaf, the traversal structures' zero gradients included.
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g_single),
                            jax.tree.leaves(g_sharded)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dtype.kind == "f" and a.size:
            assert np.allclose(a, b, rtol=1e-4, atol=1e-6 * np.abs(a).max()), (
                jax.tree_util.keystr(path))


def test_sharded_hlo_collective_structure(mesh):
    """The sharding's claim, enforced at compile time: the compiled sharded
    forward step moves no data between devices (scene and accel buffers
    are replicated, pixels are device-local), and the sharded gradient
    step's backward is psum-only (the all-reduce of the replicated
    scene-parameter cotangents), with no gathers or permutes."""
    import jax.numpy as jnp

    # 64x32 pixels: one super-tile row, one band per device.
    scene, cfg = build_scene(_desc(64, 32))
    scene_r = S.replicate_scene(scene, mesh)
    state = S.shard_state(P.init_state(cfg), cfg, mesh)
    step = S.sharded_step(mesh, donate=False)
    fwd = collective_census(step.lower(scene_r, cfg, state).compile().as_text())
    for k in ("all-gather", "collective-permute", "all-to-all",
              "reduce-scatter"):
        assert fwd[k] == 0, (
            f"forward step must move no data between devices, got {fwd}"
        )
    # Control-scalar all-reduces (a replicated loop predicate over sharded
    # lanes) would be latency only; no data payload is allowed.
    assert fwd["payload_bytes"] <= 16, (
        f"forward all-reduce payload must be control scalars only, got {fwd}"
    )

    target = S.shard_rows(
        jnp.zeros((cfg.height * cfg.width, 3), jnp.float32), cfg, mesh
    )
    grad_hlo = S.sharded_grad(mesh).lower(
        scene_r, cfg, target).compile().as_text()
    g = collective_census(grad_hlo)
    assert g["all-reduce"] >= 1, f"gradient psum missing: {g}"
    for k in ("all-gather", "collective-permute", "all-to-all",
              "reduce-scatter"):
        assert g[k] == 0, f"backward must be psum-only, got {g}"
