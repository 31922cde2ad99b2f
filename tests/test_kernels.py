"""The hits kernel, its dispatch, and the gradient-path primitives.

The Triton hits kernel runs here in the Pallas interpreter (asked for by
argument); on the card it is compared with its plain-XLA form by the
``gpu``-marked test below and by ``chip_smoke.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_accel import _mixed_rays, blob_tb  # noqa: F401  (fixture)
from tracer.accel import flat
from tracer.kernels import super_hits
from tracer.kernels.intersect import (
    make_rays,
    mesh_brute_force,
    mesh_brute_force_anyhit,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _interpret_dispatch(tc):
    def dispatch(tb, eids, enear, en, gm, o, d, tmin, bt, bp, any_hit):
        return super_hits.hits(
            tb, eids, enear, en, gm, o, d, tmin, bt, bp, any_hit,
            interpret=True, tc=tc,
        )

    return dispatch


@pytest.mark.parametrize("tc", [4, 8])
def test_hits_kernel_interpret_closest(blob_tb, monkeypatch, tc):
    """Kernel (interpreted) closest hit == brute force, with one and two
    triangle chunks per quarter-block."""
    mesh, tb = blob_tb
    monkeypatch.setattr(flat, "_dispatch", _interpret_dispatch(tc))
    rays = _mixed_rays(mesh, n=512, seed=5)
    _, id_ref = mesh_brute_force(
        rays, jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices)
    )
    _, pid = flat.closest_hit(rays, tb)
    np.testing.assert_array_equal(np.asarray(id_ref), np.asarray(pid))


def test_hits_kernel_interpret_anyhit(blob_tb, monkeypatch):
    mesh, tb = blob_tb
    monkeypatch.setattr(flat, "_dispatch", _interpret_dispatch(4))
    rays = _mixed_rays(mesh, n=512, seed=6, tmax=4.0)
    b_ref = mesh_brute_force_anyhit(
        rays, jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices)
    )
    b = flat.any_hit(rays, tb)
    np.testing.assert_array_equal(np.asarray(b_ref), np.asarray(b))


def test_hits_kernel_interpret_matches_xla_form(blob_tb):
    """Same emission round through the kernel and the plain-XLA form."""
    mesh, tb = blob_tb
    rays = _mixed_rays(mesh, n=1024, seed=8)
    box = []

    def spy(*args):
        box.append(args)
        return flat._phase_b_xla_q(*args[:2], *args[3:4], *args[5:])

    orig = flat._dispatch
    flat._dispatch = spy
    try:
        flat._run(rays, tb, None, any_hit=False)
    finally:
        flat._dispatch = orig
    tb_, eids, enear, en, gm, o, d, tmin, bt, bp, _ = box[0]
    tk, pk = super_hits.hits(tb_, eids, enear, en, gm, o, d, tmin, bt, bp,
                             False, interpret=True, tc=4)
    tx, px = flat._phase_b_xla_q(tb_, eids, en, o, d, tmin, bt, bp, False)
    np.testing.assert_array_equal(np.asarray(pk), np.asarray(px))
    np.testing.assert_allclose(np.asarray(tk), np.asarray(tx), rtol=1e-6)


def test_dispatch_per_platform(blob_tb):
    """CUDA lowers the Triton kernel, the CPU the plain-XLA form; neither
    uses the interpreter, and any other platform is refused."""
    mesh, tb = blob_tb
    rays = _mixed_rays(mesh, n=256, seed=2)
    f = jax.jit(flat.closest_hit)
    cuda = f.trace(rays, tb).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in cuda
    cpu = f.trace(rays, tb).lower(lowering_platforms=("cpu",)).as_text()
    assert "triton" not in cpu
    with pytest.raises(NotImplementedError):
        f.trace(rays, tb).lower(lowering_platforms=("rocm",))


def test_dispatch_second_call(blob_tb):
    """Repeated calls of one jitted frame-layout program: each must pass
    the argument list its compiled program expects (a jnp array constant
    captured by the trace broke this beside the platform-dependent hits
    stage)."""
    mesh, tb = blob_tb
    W, H = 32, 16
    u = (np.arange(W) + 0.5) / W - 0.5
    v = 0.5 - (np.arange(H) + 0.5) / H
    uu, vv = np.meshgrid(u, v)
    d = np.stack([uu.ravel(), vv.ravel(), -np.ones(W * H)], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(np.array([[0.1, 0.0, 3.0]]), (W * H, 1))
    rays = make_rays(jnp.asarray(o), jnp.asarray(d))
    f = jax.jit(flat.closest_hit, static_argnames=("frame",))
    _, a = f(rays, tb, frame=(W, H))
    _, b = f(rays, tb, frame=(W, H))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    short = make_rays(rays.o, rays.d, tmax=jnp.full_like(rays.tmax, 3.0))
    _, c = f(short, tb, frame=(W, H))
    assert c.shape == a.shape


@pytest.fixture
def gpu():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")


@pytest.mark.gpu
def test_hits_kernel_on_card_matches_xla_form(blob_tb, gpu):
    """Compiled kernel on the card: closest-hit ids == brute force."""
    mesh, tb = blob_tb
    rays = _mixed_rays(mesh, n=1024, seed=9)
    with jax.default_device(gpu):
        tbg = jax.device_put(tb, gpu)
        rg = jax.device_put(rays, gpu)
        _, pid = jax.jit(flat.closest_hit)(rg, tbg)
        _, id_ref = mesh_brute_force(
            rg, jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices)
        )
    np.testing.assert_array_equal(np.asarray(id_ref), np.asarray(pid))


def test_onehot_rows_exact():
    """The HIGHEST-precision one-hot fetch reproduces the gather bit for
    bit (a TF32 product would round these mantissas)."""
    from tracer.render.integrator import onehot_rows

    rs = np.random.RandomState(0)
    table = jnp.asarray(rs.uniform(-555.0, 555.0, (37, 11)), jnp.float32)
    ids = jnp.asarray(rs.randint(0, 37, 4096), jnp.int32)
    got = jax.jit(onehot_rows)(ids, table)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(table[ids]))


def test_fetch_tri_rows_vjp_matches_plain_gather():
    """fetch_tri_rows' custom VJP (one (V, 6) scatter-add) == jax.grad of
    the plain per-corner gather formulation, on a bumpy_blob mesh."""
    from tracer.geometry import device
    from tracer.geometry.procedural import bumpy_blob

    mesh = bumpy_blob(12, 12, 1.0, (0.0, 0.0, 0.0))
    V = jnp.asarray(mesh.vertices)
    N = jnp.asarray(mesh.normals)
    I = jnp.asarray(mesh.indices, jnp.int32)
    M = jnp.asarray(mesh.mat_ids, jnp.int32)
    table = device._tri_table(V, N, I, M)
    rs = np.random.RandomState(1)
    tri_c = jnp.asarray(rs.randint(0, I.shape[0], 3000), jnp.int32)
    w = jnp.asarray(rs.randn(3000, 18), jnp.float32)

    def custom(v, n):
        return jnp.sum(device.fetch_tri_rows(v, n, table, I, tri_c)[:, :18] * w)

    def plain(v, n):
        idx = I[tri_c]
        rows = jnp.concatenate(
            [v[idx[:, c]] for c in range(3)] + [n[idx[:, c]] for c in range(3)],
            axis=1,
        )
        return jnp.sum(rows * w)

    gc = jax.grad(custom, argnums=(0, 1))(V, N)
    gp = jax.grad(plain, argnums=(0, 1))(V, N)
    for a, b in zip(gc, gp):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


def test_scatter_add_vn_matches_float64():
    """The vertex-cotangent scatter-add against chip_smoke's float64
    reference (the same check the card runs at dragon scale)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from tracer.geometry import device

    rs = np.random.RandomState(2)
    V = 500
    idx = rs.randint(0, V, (4000, 3)).astype(np.int32)
    g = rs.randn(4000, 3, 6).astype(np.float32)
    out = device.scatter_add_vn(jnp.asarray(idx), jnp.asarray(g), V,
                                jnp.float32)
    assert chip_smoke.compare_scatter(out, idx, g, V)["ok"]


def _env_without(*names):
    return {k: v for k, v in os.environ.items() if k not in names}


@pytest.mark.parametrize("given", [False, True], ids=["default", "env"])
def test_compile_cache_dir(tmp_path, given):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits at
    one fixed path inside the checkout."""
    env = _env_without("JAX_COMPILATION_CACHE_DIR")
    env["JAX_PLATFORMS"] = "cpu"
    want = os.path.join(REPO, ".jax_cache")
    if given:
        want = str(tmp_path / "cc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "import tracer, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(tmp_path), env={**env, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300, check=True,
    ).stdout.strip().splitlines()[-1]
    assert out == want
