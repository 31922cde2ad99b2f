"""Acceleration-structure invariants and traversal parity vs brute force.

Mirrors the reference's builder tests (leaf coverage ``bsp_tree.rs:357-392``,
id uniqueness ``:395-420``, HLBVH smoke ``hlbvh.rs:536-573``) and adds what it
lacked: hit parity between accelerated and brute-force traversal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracer.accel import lbvh, traverse
from tracer.kernels.intersect import make_rays, mesh_brute_force, mesh_brute_force_anyhit


def _rand_rays(mesh, n=512, seed=0):
    rs = np.random.RandomState(seed)
    lo = mesh.vertices.min(axis=0)
    hi = mesh.vertices.max(axis=0)
    c = (lo + hi) / 2
    ext = float(np.max(hi - lo))
    o = c + rs.randn(n, 3).astype(np.float32) * ext
    tgt = c + rs.randn(n, 3).astype(np.float32) * ext * 0.3
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return make_rays(jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32))


@pytest.mark.parametrize("max_prims", [1, 4, 8])
def test_lbvh_invariants(teapot_mesh, max_prims):
    lo, hi = teapot_mesh.bboxes()
    bvh = lbvh.build(lo, hi, max_prims=max_prims)
    lbvh.validate(bvh, teapot_mesh.num_triangles)
    assert (bvh.count[bvh.count > 0] <= max_prims).all()


def test_lbvh_tiny(cornell_mesh):
    lo, hi = cornell_mesh.bboxes()
    bvh = lbvh.build(lo, hi, max_prims=4)
    lbvh.validate(bvh, cornell_mesh.num_triangles)


def test_lbvh_single_leaf():
    lo = np.zeros((3, 3), np.float32)
    hi = np.ones((3, 3), np.float32)
    bvh = lbvh.build(lo, hi, max_prims=4)
    assert bvh.count[0] == 3
    lbvh.validate(bvh, 3)


def test_lbvh_duplicate_centroids():
    # all-identical centroids: morton codes collide; index bits must
    # disambiguate (PBRT trick).
    lo = np.zeros((64, 3), np.float32)
    hi = np.ones((64, 3), np.float32)
    bvh = lbvh.build(lo, hi, max_prims=4)
    lbvh.validate(bvh, 64)


def test_closest_hit_matches_brute(teapot_mesh):
    lo, hi = teapot_mesh.bboxes()
    bvh = jax.tree.map(jnp.asarray, lbvh.build(lo, hi, 4))
    V = jnp.asarray(teapot_mesh.vertices)
    I = jnp.asarray(teapot_mesh.indices.astype(np.int64), jnp.int32)
    rays = _rand_rays(teapot_mesh, 512)
    bt, bid = mesh_brute_force(rays, V, I)
    ct, cid = traverse.bvh_closest_hit(rays, bvh, V, I)
    bt, bid, ct, cid = map(np.asarray, (bt, bid, ct, cid))
    assert (bid >= 0).sum() > 50  # rays actually hit
    assert ((bid >= 0) == (cid >= 0)).all()
    both = bid >= 0
    assert np.allclose(bt[both], ct[both], atol=1e-4)
    assert (bid[both] == cid[both]).mean() > 0.999


def test_any_hit_matches_brute(cornell_mesh):
    lo, hi = cornell_mesh.bboxes()
    bvh = jax.tree.map(jnp.asarray, lbvh.build(lo, hi, 4))
    V = jnp.asarray(cornell_mesh.vertices)
    I = jnp.asarray(cornell_mesh.indices.astype(np.int64), jnp.int32)
    rays = _rand_rays(cornell_mesh, 512, seed=1)
    b = np.asarray(mesh_brute_force_anyhit(rays, V, I))
    a = np.asarray(traverse.bvh_any_hit(rays, bvh, V, I))
    assert (a == b).all()


def test_anyhit_respects_tmax(cornell_mesh):
    lo, hi = cornell_mesh.bboxes()
    bvh = jax.tree.map(jnp.asarray, lbvh.build(lo, hi, 4))
    V = jnp.asarray(cornell_mesh.vertices)
    I = jnp.asarray(cornell_mesh.indices.astype(np.int64), jnp.int32)
    # ray from box center toward a wall, but tmax too short to reach it
    o = jnp.asarray([[278.0, 274.0, 279.0]], jnp.float32)
    d = jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32)
    rays_short = make_rays(o, d, tmin=1e-4, tmax=10.0)
    rays_long = make_rays(o, d, tmin=1e-4, tmax=5000.0)
    assert not bool(traverse.bvh_any_hit(rays_short, bvh, V, I)[0])
    assert bool(traverse.bvh_any_hit(rays_long, bvh, V, I)[0])


# ---------------------------------------------------------------------------
# Treelet / packet / flat traversal parity (the production 'bvh' paths).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def blob_tb():
    """~1.1k-triangle procedural mesh + treelet BVH with small T to force
    multi-block coverage (advisor finding: the packet subsystem had no
    pytest coverage)."""
    from tracer.accel import treelet
    from tracer.geometry.procedural import bumpy_blob

    mesh = bumpy_blob(24, 24, 1.0, (0.0, 0.0, 0.0))
    binary = lbvh.build(*mesh.bboxes(), max_prims=4)
    tb = treelet.build(binary, mesh.vertices, mesh.indices, T=32)
    treelet.validate(
        np.asarray(tb.top), np.asarray(tb.blocks), mesh.num_triangles
    )
    return mesh, tb


def _mixed_rays(mesh, n=1024, seed=0, tmax=None):
    """Half coherent (shared-origin pinhole cone), half incoherent."""
    rs = np.random.RandomState(seed)
    o1 = np.tile(np.array([[3.0, 0.2, 0.1]], np.float32), (n // 2, 1))
    tgt = rs.randn(n // 2, 3).astype(np.float32) * 0.4
    d1 = tgt - o1
    o2 = rs.randn(n // 2, 3).astype(np.float32) * 3.0
    d2 = rs.randn(n // 2, 3).astype(np.float32)
    o = np.concatenate([o1, o2])
    d = np.concatenate([d1, d2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    kw = {} if tmax is None else {"tmax": tmax}
    return make_rays(jnp.asarray(o), jnp.asarray(d), **kw)


@pytest.mark.parametrize("mod_name", ["packet", "flat"])
def test_treelet_closest_matches_brute(blob_tb, mod_name):
    import importlib

    mesh, tb = blob_tb
    mod = importlib.import_module(f"tracer.accel.{mod_name}")
    rays = _mixed_rays(mesh)
    t_ref, id_ref = mesh_brute_force(
        rays, jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices)
    )
    t, pid = mod.closest_hit(rays, tb)
    np.testing.assert_array_equal(np.asarray(id_ref), np.asarray(pid))
    hit = np.asarray(id_ref) >= 0
    np.testing.assert_allclose(
        np.asarray(t)[hit], np.asarray(t_ref)[hit], rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("mod_name", ["packet", "flat"])
def test_treelet_anyhit_matches_brute(blob_tb, mod_name):
    import importlib

    mesh, tb = blob_tb
    mod = importlib.import_module(f"tracer.accel.{mod_name}")
    # tmax window: occlusion must respect the [tmin, tmax] interval.
    rays = _mixed_rays(mesh, tmax=4.0)
    b_ref = mesh_brute_force_anyhit(
        rays, jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices)
    )
    b = mod.any_hit(rays, tb)
    np.testing.assert_array_equal(np.asarray(b_ref), np.asarray(b))


@pytest.mark.parametrize("mod_name", ["packet", "flat"])
def test_treelet_frame_tiling(blob_tb, mod_name):
    """Frame-shaped wavefront exercises the pixel-tile (packet) /
    super-tile (flat) regrouping incl. edge padding (W, H not multiples
    of the tile sizes)."""
    import importlib

    mesh, tb = blob_tb
    mod = importlib.import_module(f"tracer.accel.{mod_name}")
    W, H = 41, 29  # deliberately unaligned
    u = (np.arange(W) + 0.5) / W - 0.5
    v = 0.5 - (np.arange(H) + 0.5) / H
    uu, vv = np.meshgrid(u, v)
    d = np.stack(
        [uu.ravel(), vv.ravel(), -np.ones(W * H)], -1
    ).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(np.array([[0.1, 0.0, 3.0]], np.float32), (W * H, 1))
    rays = make_rays(jnp.asarray(o), jnp.asarray(d))
    t_ref, id_ref = mesh_brute_force(
        rays, jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices)
    )
    t, pid = mod.closest_hit(rays, tb, frame=(W, H))
    # The matmul-form brute reference rounds its Möller numerators
    # differently than the treelet blocks (identical algebra, different
    # float association), so grazing silhouette lanes may flip hit/miss
    # between the two. Require exact id agreement on all but a <=0.5%
    # borderline set, and on that set require the t's to be consistent
    # (a genuine disagreement would produce far-apart depths).
    id_ref = np.asarray(id_ref)
    pid = np.asarray(pid)
    t_ref = np.asarray(t_ref)
    t = np.asarray(t)
    dis = id_ref != pid
    assert dis.mean() <= 0.005, f"{dis.sum()} of {dis.size} ids differ"
    same = ~dis & (pid >= 0)
    np.testing.assert_allclose(t[same], t_ref[same], rtol=1e-4, atol=1e-4)
    # Every disputed claim must be a genuinely borderline hit: re-test
    # the claimed (ray, triangle) pair with the scalar Möller form and
    # require it within epsilon of the valid region (a wrong id would
    # be far outside, not at the boundary).
    V = np.asarray(mesh.vertices)
    Ix = np.asarray(mesh.indices)
    for lane in np.nonzero(dis)[0]:
        for claimed in (id_ref[lane], pid[lane]):
            if claimed < 0:
                continue
            tri = Ix[claimed]
            sub = make_rays(o[lane:lane + 1], d[lane:lane + 1])
            from tracer.kernels import intersect

            tt, beta, gamma, _ = intersect.triangle_t(
                sub, jnp.asarray(V[tri[0]]), jnp.asarray(V[tri[1]]),
                jnp.asarray(V[tri[2]]),
            )
            b, g = float(beta[0]), float(gamma[0])
            eps = 1e-4
            assert (
                b >= -eps and g >= -eps and b + g <= 1.0 + eps
            ), (lane, int(claimed), b, g)


def test_flat_overflow_rounds(blob_tb):
    """Emission counts above K trigger the id-order sweep rounds."""
    from tracer.accel import flat

    mesh, tb = blob_tb
    rays = _mixed_rays(mesh, n=512, seed=3)
    t_ref, id_ref = mesh_brute_force(
        rays, jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices)
    )
    t, pid, conv = flat._run(rays, tb, None, any_hit=False, K=8)
    assert bool(np.asarray(conv).all())  # sweep covered every block
    np.testing.assert_array_equal(
        np.asarray(id_ref), np.asarray(pid.astype(jnp.int32))
    )


def test_packet_multi_round_pause(blob_tb):
    """Small emission budget forces pause/resume rounds in the packet walk."""
    import tracer.accel.packet as packet

    mesh, tb = blob_tb
    rays = _mixed_rays(mesh, n=256, seed=7)
    t_ref, id_ref = mesh_brute_force(
        rays, jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices)
    )
    orig = packet.K_EMIT
    try:
        packet.K_EMIT = 16  # << treelet count: multiple rounds required
        t, pid = packet.closest_hit(rays, tb)
    finally:
        packet.K_EMIT = orig
    np.testing.assert_array_equal(np.asarray(id_ref), np.asarray(pid))


# ---------------------------------------------------------------------------
# Naive agglomerative BVH (validation builder, reference bvh.rs:68-164).
# ---------------------------------------------------------------------------


def test_agglom_invariants_and_parity(test_object_mesh):
    from tracer.accel import agglom

    mesh = test_object_mesh
    lo, hi = mesh.bboxes()
    bvh = agglom.build(lo, hi, max_prims=4)
    lbvh.validate(bvh, mesh.num_triangles)
    # Same binary traversal must find the same hits as the LBVH.
    rays = _rand_rays(mesh, n=256)
    t_a, id_a = traverse.bvh_closest_hit(
        rays,
        jax.tree.map(jnp.asarray, bvh),
        jnp.asarray(mesh.vertices),
        jnp.asarray(mesh.indices),
        max_leaf=4,
    )
    t_ref, id_ref = mesh_brute_force(
        rays, jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices)
    )
    np.testing.assert_array_equal(np.asarray(id_ref), np.asarray(id_a))


def test_agglom_singleton():
    from tracer.accel import agglom

    lo = np.zeros((1, 3), np.float32)
    hi = np.ones((1, 3), np.float32)
    bvh = agglom.build(lo, hi)
    assert bvh.count[0] == 1
    lbvh.validate(bvh, 1)


def test_truncation_is_loud(blob_tb, monkeypatch):
    """A traversal cut off by its round/iteration cap must be detectable:
    engines return converged=False and the integrator paints the magenta
    error sentinel (the reference's loud-failure philosophy,
    bvh.wgsl:139-148) instead of a silently plausible image."""
    from tracer.accel import flat, wide
    import tracer.accel.wide as wide_mod

    mesh, tb = blob_tb
    rays = _mixed_rays(mesh, n=512, seed=3)

    # flat: force overflow (K=2 emissions) and forbid sweep rounds.
    monkeypatch.setattr(flat, "MAX_ROUNDS", 1)
    t, pid, conv = flat._run(rays, tb, None, any_hit=False, K=2)
    assert not bool(np.asarray(conv).all()), "cap trip must clear converged"

    # wide: iteration budget far below tree size.
    wb = wide_mod.build(
        __import__("tracer.accel.lbvh", fromlist=["x"]).build(
            *mesh.bboxes(), max_prims=4
        ),
        mesh.vertices,
        mesh.indices,
    )
    monkeypatch.setattr(wide_mod, "MAX_ITERS", 2)
    t, pid, conv = wide_mod.closest_hit(rays, wb, with_conv=True)
    assert not bool(np.asarray(conv).all())


def test_truncation_paints_error_sentinel(monkeypatch):
    """Integrator-level detection: with an adversarially tiny traversal
    budget the rendered image shows the magenta sentinel, never a clean
    (wrong) image."""
    import dataclasses

    from tracer.accel import flat
    from tracer.render import integrator as I
    from tracer.scenes import build_scene, get_scene

    desc = get_scene("Project: Utah Teapot")
    desc = dataclasses.replace(
        desc, cfg=dataclasses.replace(desc.cfg, width=16, height=16)
    )
    scene, cfg = build_scene(desc)
    monkeypatch.setattr(flat, "K_EMIT", 1)
    monkeypatch.setattr(flat, "MAX_ROUNDS", 1)
    img = np.asarray(I.render_sample(scene, cfg))
    magenta = np.all(
        np.isclose(img, np.array([0.7, 0.0, 0.7]), atol=1e-6), axis=-1
    )
    assert magenta.any(), "truncated traversal must be loud (magenta)"
