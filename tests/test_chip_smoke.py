"""chip_smoke.py off the card: it refuses to run, and its comparison
helpers accept agreement and reject real disagreement."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as C  # noqa: E402


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_fails_without_gpu(tmp_path, where):
    """No GPU (or no repository beside it): non-zero exit, no result."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _square():
    """Two triangles tiling the unit square at z=0, and rays down -z."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    o = np.array([[0.25, 0.1, 1.0], [0.5, 0.5, 1.0], [0.1, 0.8, 1.0]],
                 np.float32)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (3, 1))
    return verts, idx, o, d


def test_compare_closest_accepts_match_and_edge_disputes():
    verts, idx, o, d = _square()
    ids = np.array([0, 0, 1])
    t = np.ones(3, np.float32)
    assert C.compare_closest(ids, ids, t, t, o, d, verts, idx)["ok"]
    # Lane 1 sits on the shared diagonal: either id is right.
    other = np.array([0, 1, 1])
    s = C.compare_closest(other, ids, t, t, o, d, verts, idx)
    assert s["disputed"] == 1 and not s["not_borderline"]


def test_compare_closest_rejects_wrong_hit():
    verts, idx, o, d = _square()
    ids = np.array([0, 0, 1])
    t = np.ones(3, np.float32)
    wrong = np.array([-1, 0, 1])  # lane 0 hits triangle 0 squarely
    many = np.repeat(np.arange(3), 200)
    s = C.compare_closest(wrong[many], ids[many], t[many], t[many], o[many],
                          d[many], verts, idx)
    assert not s["ok"] and s["not_borderline"]
    far = t.copy()
    far[2] = 1.5
    assert not C.compare_closest(ids, ids, far, t, o, d, verts, idx)["ok"]


def test_close_helpers():
    a = np.array([1.0, 2.0, 3.0])
    assert C.exact(a, a.copy())["ok"]
    assert not C.exact(a, a + 1e-7)["ok"]
    assert C.close_rel(a + 1e-6, a, 1e-5)["ok"]
    assert not C.close_rel(a + 1e-3, a, 1e-5)["ok"]
    tree = {"x": a, "n": np.arange(3)}
    assert C.close_tree(tree, {"x": a * (1 + 1e-6), "n": np.arange(3)},
                        1e-4, 0.0)["ok"]
    assert not C.close_tree(tree, {"x": a * 1.01, "n": np.arange(3)},
                            1e-4, 0.0)["ok"]


def test_compare_depth_accepts_match_and_rejects_wrong_depth():
    verts, idx, o, d = _square()
    ids = np.array([0, 0, 1])
    t = np.ones(3, np.float32)
    assert C.compare_depth(t, ids, ids, t, o, d, verts, idx)["ok"]
    many = np.repeat(np.arange(3), 200)
    missed = np.where(np.arange(3) == 0, 0.0, t)  # lane 0 hits squarely
    s = C.compare_depth(missed[many], ids[many], ids[many], t[many], o[many],
                        d[many], verts, idx)
    assert not s["ok"] and s["not_borderline"]
    assert not C.compare_depth(t * 1.5, ids, ids, t, o, d, verts, idx)["ok"]


@pytest.fixture
def small(monkeypatch):
    """Sample counts scaled to a small CPU frame."""
    monkeypatch.setattr(C, "SAMPLES", 512)
    monkeypatch.setattr(C, "MIN_MIX", 10)
    monkeypatch.setattr(C, "MIN_SECONDARY_HITS", 100)


def test_phase_hits_on_cpu(small):
    """The on-card hit comparisons, run through the CPU's plain-XLA hits
    stage on a small Bunny frame: sampled pixels, overflow sweep, any hit,
    the seeded + repaired pass, the progressive seed and the packet
    engine, each against brute force."""
    from tracer.render import progressive as P

    scene, cfg, _, _ = C.build("Project: Bunny", width=128, height=72)
    state = P.init_state(cfg)
    for _ in range(2):
        state = P.step(scene, cfg, state)
    C.phase_hits(scene, cfg, frame_seed=state.seed_t)


def test_run_four_on_cpu():
    """The ``--four`` phase on four of the virtual CPU devices."""
    C.run_four("cpu", "Project: Bunny", frames=1, width=64, height=32)
