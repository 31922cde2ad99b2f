"""Smoke run of the main path on one NVIDIA GPU (or four with ``--four``).

    python chip_smoke.py          # one card: dragon frame, grad step, checks
    python chip_smoke.py --four   # four cards: sharded frame + grad vs one
    python chip_smoke.py --ab     # one card: end-to-end A/B of the kernels

One card: builds ``Project: Dragon`` (the 869,880-triangle stand-in at
800x450, treelet traversal) through ``build_scene``, renders progressive
frames with ``progressive.step``, takes one ``grad_scene`` step
(``loop="scan"``, ``max_depth=2``), renders the same mesh once in path
mode (packet engine + bounce loop), and compares every kernel of that path
with its plain reference at real widths. Each comparison prints its
measured error beside its tolerance. ``--four`` runs only the sharded
progressive step and the sharded gradient over a 1-D mesh of four cards
and compares them with the same work on one card. ``--ab`` times the
dragon frame with the Triton hits kernel, the plain-XLA hits stage and the
per-ray stack walk, and the grad step with the scatter-add and with
sort + segment_sum.

Fails (exit code 1, no result line) when JAX finds no GPU or any phase
fails. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time
import traceback

import numpy as np

SCENE = "Project: Dragon"
SAMPLES = 4096  # pixels compared with brute force, drawn over the frame
MIN_MIX = 100  # least hits and least misses a compared set must hold
MIN_SECONDARY_HITS = 1000
OVERFLOW_K = 8  # emission budget that forces the overflow sweep
EDGE_EPS = 1e-4  # barycentric slack of a borderline (edge) hit
MIN_ID_MATCH = 0.995


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Comparison helpers (host arrays only; the CPU tests call these too).
# ---------------------------------------------------------------------------


def _bary(o, d, tri):
    """float64 Möller barycentrics (beta, gamma) and t of one ray/triangle."""
    v0, v1, v2 = (np.asarray(v, np.float64) for v in tri)
    o = np.asarray(o, np.float64)
    d = np.asarray(d, np.float64)
    e0, e1 = v1 - v0, v2 - v0
    n = np.cross(e0, e1)
    nom = np.cross(v0 - o, d)
    den = float(np.dot(d, n))
    if den == 0.0:
        return np.inf, np.inf, np.inf
    return (float(np.dot(nom, e1)) / den, -float(np.dot(nom, e0)) / den,
            float(np.dot(v0 - o, n)) / den)


def _borderline(o, d, tri, eps=EDGE_EPS):
    """True iff the ray meets the triangle within ``eps`` of an edge."""
    b, g, _ = _bary(o, d, tri)
    m = min(b, g, 1.0 - b - g)
    return -eps <= m <= eps


def compare_closest(ids, ids_ref, t, t_ref, o, d, verts, idx,
                    rtol=1e-4, atol=1e-4):
    """Closest-hit agreement: ids equal on >= 99.5 % of rays, every
    disputed lane borderline (each claimed triangle is hit within
    ``EDGE_EPS`` of an edge, or both sides claim hits at the same depth),
    t within rtol/atol where ids agree. Returns a stats dict with "ok"."""
    ids, ids_ref = np.asarray(ids), np.asarray(ids_ref)
    t, t_ref = np.asarray(t, np.float64), np.asarray(t_ref, np.float64)
    agree = ids == ids_ref
    frac = float(agree.mean())
    bad_lanes = []
    for lane in np.nonzero(~agree)[0]:
        a, b = int(ids[lane]), int(ids_ref[lane])
        if a >= 0 and b >= 0 and np.isclose(t[lane], t_ref[lane],
                                             rtol=rtol, atol=atol):
            continue  # coincident surfaces: same depth, either id is right
        claims = [c for c in (a, b) if c >= 0]
        if not all(_borderline(o[lane], d[lane], verts[idx[c]])
                   for c in claims):
            bad_lanes.append(int(lane))
    hit = agree & (ids >= 0)
    terr = np.abs(t[hit] - t_ref[hit])
    tol = atol + rtol * np.abs(t_ref[hit])
    t_ok = bool(np.all(terr <= tol))
    rel = float(np.max(terr / tol)) if terr.size else 0.0
    return dict(
        ok=bool(frac >= MIN_ID_MATCH and not bad_lanes and t_ok),
        id_match=frac, disputed=int((~agree).sum()),
        not_borderline=bad_lanes[:8], t_err_over_tol=rel,
        hit_frac=float((ids >= 0).mean()),
        hit_frac_ref=float((ids_ref >= 0).mean()),
    )


def compare_anyhit(blocked, blocked_ref, claim_ids, ref_ids, o, d, verts,
                   idx):
    """Any-hit agreement: >= 99.5 % equal, and each disputed lane's claimed
    occluder (``claim_ids``/``ref_ids``: the closest hit inside the same
    window, as each side sees it) is a borderline hit."""
    blocked, blocked_ref = np.asarray(blocked), np.asarray(blocked_ref)
    agree = blocked == blocked_ref
    bad = []
    for lane in np.nonzero(~agree)[0]:
        c = int(claim_ids[lane] if blocked[lane] else ref_ids[lane])
        if c < 0 or not _borderline(o[lane], d[lane], verts[idx[c]]):
            bad.append(int(lane))
    frac = float(agree.mean())
    return dict(ok=bool(frac >= MIN_ID_MATCH and not bad), match=frac,
                disputed=int((~agree).sum()), not_borderline=bad[:8],
                blocked_frac=float(blocked.mean()),
                blocked_frac_ref=float(blocked_ref.mean()))


def compare_depth(t_seed, claim_ids, ids_ref, t_ref, o, d, verts, idx,
                  rtol=1e-4, atol=1e-4):
    """A depth map (``t_seed``: hit distance, 0 on a miss) against brute
    force: hit/miss equal on >= 99.5 % of rays, every disputed lane
    borderline (the reference's triangle, or ``claim_ids``' where only the
    depth map hits), t within rtol/atol where both hit."""
    t_seed = np.asarray(t_seed, np.float64)
    t_ref = np.asarray(t_ref, np.float64)
    hit, hit_ref = t_seed > 0.0, np.asarray(ids_ref) >= 0
    agree = hit == hit_ref
    bad = []
    for lane in np.nonzero(~agree)[0]:
        c = int(ids_ref[lane] if hit_ref[lane] else claim_ids[lane])
        if c < 0 or not _borderline(o[lane], d[lane], verts[idx[c]]):
            bad.append(int(lane))
    both = hit & hit_ref
    terr = np.abs(t_seed[both] - t_ref[both])
    tol = atol + rtol * np.abs(t_ref[both])
    frac = float(agree.mean())
    return dict(
        ok=bool(frac >= MIN_ID_MATCH and not bad and np.all(terr <= tol)),
        match=frac, disputed=int((~agree).sum()), not_borderline=bad[:8],
        t_err_over_tol=float(np.max(terr / tol)) if terr.size else 0.0,
        hits=int(hit.sum()), hits_ref=int(hit_ref.sum()),
    )


def compare_scatter(out, idx, g, V):
    """(V, 6) scatter-add against a float64 ``np.add.at`` of the same
    rows: rtol 1e-5, atol 1e-6 * max|g| (f32 sums in any order)."""
    ref = np.zeros((V, 6), np.float64)
    np.add.at(ref, np.asarray(idx).reshape(-1),
              np.asarray(g, np.float64).reshape(-1, 6))
    out = np.asarray(out, np.float64)
    atol = 1e-6 * float(np.max(np.abs(g)))
    err = np.abs(out - ref)
    tol = atol + 1e-5 * np.abs(ref)
    return dict(ok=bool(np.all(err <= tol)),
                err_over_tol=float(np.max(err / tol)),
                max_abs_err=float(err.max()), atol=atol)


def exact(a, b):
    """Bit-for-bit equality of two float arrays (stats dict)."""
    a, b = np.asarray(a), np.asarray(b)
    return dict(ok=bool(np.array_equal(a, b)),
                max_abs_diff=float(np.max(np.abs(a - b))) if a.size else 0.0)


def close_rel(a, b, rel):
    """max|a - b| <= rel * max|b| (stats dict)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    diff = float(np.max(np.abs(a - b))) if a.size else 0.0
    return dict(ok=bool(diff <= rel * scale), max_abs_diff=diff,
                limit=rel * scale)


def close_tree(a, b, rtol, atol_rel):
    """Leafwise allclose(rtol, atol = atol_rel * max|leaf|) over the float
    leaves of two pytrees (stats dict with the worst leaf)."""
    import jax

    worst, worst_r = "", 0.0
    ok = True
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree.leaves(b)
    for (path, x), y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype.kind != "f" or x.size == 0:
            continue
        x, y = x.astype(np.float64), y.astype(np.float64)
        tol = rtol * np.abs(y) + atol_rel * float(np.max(np.abs(y)))
        r = float(np.max(np.abs(x - y) / np.maximum(tol, 1e-300)))
        if r > worst_r:
            worst, worst_r = jax.tree_util.keystr(path), r
        ok &= bool(np.all(np.abs(x - y) <= tol))
    return dict(ok=ok, worst_leaf=worst, worst_err_over_tol=worst_r)


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------


class PhaseFailed(RuntimeError):
    pass


def report(name, stats, tol_text):
    log(f"[check] {name}: {json.dumps(stats)} (tolerance: {tol_text})")
    if not stats["ok"]:
        raise PhaseFailed(f"{name} out of tolerance")


def require_gpu():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}"
        )
    return devs


def card_line():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def build(scene_name=SCENE, **cfg_kw):
    import jax

    from tracer.scenes import build_scene, get_scene

    desc = get_scene(scene_name)
    if cfg_kw:
        desc = dataclasses.replace(
            desc, cfg=dataclasses.replace(desc.cfg, **cfg_kw)
        )
    timings = {}
    t0 = time.perf_counter()
    scene, cfg = build_scene(desc, timings=timings)
    jax.block_until_ready(scene)
    return scene, cfg, time.perf_counter() - t0, timings


def memory_line(name, compiled):
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    log(f"[memory] {name}: " + ", ".join(
        f"{f}={getattr(ma, f, None)}" for f in fields))


def phase_frames(scene, cfg, card, frames=5):
    import jax

    from tracer.render import progressive as P

    state = P.init_state(cfg)
    t0 = time.perf_counter()
    state = P.step(scene, cfg, state)
    jax.block_until_ready(state)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(frames):
        state = P.step(scene, cfg, state)
    jax.block_until_ready(state)
    ms = (time.perf_counter() - t0) / frames * 1e3
    log(f"[time] first frame (compile + run): {first:.3f} s [{card}]")
    log(f"[time] frame: {ms:.3f} ms/frame over {frames} frames "
        f"({cfg.width}x{cfg.height}) [{card}]")
    memory_line("progressive.step",
                P.step.lower(scene, cfg, P.init_state(cfg)).compile())
    acc = np.asarray(state.accum)
    report("frame finite", dict(ok=bool(np.isfinite(acc).all()),
                                shape=list(acc.shape)), "all finite")
    return acc, np.asarray(state.seed_t)


def grad_cfg(cfg):
    return dataclasses.replace(cfg, loop="scan", max_depth=2)


def phase_grad(scene, cfg, card, reps=3):
    import jax
    import jax.numpy as jnp

    from tracer.diff import grad as G

    gcfg = grad_cfg(cfg)
    target = jnp.zeros((cfg.height * cfg.width, 3), jnp.float32)
    t0 = time.perf_counter()
    g1 = G.grad_scene(scene, gcfg, target)
    jax.block_until_ready(g1)
    log(f"[time] first grad step (compile + run): "
        f"{time.perf_counter() - t0:.3f} s [{card}]")
    t0 = time.perf_counter()
    for _ in range(reps):
        g = G.grad_scene(scene, gcfg, target)
    jax.block_until_ready(g)
    log(f"[time] grad step: {(time.perf_counter() - t0) / reps * 1e3:.3f} ms "
        f"[{card}]")
    memory_line("grad_scene", G.grad_scene.lower(scene, gcfg, target).compile())
    leaves = [np.asarray(x) for x in jax.tree.leaves(g)
              if np.asarray(x).dtype.kind == "f"]
    report("grad finite", dict(ok=all(np.isfinite(x).all() for x in leaves)),
           "all finite")
    gv = np.asarray(g.geom.vertices)
    report("vertex gradient nonzero",
           dict(ok=bool(np.abs(gv).sum() > 0), abs_sum=float(np.abs(gv).sum())),
           "> 0")
    det = {k: exact(getattr(getattr(g1, k[0]), k[1]),
                    getattr(getattr(g, k[0]), k[1]))
           for k in (("geom", "vertices"), ("geom", "normals"),
                     ("materials", "diffuse"), ("camera", "eye"))}
    log("[info] grad run-to-run bit-identical: " + json.dumps(
        {f"{a}.{b}": v["ok"] for (a, b), v in det.items()})
        + " max abs diff: " + json.dumps(
        {f"{a}.{b}": v["max_abs_diff"] for (a, b), v in det.items()}))
    return g


def frame_rays(scene, cfg, camera=None):
    """The full frame's primary rays exactly as ``render_sample`` makes
    them for its last stratified sub-sample (row-major, H*W lanes)."""
    import jax.numpy as jnp

    from tracer.kernels.intersect import Rays
    from tracer.render.camera import camera_rays, pixel_uv

    u, v = pixel_uv(cfg.width, cfg.height)
    n = cfg.width * cfg.height
    jit = (jnp.zeros((1, 2), jnp.float32) if scene.jitters is None
           else scene.jitters)[-1]
    r = camera_rays(scene.camera if camera is None else camera, u, v,
                    jnp.broadcast_to(jit, (n, 2)))
    return Rays(r.o, r.d, jnp.full(n, cfg.eta, jnp.float32),
                jnp.full(n, cfg.tmax, jnp.float32))


def sample_lanes(cfg, seed=0):
    """``SAMPLES`` distinct pixels drawn uniformly over the whole frame."""
    n, count = cfg.width * cfg.height, SAMPLES
    return np.sort(np.random.RandomState(seed).choice(n, count, replace=False))


def take(rays, lanes):
    import jax

    return jax.tree.map(lambda x: x[lanes], rays)


def require_mix(name, hits, total, least):
    """Both hits and misses in a compared set (else the check is vacuous)."""
    report(f"{name}: hits and misses present",
           dict(ok=bool(least <= hits <= total - least), hits=int(hits),
                misses=int(total - hits)), f">= {least} of each")


def phase_hits(scene, cfg, frame_seed=None):
    """Flat engine (closest hit, any hit, the overflow sweep, the seeded
    and repaired pass) on 4,096 pixels sampled over the whole frame, taken
    from full-frame calls in the frame layout, and the packet engine on
    4,096 incoherent secondary rays, each against brute force over the
    full mesh. ``frame_seed``: the seed (hit depth) the timed progressive
    frames left, checked against brute force on the same pixels."""
    import jax
    import jax.numpy as jnp

    from tracer.accel import flat, packet
    from tracer.kernels import intersect
    from tracer.kernels.intersect import Rays

    V = scene.geom.vertices
    I = scene.geom.indices
    Vh, Ih = np.asarray(V), np.asarray(I)
    tb = scene.tb
    frame = (cfg.width, cfg.height)
    rays = frame_rays(scene, cfg)
    lanes = sample_lanes(cfg)
    srays = take(rays, lanes)
    o, d = np.asarray(srays.o), np.asarray(srays.d)
    brute = jax.jit(intersect.mesh_brute_force)
    brute_any = jax.jit(intersect.mesh_brute_force_anyhit)
    closest = jax.jit(flat.closest_hit, static_argnames=("frame",))
    tol_text = ("ids equal >= 99.5%, disputed lanes borderline (1e-4), "
                "t rtol 1e-4 atol 1e-4")

    t_f, ids_f = closest(rays, tb, frame=frame)
    t_f, ids_f = np.asarray(t_f), np.asarray(ids_f)
    t_ref, ids_ref = (np.asarray(x) for x in brute(srays, V, I))
    report(f"flat closest hit vs mesh_brute_force ({SAMPLES} pixels over "
           "the frame)",
           compare_closest(ids_f[lanes], ids_ref, t_f[lanes], t_ref, o, d,
                           Vh, Ih), tol_text)
    hit_ref = ids_ref >= 0
    require_mix("sampled primary rays", hit_ref.sum(), SAMPLES, MIN_MIX)
    report("hit fraction equals brute force (sampled pixels)",
           dict(ok=bool((ids_f[lanes] >= 0).mean() == hit_ref.mean()),
                hit_frac=float((ids_f[lanes] >= 0).mean()),
                hit_frac_ref=float(hit_ref.mean())), "equal")

    # The overflow sweep: a budget of OVERFLOW_K blocks per super-tile
    # sends every covered super-tile through the id-ordered sweep.
    bt, bp, conv = jax.jit(partial_run, static_argnames=("frame", "K"))(
        rays, tb, frame=frame, K=OVERFLOW_K)
    ids_o = np.asarray(bp).astype(np.int32)
    t_o = np.where(ids_o >= 0, np.asarray(bt), cfg.tmax)
    report(f"flat closest hit, overflow sweep (K={OVERFLOW_K}) vs "
           "mesh_brute_force",
           compare_closest(ids_o[lanes], ids_ref, t_o[lanes], t_ref, o, d,
                           Vh, Ih), tol_text)
    report("overflow sweep converged on every ray",
           dict(ok=bool(np.asarray(conv).all())), "all converged")

    # Any hit with a tmax window cutting through the mesh's depth range,
    # placed in the widest gap between the middle sampled hit depths so no
    # compared lane sits on the window's edge.
    ts = np.sort(t_ref[hit_ref])
    lo, hi = len(ts) * 2 // 5, len(ts) * 3 // 5
    j = lo + int(np.argmax(np.diff(ts[lo:hi + 1])))
    tmax = float((ts[j] + ts[j + 1]) / 2)
    log(f"[info] any-hit window: tmax {tmax:.6g}, nearest sampled hit depth "
        f"{(ts[j + 1] - ts[j]) / 2:.3g} away")
    wrays = Rays(rays.o, rays.d, rays.tmin, jnp.full_like(rays.tmax, tmax))
    ws = take(wrays, lanes)
    b = np.asarray(jax.jit(flat.any_hit, static_argnames=("frame",))(
        wrays, tb, frame=frame))[lanes]
    b_ref = np.asarray(brute_any(ws, V, I))
    _, cid = closest(wrays, tb, frame=frame)
    _, rid = brute(ws, V, I)
    report("flat any hit vs mesh_brute_force_anyhit (tmax window)",
           compare_anyhit(b, b_ref, np.asarray(cid)[lanes], np.asarray(rid),
                          o, d, Vh, Ih),
           ">= 99.5% equal, disputed lanes borderline (1e-4)")
    require_mix("any-hit window", b_ref.sum(), SAMPLES, MIN_MIX)

    # Seeded pass + repair: seed with this frame's depths, then trace the
    # frame from a camera dollied out by 5 %, so most hit lanes' true hits
    # lie beyond their seed bound and need the repair pass.
    seed = np.where(ids_f >= 0, t_f, 0.0).astype(np.float32)
    cam = scene.camera
    moved = type(cam)(eye=cam.target + (cam.eye - cam.target) * 1.05,
                      target=cam.target, up=cam.up, constant=cam.constant,
                      aspect=cam.aspect)
    mrays = frame_rays(scene, cfg, moved)
    ms = take(mrays, lanes)
    t_m, ids_m = closest(mrays, tb, frame=frame, seed_t=jnp.asarray(seed))
    mt_ref, mid_ref = (np.asarray(x) for x in brute(ms, V, I))
    bound = seed[lanes] * flat.SEED_REL + flat.SEED_ABS
    repaired = (seed[lanes] > 0) & ~((mid_ref >= 0) & (mt_ref <= bound))
    report("seeded + repaired closest hit (camera dollied out 5%) vs "
           "mesh_brute_force",
           compare_closest(np.asarray(ids_m)[lanes], mid_ref,
                           np.asarray(t_m)[lanes], mt_ref, np.asarray(ms.o),
                           np.asarray(ms.d), Vh, Ih), tol_text)
    report("seeded pass: lanes that needed the repair pass",
           dict(ok=bool(repaired.sum() >= MIN_MIX),
                repaired=int(repaired.sum())), f">= {MIN_MIX}")

    if frame_seed is not None:
        report("seeded progressive frames' depth vs mesh_brute_force",
               compare_depth(np.asarray(frame_seed)[lanes], ids_f[lanes],
                             ids_ref, t_ref, o, d, Vh, Ih),
               "hit/miss equal >= 99.5%, disputed lanes borderline (1e-4), "
               "t rtol 1e-4 atol 1e-4")

    # Packet engine on incoherent secondary rays: half cosine bounces off
    # sampled primary hits (mostly escaping the convex-ish mesh), half rays
    # from a shell around the mesh aimed at jittered surface points (mostly
    # hitting, many at grazing angles).
    rs = np.random.RandomState(0)
    hit = np.nonzero(hit_ref)[0]
    half = SAMPLES // 2
    src = rs.choice(hit, size=half, replace=True)
    p = o[src] + t_ref[src, None] * d[src]
    tri = Vh[Ih[ids_ref[src]]]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm *= -np.sign(np.sum(nrm * d[src], axis=1, keepdims=True))
    w = rs.randn(half, 3)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    w = nrm + w  # cosine-distributed about the facing normal
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    bo = p + nrm * 1e-4
    centre = Vh.mean(axis=0)
    radius = float(np.max(np.linalg.norm(Vh - centre, axis=1)))
    aim = Vh[Ih[rs.randint(0, Ih.shape[0], half)]].mean(axis=1)
    aim += rs.randn(half, 3) * 0.02 * radius
    start = rs.randn(half, 3)
    start = centre + start / np.linalg.norm(start, axis=1, keepdims=True) * (
        radius * rs.uniform(1.5, 4.0, (half, 1)))
    sd = aim - start
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    sec = intersect.make_rays(
        jnp.asarray(np.concatenate([bo, start]), jnp.float32),
        jnp.asarray(np.concatenate([w, sd]), jnp.float32),
        tmin=cfg.eta, tmax=cfg.tmax)
    st, sid = jax.jit(packet.closest_hit)(sec, tb)
    st_ref, sid_ref = brute(sec, V, I)
    report(f"packet closest hit vs mesh_brute_force ({SAMPLES} secondary "
           "rays)",
           compare_closest(sid, sid_ref, st, st_ref, np.asarray(sec.o),
                           np.asarray(sec.d), Vh, Ih), tol_text)
    require_mix("secondary rays", int((np.asarray(sid_ref) >= 0).sum()),
                SAMPLES, MIN_SECONDARY_HITS)


def partial_run(rays, tb, frame, K):
    """``flat._run`` (closest hit) at an emission budget of ``K``."""
    from tracer.accel import flat

    return flat._run(rays, tb, frame, any_hit=False, K=K)


def capture_dispatch(scene, cfg):
    """Run the flat engine's emission prep for the full primary frame
    eagerly and return the arguments of its first hits-stage dispatch."""
    import jax.numpy as jnp

    from tracer.accel import flat
    from tracer.kernels.intersect import Rays
    from tracer.render.camera import camera_rays, pixel_uv

    u, v = pixel_uv(cfg.width, cfg.height)
    r = camera_rays(scene.camera, u, v)
    n = cfg.width * cfg.height
    rays = Rays(r.o, r.d, jnp.full(n, cfg.eta, jnp.float32),
                jnp.full(n, cfg.tmax, jnp.float32))
    box = []
    orig = flat._dispatch

    def spy(*args):
        if not box:
            box.append(args)
        return orig(*args)

    flat._dispatch = spy
    try:
        flat._run(rays, scene.tb, (cfg.width, cfg.height), any_hit=False)
    finally:
        flat._dispatch = orig
    return box[0]


def phase_kernel(scene, cfg, card):
    """The Triton hits kernel against the plain-XLA form on the full
    frame's first emission round."""
    import jax

    from tracer.accel import flat
    from tracer.kernels import super_hits

    tb, eids, enear, en, gm, o, d, tmin, bt, bp, any_hit = capture_dispatch(
        scene, cfg)
    kern = jax.jit(functools.partial(super_hits.hits, any_hit=False))
    xla = jax.jit(functools.partial(flat._phase_b_xla_q, any_hit=False))
    out = {}
    for name, fn, args in (
        ("kernel", kern, (tb, eids, enear, en, gm, o, d, tmin, bt, bp)),
        ("xla", xla, (tb, eids, en, o, d, tmin, bt, bp)),
    ):
        res = jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        for _ in range(5):
            res = fn(*args)
        jax.block_until_ready(res)
        log(f"[time] hits stage, full frame, {name}: "
            f"{(time.perf_counter() - t0) / 5 * 1e3:.3f} ms [{card}]")
        out[name] = res
    (tk, pk), (tx, px) = out["kernel"], out["xla"]
    Vh = np.asarray(scene.geom.vertices)
    Ih = np.asarray(scene.geom.indices)
    report("hits kernel vs _phase_b_xla_q (full frame)",
           compare_closest(np.asarray(pk).reshape(-1).astype(np.int32),
                           np.asarray(px).reshape(-1).astype(np.int32),
                           tk.reshape(-1), tx.reshape(-1),
                           np.asarray(o).reshape(-1, 3),
                           np.asarray(d).reshape(-1, 3), Vh, Ih,
                           rtol=1e-5, atol=0.0),
           "ids equal except borderline lanes, t rtol 1e-5")


def capture_cotangents(scene, gcfg, target):
    """(corner ids, corner cotangents) that the dragon grad step hands to
    the vertex scatter-add, read back through a host callback."""
    import jax

    from tracer.diff import grad as G
    from tracer.geometry import device

    box = []
    orig = device.scatter_add_vn

    def spy(idx_n, gvn, V, dtype):
        jax.debug.callback(
            lambda i, g: box.append((np.asarray(i), np.asarray(g))),
            idx_n, gvn,
        )
        return orig(idx_n, gvn, V, dtype)

    device.scatter_add_vn = spy
    try:
        g = jax.jit(lambda s, t: jax.grad(
            lambda ss: G.l2_loss(ss, gcfg, t), allow_int=True)(s)
        )(scene, target)
        jax.block_until_ready(g)
    finally:
        device.scatter_add_vn = orig
    return max(box, key=lambda b: np.count_nonzero(b[1]))


def phase_scatter_and_fetch(scene, cfg):
    import jax
    import jax.numpy as jnp

    from tracer.geometry import device
    from tracer.render.integrator import onehot_rows

    target = jnp.zeros((cfg.height * cfg.width, 3), jnp.float32)
    idx, g = capture_cotangents(scene, grad_cfg(cfg), target)
    V = int(scene.geom.vertices.shape[0])
    out = jax.jit(device.scatter_add_vn, static_argnums=(2, 3))(
        jnp.asarray(idx), jnp.asarray(g), V, jnp.float32)
    stats = compare_scatter(out, idx, g, V)
    stats["rows"] = int(np.asarray(idx).size)
    report("vertex-cotangent scatter-add vs float64 np.add.at", stats,
           "rtol 1e-5, atol 1e-6*max|g|")

    # One-hot fetch at HIGHEST against the plain gather, on real rows.
    T = int(scene.geom.indices.shape[0])
    ids = jnp.asarray(np.random.RandomState(1).randint(0, 512, 8192),
                      jnp.int32)
    table = scene.geom.tri_table[T // 2: T // 2 + 512]
    got = jax.jit(onehot_rows)(ids, table)
    report("one-hot fetch vs gather (512 triangle rows)",
           exact(got, table[ids]), "bit-exact")


def phase_path(scene, cfg, card, frames=2):
    import jax

    from tracer.render import progressive as P

    pcfg = dataclasses.replace(cfg, mode="path", max_depth=3)
    state = P.init_state(pcfg)
    t0 = time.perf_counter()
    state = P.step(scene, pcfg, state)
    jax.block_until_ready(state)
    log(f"[time] path mode first frame (compile + run): "
        f"{time.perf_counter() - t0:.3f} s [{card}]")
    t0 = time.perf_counter()
    for _ in range(frames):
        state = P.step(scene, pcfg, state)
    jax.block_until_ready(state)
    log(f"[time] path mode (depth 3, packet engine): "
        f"{(time.perf_counter() - t0) / frames * 1e3:.3f} ms/frame [{card}]")
    acc = np.asarray(state.accum)
    report("path-mode frame finite", dict(ok=bool(np.isfinite(acc).all())),
           "all finite")


def run_one(card):
    scene, cfg, secs, timings = build()
    log(f"[time] scene build: {secs:.3f} s (" + ", ".join(
        f"{k}={v:.3f}" for k, v in timings.items()) + f") [{card}]")
    log(f"[info] {SCENE}: {int(scene.geom.indices.shape[0])} triangles, "
        f"{cfg.width}x{cfg.height}, traversal {cfg.traversal}")
    _, seed = phase_frames(scene, cfg, card)
    phase_grad(scene, cfg, card)
    phase_hits(scene, cfg, frame_seed=seed)
    phase_kernel(scene, cfg, card)
    phase_scatter_and_fetch(scene, cfg)
    phase_path(scene, cfg, card)


def timed(fn, reps):
    """ms per call of ``fn()`` over ``reps`` calls, after one warm call."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3, out


def frame_ms(scene, cfg, reps):
    """ms/frame of ``progressive.step`` (from a state one frame in) and
    the accumulator after the timed frames."""
    from tracer.render import progressive as P

    box = [P.step(scene, cfg, P.init_state(cfg))]

    def one():
        box[0] = P.step(scene, cfg, box[0])
        return box[0]

    ms, state = timed(one, reps)
    return ms, np.asarray(state.accum)


def scatter_sorted(idx_n, gvn, V, dtype):
    """Vertex-cotangent placement as sort + ``segment_sum`` (the A/B
    alternative to the scatter-add of ``device.scatter_add_vn``)."""
    import jax
    import jax.numpy as jnp

    fi = idx_n.reshape(-1).astype(jnp.int32)
    fg = gvn.reshape(-1, 6)
    s = jax.lax.sort([fi] + [fg[:, j] for j in range(6)], num_keys=1)
    return jax.ops.segment_sum(jnp.stack(s[1:], -1), s[0], num_segments=V,
                               indices_are_sorted=True).astype(dtype)


def run_ab(card, scene_name=SCENE, **cfg_kw):
    """End-to-end A/B of the kernel decisions on the dragon: the frame with
    the Triton hits kernel, with the plain-XLA hits stage and with the
    per-ray stack walk (``bvh2``); the grad step with the scatter-add and
    with sort + segment_sum. Also the work of one card of a four-card mesh
    (each band alone) and the unseeded frame."""
    import jax
    import jax.numpy as jnp

    from tracer.accel import flat
    from tracer.diff import grad as G
    from tracer.geometry import device

    scene, cfg, _, _ = build(scene_name, **cfg_kw)
    ms_k, acc_k = frame_ms(scene, cfg, 20)
    log(f"[ab] frame, Triton hits kernel: {ms_k:.3f} ms/frame [{card}]")
    kernel_dispatch = flat._dispatch
    flat._dispatch = (lambda tb, eids, enear, en, gm, o, d, tmin, bt, bp,
                      any_hit: flat._phase_b_xla_q(tb, eids, en, o, d, tmin,
                                                   bt, bp, any_hit))
    jax.clear_caches()
    try:
        ms_x, acc_x = frame_ms(scene, cfg, 3)
    finally:
        flat._dispatch = kernel_dispatch
        jax.clear_caches()
    log(f"[ab] frame, plain-XLA hits stage: {ms_x:.3f} ms/frame [{card}]")
    report("A/B frames agree (kernel vs XLA form)",
           close_rel(acc_k, acc_x, 1e-5), "max abs diff <= 1e-5 * max")
    # What one card of a four-card mesh runs: each band of rows alone,
    # seeded by its own previous frame; and the whole frame unseeded.
    from tracer.parallel.shard import band_rows
    from tracer.render import integrator

    rows = band_rows(cfg.height, 4)
    for b in range(4):
        f = jax.jit(lambda s, seed, b=b: integrator.render_sample_seeded(
            s, cfg, seed, (b * rows, rows)))
        seed = f(scene, jnp.zeros(rows * cfg.width, jnp.float32))[1]
        ms, _ = timed(lambda: f(scene, seed), 10)
        log(f"[ab] band {b} of 4 ({rows} rows from row {b * rows}), seeded, "
            f"alone: {ms:.3f} ms [{card}]")
    plain = jax.jit(lambda s: integrator.render_sample(s, cfg))
    ms, _ = timed(lambda: plain(scene), 10)
    log(f"[ab] frame unseeded (render_sample): {ms:.3f} ms [{card}]")

    s2, c2, _, _ = build(scene_name, **dict(cfg_kw, traversal="bvh2"))
    ms_b, acc_b = frame_ms(s2, c2, 3)
    log(f"[ab] frame, per-ray stack walk (bvh2): {ms_b:.3f} ms/frame "
        f"[{card}]")
    report("A/B frames agree (kernel vs bvh2)", close_rel(acc_k, acc_b, 1e-4),
           "max abs diff <= 1e-4 * max")

    gcfg = grad_cfg(cfg)
    target = jnp.zeros((cfg.height * cfg.width, 3), jnp.float32)
    ms_a, g_a = timed(lambda: G.grad_scene(scene, gcfg, target), 5)
    log(f"[ab] grad step, scatter-add: {ms_a:.3f} ms [{card}]")
    scatter_add = device.scatter_add_vn
    device.scatter_add_vn = scatter_sorted
    jax.clear_caches()
    try:
        ms_s, g_s = timed(lambda: G.grad_scene(scene, gcfg, target), 5)
    finally:
        device.scatter_add_vn = scatter_add
        jax.clear_caches()
    log(f"[ab] grad step, sort + segment_sum: {ms_s:.3f} ms [{card}]")
    report("A/B gradients agree (scatter-add vs sort)",
           close_tree(g_a, g_s, 1e-4, 1e-6), "rtol 1e-4, atol 1e-6*max|leaf|")
    idx, g = capture_cotangents(scene, gcfg, target)
    V = int(scene.geom.vertices.shape[0])
    idx, g = jnp.asarray(idx), jnp.asarray(g)
    for name, fn in (("scatter-add", scatter_add),
                     ("sort + segment_sum", scatter_sorted)):
        f = jax.jit(fn, static_argnums=(2, 3))
        ms, _ = timed(lambda: f(idx, g, V, jnp.float32), 20)
        log(f"[ab] vertex-cotangent placement alone, {name}: {ms:.4f} ms, "
            f"{int(idx.size)} rows [{card}]")


def hlo_line(name, compiled):
    """Collective census of a compiled program, and whether the Triton
    hits kernel is in it."""
    from tracer.parallel.shard import collective_census

    txt = compiled.as_text()
    log(f"[hlo] {name}: {json.dumps(collective_census(txt))}, "
        f"flat_hits kernel present: {'flat_hits' in txt}")


def run_four(card, scene_name=SCENE, frames=10, **cfg_kw):
    """Sharded progressive step and sharded gradient over four cards,
    against the same work on one card."""
    import jax
    import jax.numpy as jnp

    from tracer.diff import grad as G
    from tracer.parallel import shard as S
    from tracer.render import progressive as P

    devs = jax.devices()
    if len(devs) < 4:
        raise PhaseFailed(f"--four needs 4 devices, found {len(devs)}")
    mesh = S.make_ray_mesh(devs[:4])
    scene, cfg, secs, _ = build(scene_name, **cfg_kw)
    log(f"[time] scene build: {secs:.3f} s [{card}]")

    single = P.render_progressive(scene, cfg, 1)
    t0 = time.perf_counter()
    single = P.render_progressive(scene, cfg, frames + 1, state=single)
    jax.block_until_ready(single)
    log(f"[time] one-card frame: "
        f"{(time.perf_counter() - t0) / frames * 1e3:.3f} ms/frame [{card}]")
    single_acc = np.asarray(single.accum)
    scene_r = S.replicate_scene(scene, mesh)
    rep = [x.sharding.is_fully_replicated and len(x.sharding.device_set) == 4
           for x in jax.tree.leaves(scene_r)]
    report("scene buffers replicated on all 4 cards",
           dict(ok=all(rep), leaves=len(rep)), "every leaf on 4 devices")
    step = S.sharded_step(mesh)
    state = S.shard_state(P.init_state(cfg), cfg, mesh)
    hlo_line("sharded step", step.lower(scene_r, cfg, state).compile())
    t0 = time.perf_counter()
    state = step(scene_r, cfg, state)
    jax.block_until_ready(state)
    log(f"[time] sharded first frame (compile + run): "
        f"{time.perf_counter() - t0:.3f} s [{card} x4]")
    t0 = time.perf_counter()
    for _ in range(frames):
        state = step(scene_r, cfg, state)
    jax.block_until_ready(state)
    log(f"[time] sharded frame: "
        f"{(time.perf_counter() - t0) / frames * 1e3:.3f} ms/frame "
        f"[{card} x4]")
    report("sharded step compiled once over the timed frames",
           dict(ok=step._cache_size() == 1, programs=step._cache_size()),
           "1 program")
    report("accum sharded over 4 cards",
           dict(ok=len(state.accum.sharding.device_set) == 4
                and not state.accum.sharding.is_fully_replicated),
           "rows split over 4 devices")
    n = cfg.width * cfg.height
    report("sharded accum vs one card",
           close_rel(np.asarray(state.accum)[:n], single_acc, 1e-5),
           "max abs diff <= 1e-5 * max")

    gcfg = grad_cfg(cfg)
    target = jnp.zeros((n, 3), jnp.float32)
    g1 = G.grad_scene(scene, gcfg, target)
    target_r = S.shard_rows(target, cfg, mesh)
    grad = S.sharded_grad(mesh)
    hlo_line("sharded grad", grad.lower(scene_r, gcfg, target_r).compile())
    t0 = time.perf_counter()
    g4 = grad(scene_r, gcfg, target_r)
    jax.block_until_ready(g4)
    log(f"[time] sharded first grad step (compile + run): "
        f"{time.perf_counter() - t0:.3f} s [{card} x4]")
    for name, fn, args in (("one-card", G.grad_scene, (scene, gcfg, target)),
                           ("sharded", grad, (scene_r, gcfg, target_r))):
        jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        for _ in range(3):
            out = fn(*args)
        jax.block_until_ready(out)
        log(f"[time] {name} grad step: "
            f"{(time.perf_counter() - t0) / 3 * 1e3:.3f} ms [{card}"
            f"{' x4' if name == 'sharded' else ''}]")
    report("sharded gradient vs one card", close_tree(g4, g1, 1e-4, 1e-6),
           "rtol 1e-4, atol 1e-6*max|leaf| (psum order plus atomics)")
    per_dev = {d: 0 for d in devs[:4]}
    for x in jax.tree.leaves(scene_r):
        for sh in x.addressable_shards:
            per_dev[sh.device] += sh.data.nbytes
    scene_bytes = sum(x.nbytes for x in jax.tree.leaves(scene))
    report("every card holds a full copy of the scene",
           dict(ok=all(v == scene_bytes for v in per_dev.values()),
                bytes_per_card=list(per_dev.values()),
                scene_bytes=scene_bytes), "each card's shards = scene bytes")
    log("[info] bytes in use per card: " + json.dumps(
        [(d.memory_stats() or {}).get("bytes_in_use") for d in devs[:4]]))


def main(argv):
    four, ab = "--four" in argv, "--ab" in argv
    devs = require_gpu()
    card = card_line()
    log(f"[card] {card}")
    log(f"[info] jax {__import__('jax').__version__}, "
        f"{devs[0].platform} {devs[0].device_kind} x{len(devs)}")
    try:
        (run_four if four else run_ab if ab else run_one)(card)
    except Exception:
        traceback.print_exc()
        log("[fail] a phase failed")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": 4 if four else len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
