"""Benchmark: primary-ray throughput and gradient step on the dragon.

Reference headline (BASELINE.md): dragon 800x450, Lambertian, BVH traversal,
~7.78-8.40 ms/frame on the journal's laptop GPU = ~43-46 M primary rays/s at
1 spp. This bench renders the same scene shape (dragon stand-in mesh, 870k
triangles, project.wgsl-equivalent config) on one GPU in one process and
reports rays/s, with vs_baseline against 45e6 rays/s, plus one gradient
step of the L2 loss over the full scene pytree.

Prints ONE JSON line on stdout; stage details go to stderr. Fails when
JAX finds no GPU: a CPU run is not a measurement.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    from tracer.diff import grad as G
    from tracer.render import progressive as P
    from tracer.scenes import build_scene, get_scene

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: needs a GPU, JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {dev.platform} {dev.device_kind} x{len(devs)}; {card}")

    cache_dir = jax.config.jax_compilation_cache_dir
    cache_entries = len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0
    log(f"compile cache {cache_dir}: {cache_entries} entries")

    desc = get_scene("Project: Dragon")
    timings = {}
    t0 = time.perf_counter()
    scene, cfg = build_scene(desc, timings=timings)
    jax.block_until_ready(scene)
    build_s = time.perf_counter() - t0
    log(f"scene build: {build_s:.3f} s (" + ", ".join(
        f"{k}={v:.3f}s" for k, v in timings.items()) + ")")

    state = P.init_state(cfg)
    t0 = time.perf_counter()
    state = jax.block_until_ready(P.step(scene, cfg, state))
    first_frame_s = time.perf_counter() - t0
    log(f"first frame (compile + run): {first_frame_s:.3f} s")

    frames = 20
    t0 = time.perf_counter()
    for _ in range(frames):
        state = P.step(scene, cfg, state)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    ms_per_frame = dt / frames * 1e3
    rays = cfg.width * cfg.height  # primary rays per frame at 1 spp
    rays_per_s = rays * frames / dt
    log(f"{ms_per_frame:.3f} ms/frame, {rays_per_s / 1e6:.1f} Mray/s")

    # One gradient step of the L2 loss wrt the full scene pytree.
    # max_depth=2 bounds the scan driver at this scene's true depth
    # (Lambertian direct: 1 shading bounce + 1 all-dead flush).
    gcfg = dataclasses.replace(cfg, loop="scan", max_depth=2)
    target = jax.numpy.zeros((cfg.height * cfg.width, 3))
    t0 = time.perf_counter()
    jax.block_until_ready(G.grad_scene(scene, gcfg, target))
    first_grad_s = time.perf_counter() - t0
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        g = G.grad_scene(scene, gcfg, target)
    jax.block_until_ready(g)
    grad_ms = (time.perf_counter() - t0) / reps * 1e3
    fwdbwd = rays * 2 / (grad_ms / 1e3)  # fwd + bwd passes per pixel
    log(f"grad step: {grad_ms:.3f} ms, fwd+bwd {fwdbwd / 1e6:.1f} Mray/s")

    baseline = 45.0e6  # reference BVH dragon (journal/src/project.md 4.2.2)
    print(json.dumps({
        "metric": "primary_rays_per_second_dragon_800x450_bvh",
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": rays_per_s / baseline,
        "fwdbwd_rays_per_second": fwdbwd,
        "ms_per_frame": ms_per_frame,
        "grad_step_ms": grad_ms,
        "scene_build_seconds": build_s,
        "first_frame_seconds": first_frame_s,
        "first_grad_step_seconds": first_grad_s,
        "compile_cache_entries_at_start": cache_entries,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devs), "card": card},
    }))


if __name__ == "__main__":
    main()
