"""Headless CLI — the control panel (``/root/reference/src/control_panel.rs``)
as flags.

Every runtime control of the reference UI maps to a flag: scene (43-entry
combo), resolution, camera constant, sphere/other material selections,
texture mode + uv scale, pixel subdivision, sample count/progressive — plus
what the reference lacked: image export and checkpoint/resume.

Usage:
  python -m tracer.cli --list
  python -m tracer.cli --scene "W8 E3 Absorption" --samples 64 --out out.png
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--list", action="store_true", help="list scenes and exit")
    p.add_argument("--scene", default="W1 E6", help="scene name")
    p.add_argument("--width", type=int, default=0, help="override width")
    p.add_argument("--height", type=int, default=0, help="override height")
    p.add_argument("--samples", type=int, default=1, help="progressive samples")
    p.add_argument(
        "--camera-constant", type=float, default=0.0,
        help="override camera focal constant (0.1-10 in the UI)",
    )
    p.add_argument(
        "--sphere-material", type=int, default=-1,
        help="selection1 shader id (0=lambertian..6=basecolor)",
    )
    p.add_argument(
        "--other-material", type=int, default=-1, help="selection2 shader id"
    )
    p.add_argument(
        "--subdivision", type=int, default=0,
        help="pixel subdivision level 1-10 (stratified AA)",
    )
    p.add_argument(
        "--texture-mode", type=int, default=-1,
        help="0 none, 1 default, 2 bilinear, 3 nearest",
    )
    p.add_argument("--uv-scale", type=float, nargs=2, default=None)
    p.add_argument(
        "--traversal",
        choices=["brute", "bvh", "bvh2", "bvh8", "bsp"],
        default=None,
    )
    p.add_argument(
        "--camera-moves", default=None, metavar="KEYS",
        help="WASD move string applied before rendering, one tick per "
        "char (the reference's orbit/dolly controller, camera.rs:36-112)",
    )
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a jax.profiler trace of the render into DIR",
    )
    p.add_argument(
        "--interactive", action="store_true",
        help="REPL mode: re-render on parameter commands with zero "
        "recompiles (the reference's live command loop, lib.rs:365-488)",
    )
    p.add_argument("--out", default=None, help="output PNG path")
    p.add_argument("--out-pfm", default=None, help="output PFM (linear float)")
    p.add_argument("--out-npz", default=None, help="output NPZ (linear float)")
    p.add_argument("--checkpoint", default=None, help="checkpoint path")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--sharded", action="store_true", help="shard over all devices")
    p.add_argument("--stats-every", type=float, default=5.0,
                   help="seconds between render-stat prints (0 = off)")
    return p


def interactive_loop(scene, cfg, args) -> int:
    """Live render loop: read commands from stdin, mutate the *traced*
    scene pytree, re-render without recompiling.

    The reference drains a command channel between frames
    (``src/lib.rs:365-488``); here every tunable the control panel exposes
    is a traced array input of the compiled step, so a change is a new
    pytree, not a new program. Commands:

      c <constant>        camera focal constant (0.1-10)
      m1 <id> / m2 <id>   sphere / other material selection (0-8)
      move <wasd...>      camera controller ticks (camera.rs:36-112)
      uv <su> <sv>        texture uv scale
      tex <mode>          sampler mode 0-3
      r [n]               render n more progressive samples (default
                          --samples); state accumulates
      reset               clear the accumulator
      save <path.png>     write current image
      q                   quit
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tracer import io as tio
    from tracer.render import progressive as P
    from tracer.util import replace

    state = P.init_state(cfg)
    compiles_before = None

    def render(n_more):
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(n_more):
            state = P.step(scene, cfg, state)
        state.accum.block_until_ready()
        dt = time.perf_counter() - t0
        print(
            f"[cli] {n_more} sample(s) in {dt:.3f}s "
            f"({dt / max(n_more, 1) * 1e3:.1f} ms/frame), "
            f"iteration={int(state.iteration)}",
            file=sys.stderr,
        )

    render(args.samples)
    print("[cli] interactive: c/m1/m2/move/uv/tex/r/reset/save/q",
          file=sys.stderr)
    for line in sys.stdin:
        parts = line.split()
        if not parts:
            continue
        cmd, rest = parts[0], parts[1:]
        try:
            if cmd == "q":
                break
            elif cmd == "c":
                cam = replace(
                    scene.camera,
                    constant=jnp.asarray(float(rest[0]), jnp.float32),
                )
                scene = replace(scene, camera=cam)
                state = P.init_state(cfg)
                render(args.samples)
            elif cmd in ("m1", "m2"):
                field = "selection1" if cmd == "m1" else "selection2"
                u = replace(
                    scene.uniforms,
                    **{field: jnp.asarray(int(rest[0]), jnp.int32)},
                )
                scene = replace(scene, uniforms=u)
                state = P.init_state(cfg)
                render(args.samples)
            elif cmd == "move":
                from tracer.render.controller import CameraController

                scene = replace(
                    scene,
                    camera=CameraController().run(scene.camera, rest[0]),
                )
                state = P.init_state(cfg)
                render(args.samples)
            elif cmd == "uv":
                u = replace(
                    scene.uniforms,
                    uv_scale=jnp.asarray(
                        [float(rest[0]), float(rest[1])], jnp.float32
                    ),
                )
                scene = replace(scene, uniforms=u)
                state = P.init_state(cfg)
                render(args.samples)
            elif cmd == "tex":
                u = replace(
                    scene.uniforms,
                    use_texture=jnp.asarray(int(rest[0]), jnp.int32),
                )
                scene = replace(scene, uniforms=u)
                state = P.init_state(cfg)
                render(args.samples)
            elif cmd == "r":
                render(int(rest[0]) if rest else args.samples)
            elif cmd == "reset":
                state = P.init_state(cfg)
                print("[cli] accumulator cleared", file=sys.stderr)
            elif cmd == "save":
                tio.write_png(rest[0], P.image(state, cfg))
                print(f"[cli] wrote {rest[0]}", file=sys.stderr)
            else:
                print(f"[cli] unknown command: {cmd}", file=sys.stderr)
        except (ValueError, IndexError) as e:
            print(f"[cli] bad command {line.strip()!r}: {e}", file=sys.stderr)
    if args.out:
        tio.write_png(args.out, P.image(state, cfg))
        print(f"[cli] wrote {args.out}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from tracer.scenes import get_scene, get_scenes

    if args.list:
        for d in get_scenes():
            model = d.model.rsplit("/", 1)[-1] if d.model else "-"
            print(f"{d.name:28s} {d.cfg.width}x{d.cfg.height} "
                  f"{d.cfg.mode:6s} {d.cfg.traversal:5s} {model}")
        return 0

    import jax.numpy as jnp
    import numpy as np

    from tracer import io as tio
    from tracer.render import progressive as P
    from tracer.render.scene import SceneConfig
    from tracer.scenes import build_scene
    from tracer.tools import RenderStats
    from tracer.util import replace

    desc = get_scene(args.scene)
    cfg_kw = {}
    if args.width:
        cfg_kw["width"] = args.width
    if args.height:
        cfg_kw["height"] = args.height
    if args.traversal:
        cfg_kw["traversal"] = args.traversal
    if args.subdivision:
        cfg_kw["subdivs"] = args.subdivision
    if cfg_kw:
        desc = dataclasses.replace(
            desc, cfg=dataclasses.replace(desc.cfg, **cfg_kw)
        )
    if args.sphere_material >= 0:
        desc = dataclasses.replace(desc, selection1=args.sphere_material)
    if args.other_material >= 0:
        desc = dataclasses.replace(desc, selection2=args.other_material)
    if args.camera_constant:
        cam = dict(desc.camera)
        cam["constant"] = args.camera_constant
        desc = dataclasses.replace(desc, camera=cam)

    t0 = time.perf_counter()
    scene, cfg = build_scene(desc)
    print(f"[cli] scene '{desc.name}' built in {time.perf_counter()-t0:.2f}s",
          file=sys.stderr)

    if args.camera_moves:
        from tracer.render.controller import CameraController

        scene = replace(
            scene,
            camera=CameraController().run(scene.camera, args.camera_moves),
        )

    u = scene.uniforms
    if args.texture_mode >= 0:
        u = replace(u, use_texture=jnp.asarray(args.texture_mode, jnp.int32))
    if args.uv_scale:
        u = replace(u, uv_scale=jnp.asarray(args.uv_scale, jnp.float32))
    scene = replace(scene, uniforms=u)

    state = None
    if args.resume and args.checkpoint:
        state = P.load_checkpoint(args.checkpoint, cfg)
        print(f"[cli] resumed at iteration {int(state.iteration)}",
              file=sys.stderr)

    if args.interactive:
        ignored = [
            name
            for name, on in (
                ("--sharded", args.sharded),
                ("--profile", bool(args.profile)),
                ("--checkpoint", bool(args.checkpoint)),
                ("--checkpoint-every", args.checkpoint_every > 0),
            )
            if on
        ]
        if ignored:
            print(
                f"[cli] warning: --interactive ignores {', '.join(ignored)} "
                "(the REPL drives its own single-device loop)",
                file=sys.stderr,
            )
        return interactive_loop(scene, cfg, args)

    import contextlib

    if args.profile:
        import jax

        prof_ctx = jax.profiler.trace(args.profile)
        print(f"[cli] profiling to {args.profile}", file=sys.stderr)
    else:
        prof_ctx = contextlib.nullcontext()

    stats = RenderStats(print_every=args.stats_every)
    with prof_ctx:  # trace is closed/written even if rendering raises
        if args.sharded:
            from tracer.parallel import shard as S

            mesh = S.make_ray_mesh()
            scene_r = S.replicate_scene(scene, mesh)
            st = S.shard_state(state or P.init_state(cfg), cfg, mesh)
            step = S.sharded_step(mesh)
            for i in range(int(st.iteration), args.samples):
                stats.begin()
                st = step(scene_r, cfg, st)
                st.accum.block_until_ready()
                stats.end()
            img = S.gather_image(st, cfg)
            lin = np.asarray(st.accum)[: cfg.width * cfg.height]
            final_iter = int(st.iteration)
        else:
            st = state or P.init_state(cfg)
            for i in range(int(st.iteration), args.samples):
                stats.begin()
                st = P.step(scene, cfg, st)
                st.accum.block_until_ready()
                stats.end()
                if (
                    args.checkpoint
                    and args.checkpoint_every
                    and (i + 1) % args.checkpoint_every == 0
                ):
                    P.save_checkpoint(args.checkpoint, st, cfg)
            img = P.image(st, cfg)
            lin = np.asarray(st.accum)
            final_iter = int(st.iteration)
    print(f"[cli] rendered {final_iter} samples; {stats.summary()}",
          file=sys.stderr)
    if args.checkpoint:
        P.save_checkpoint(args.checkpoint, st, cfg)
    if args.out:
        tio.write_png(args.out, img)
        print(f"[cli] wrote {args.out}", file=sys.stderr)
    if args.out_pfm:
        tio.write_pfm(args.out_pfm, lin.reshape(cfg.height, cfg.width, 3))
    if args.out_npz:
        tio.write_npz(args.out_npz, lin.reshape(cfg.height, cfg.width, 3),
                      iteration=final_iter)
    return 0


if __name__ == "__main__":
    sys.exit(main())
