"""Command-line interface of the port, with the JAX package's flags and
defaults:

    python -m pathtrace_tpu_torch render --scene cornell --width 400 --height 400 \\
        --spp 256 --integrator mis --engine wave --out out.png --luminance-csv luminance.csv

    python -m pathtrace_tpu_torch render --scene mesh --engine pool --progressive 32 \\
        --checkpoint state.npz --resume

    python -m pathtrace_tpu_torch animate --scene mesh --frames 24 --out-dir frames/

    python -m pathtrace_tpu_torch debug-pixel --scene cornell --x 200 --y 150 --spp 64

    python -m pathtrace_tpu_torch bench     # one JSON line (bench.py)

``--device cuda`` (the default) renders on the GPU through the CUDA kernels
and fails when there is none; ``--device cpu`` runs the kernels' plain twins,
and only when asked. ``--method`` picks the intersection traversal of every
engine (``render --engine pool|wave``, ``animate``, ``debug-pixel``), as the
JAX CLI's process default does: ``auto``, ``pallas``, ``bruteforce``,
``bvh``, ``binned``, ``resident``. ``bruteforce`` takes the route of
``pallas`` (every route gives the brute-force hit), and the pool runs it on
its composed branch, as the JAX pool does. ``--dtype f64`` renders in the
reference's native precision (every command, ``bench`` too) on the fused
pool and every intersection route, whatever the ``--method``. Not ported
yet, exiting with status 2 and a message naming its ROADMAP item: the
multi-process flags.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


SCENES = {
    "cornell": ("cornell_box", "cornell_camera"),
    "default-spheres": ("default_spheres", "default_spheres_camera"),
    "many-spheres": ("many_spheres", "many_spheres_camera"),
    "mesh": ("mesh_scene", "mesh_scene_camera"),
}


class Unported(Exception):
    """A flag whose code path the port does not have yet."""


def _device(args):
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise Unported("--device cuda: no CUDA device is available (use --device cpu to run "
                       "the kernels' plain twins)")
    return torch.device(args.device)


def _build(args, device):
    from .models import scenes as S

    scene_fn, cam_fn = SCENES[args.scene]
    scene = getattr(S, scene_fn)(device=device)
    camera = getattr(S, cam_fn)(args.width, args.height, device=device)
    return scene, camera


def _dtype(args):
    """``torch.float64`` for ``--dtype f64``, else None (the scene's float32)."""
    import torch

    return torch.float64 if args.dtype == "f64" else None


def _config(args, **kw):
    from .render import RenderConfig

    return RenderConfig(width=args.width, height=args.height, spp=args.spp,
                        integrator=args.integrator, max_bounces=args.max_bounces,
                        seed=args.seed, method=args.method, dtype=_dtype(args), **kw)


def cmd_render(args) -> int:
    from . import io as ptio
    from .pool import render_pool
    from .render import RenderState, render, to_srgb_u8

    if args.light_samples != 1 and args.engine != "wave":
        print("--light-samples requires --engine wave (the pool is fixed at the "
              "reference's one light sample per vertex)", file=sys.stderr)
        return 2
    device = _device(args)
    scene, camera = _build(args, device)
    cfg = _config(args, samples_per_batch=args.samples_per_batch,
                  num_light_samples=args.light_samples)

    state = None
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        state = RenderState.load(args.checkpoint, device)
        print(f"resumed at {state.num_samples} spp", file=sys.stderr)

    t0 = time.time()
    if args.engine == "pool":
        done = state.num_samples if state else 0
        image_sum = state.image_sum.reshape(-1, 3) if state else None
        step = args.progressive or (args.spp - done)
        while done < args.spp:
            n = min(step, args.spp - done)
            img, _, _ = render_pool(
                scene, camera, width=args.width, height=args.height, spp=n,
                integrator=args.integrator, max_bounces=args.max_bounces,
                num_slots=args.pool_slots, seed=args.seed, sample_offset=done,
                dtype=_dtype(args), method=args.method)
            image_sum = img if image_sum is None else image_sum + img
            done += n
            state = RenderState(image_sum.reshape(args.height, args.width, 3), done)
            if args.checkpoint:
                state.save(args.checkpoint)
            if args.out and args.progressive:
                ptio.write_png(to_srgb_u8(state.image), args.out)   # progressive preview
            print(f"{done}/{args.spp} spp ({time.time() - t0:.1f}s)", file=sys.stderr)
    else:
        def progress(dn):
            print(f"{dn}/{args.spp} spp ({time.time() - t0:.1f}s)", file=sys.stderr)

        state = render(scene, camera, cfg, state=state, progress_callback=progress)
        if args.checkpoint:
            state.save(args.checkpoint)

    image = state.image.cpu().numpy()
    print(f"rendered {args.spp} spp in {time.time() - t0:.1f}s", file=sys.stderr)
    if args.out:
        ptio.write_png(to_srgb_u8(image), args.out)
        print(f"wrote {args.out}", file=sys.stderr)
    if args.luminance_csv:
        ptio.export_luminance_csv(image, args.luminance_csv)
        print(f"wrote {args.luminance_csv}", file=sys.stderr)
    if args.npy:
        ptio.save_npy(image, args.npy)
    return 0


def cmd_animate(args) -> int:
    """The camera sweep on one device (the JAX CLI shards frames over a
    device mesh when it has one; multi-GPU is ROADMAP Queue 1, item 5)."""
    from . import io as ptio
    from .models import scenes as S
    from .render import render, to_srgb_u8

    device = _device(args)
    scene = S.mesh_scene(device=device) if args.scene == "mesh" else _build(args, device)[0]
    cams = S.sweep_cameras(args.frames, args.width, args.height, device=device)
    cfg = _config(args, samples_per_batch=min(args.spp, 8))
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.time()
    for i, cam in enumerate(cams):
        image = render(scene, cam, cfg).image
        ptio.write_png(to_srgb_u8(image), os.path.join(args.out_dir, f"frame_{i:04d}.png"))
    print(f"{args.frames} frames in {time.time() - t0:.1f}s -> {args.out_dir}", file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    from .bench import run

    _device(args)   # no card and no --device cpu: exit 2, nothing falls back
    print(json.dumps(run(args.device, args.small, _dtype(args))))
    return 0


def cmd_debug_pixel(args) -> int:
    from .debug import replay_pixel
    from .render import cast_floats

    device = _device(args)
    scene, camera = _build(args, device)
    if _dtype(args) is not None:
        scene, camera = cast_floats(scene, _dtype(args)), cast_floats(camera, _dtype(args))
    report = replay_pixel(
        scene, camera, args.x, args.y,
        width=args.width, height=args.height, spp=args.spp,
        integrator=args.integrator, seed=args.seed,
        luminance_threshold=args.threshold, method=args.method,
    )
    print(json.dumps(report, indent=2))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pathtrace_tpu_torch")
    p.add_argument("--coordinator", default=None,
                   help="coordinator host:port for multi-process runs (not ported yet)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total processes in a multi-process run (not ported yet)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank in a multi-process run (not ported yet)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scene", choices=sorted(SCENES), default="cornell")
        sp.add_argument("--width", type=int, default=400)
        sp.add_argument("--height", type=int, default=400)
        sp.add_argument("--spp", type=int, default=64)
        sp.add_argument("--integrator", choices=["mis", "nee", "brdf_only"], default="mis")
        sp.add_argument("--max-bounces", type=int, default=64)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--dtype", choices=["f32", "f64"], default="f32",
                        help="estimator precision; f64 is the reference's native "
                             "precision (every engine and route)")
        sp.add_argument("--method",
                        choices=["auto", "pallas", "binned", "resident", "bvh", "bruteforce"],
                        default="auto",
                        help="intersection traversal: auto (small/flat/bvh by scene "
                             "size), pallas (no BVH); past 64 triangles bvh (two-level "
                             "BVH), binned (per-ray rounds over 256-row clusters) or "
                             "resident (per-ray nearest-first 128-row clusters); "
                             "bruteforce (the route of pallas: every route gives the "
                             "brute-force hit; the pool's composed branch)")
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda: the CUDA kernels on a GPU; cpu: their plain twins")

    r = sub.add_parser("render", help="render a still image")
    common(r)
    r.add_argument("--engine", choices=["wave", "pool"], default="pool")
    r.add_argument("--light-samples", type=int, default=1,
                   help="NEE light samples per vertex; wave engine only")
    r.add_argument("--samples-per-batch", type=int, default=4)
    r.add_argument("--pool-slots", type=int, default=32768)
    r.add_argument("--progressive", type=int, default=0,
                   help="checkpoint every N spp (pool engine)")
    r.add_argument("--checkpoint", default=None)
    r.add_argument("--resume", action="store_true")
    r.add_argument("--out", default="render.png")
    r.add_argument("--luminance-csv", default=None,
                   help="reference-format pre-gamma dump")
    r.add_argument("--npy", default=None)
    r.set_defaults(fn=cmd_render)

    a = sub.add_parser("animate", help="camera-sweep animation")
    common(a)
    a.add_argument("--frames", type=int, default=120)
    a.add_argument("--out-dir", default="frames")
    a.set_defaults(fn=cmd_animate, scene="mesh", width=640, height=360, spp=16)

    b = sub.add_parser("bench", help="run the throughput benchmark (one JSON line)")
    b.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the CUDA kernels on a GPU; cpu: their plain twins, "
                        "on the small frame")
    b.add_argument("--small", action="store_true",
                   help="the small frame (128x128, 1 spp, 4096 slots) on the GPU")
    b.add_argument("--dtype", choices=["f32", "f64"], default="f32",
                   help="estimator precision of the bench frame")
    b.set_defaults(fn=cmd_bench)

    d = sub.add_parser("debug-pixel", help="replay every sample of one pixel")
    common(d)
    d.add_argument("--x", type=int, required=True)
    d.add_argument("--y", type=int, required=True)
    d.add_argument("--threshold", type=float, default=10.0)
    d.set_defaults(fn=cmd_debug_pixel)

    args = p.parse_args(argv)
    try:
        if args.coordinator or args.num_processes or os.environ.get("PT_COORDINATOR"):
            raise Unported("multi-process runs are not ported yet (ROADMAP Queue 1, item 5)")
        return args.fn(args)
    except (Unported, NotImplementedError) as e:
        print(f"pathtrace_tpu_torch: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
