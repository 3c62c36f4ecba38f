"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases (each raises on failure, so the script exits non-zero and never prints
its last line):

1. device: torch version, card name and power limit;
2. build: compile the CUDA kernels from ``pathtrace_tpu_torch/csrc``;
3. kernels against their plain-torch twins on the card, at S = 16384 lanes
   of real lane states (camera rays and the bounce rays of the first pool
   bounces) of the Cornell box and the many-spheres field;
4. the Cornell frame of the JAX package's compile-check entry point
   (128x128, 1 spp, MIS, 16 bounces, 4096 slots, seed 0) on the card, checked
   against the same frame rendered on the CPU with the twins;
5. the benchmark workload: many-spheres at 1920x1080, 16 spp, MIS, 32
   bounces, 16384 slots, timed, with launch counts of both kernels.

The next-to-last lines are the kernels' JSON record and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SLICE_S = 16384
TWIN_RTOL, TWIN_ATOL = 1e-4, 1e-6
DISCRETE_AGREE = 0.999
CORNELL = dict(width=128, height=128, spp=1, integrator="mis", max_bounces=16,
               num_slots=4096, seed=0)
BENCH = dict(width=1920, height=1080, spp=16, integrator="mis", max_bounces=32,
             num_slots=16384, seed=0)
BENCH_BUDGET_S = 120.0
REFERENCE_CHECKSUM = 29173072.0   # the JAX package's image sum for this frame
KERNELS = {
    "fused_bounce": ("pathtrace_tpu_torch/csrc/fused_bounce.cu",
                     "pathtrace_tpu/ops/pallas_shade.py:537"),
    "shadow_any_hit": ("pathtrace_tpu_torch/csrc/shadow_any_hit.cu",
                       "pathtrace_tpu/ops/pallas_shade.py:1587"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 20, calls: int = 10) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``calls``
    back-to-back calls, median over ``runs`` such runs, after a warm-up."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# ---- tests/imgutil.py's image budget, copied (tests/ is not imported) ----
def assert_images_match(actual, desired, rtol=1e-3, atol=5e-3, max_outliers=3,
                        outlier_cap=2.0):
    a = np.asarray(actual).reshape(-1, 3)
    b = np.asarray(desired).reshape(-1, 3)
    if a.shape != b.shape:
        raise AssertionError(f"image shapes {a.shape} != {b.shape}")
    err = np.abs(a - b)
    n_bad = int((err > atol + rtol * np.abs(b)).any(axis=1).sum())
    if n_bad > max_outliers or err.max() >= outlier_cap:
        raise AssertionError(
            f"{n_bad} pixels outside tolerance (budget {max_outliers}), "
            f"worst diff {err.max():.4g} (cap {outlier_cap})")


def lane_states(scene, camera, tables, S, bounces=4, seed=0):
    """Real lane states: S camera rays spread over the image and advanced by
    the twin for ``bounces`` bounces; lane i takes bounce ``i % bounces``."""
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.utils import rng

    dev = scene.device
    W, H = camera.width, camera.height
    lane = torch.arange(S, dtype=torch.int64, device=dev)
    pixel = (lane * 7919) % (W * H)
    keys = rng.pixel_sample_keys(rng.base_key(seed, dev), pixel, torch.zeros_like(pixel))
    bounce = torch.zeros(S, dtype=torch.int32, device=dev)
    u = rng.per_slot_uniforms(keys, bounce.long())
    jitter = torch.stack([u[rng.SLOT_JITTER_X], u[rng.SLOT_JITTER_Y]], dim=1)
    o, d = camera.generate_rays(pixel % W, (H - 1) - pixel // W, jitter)
    state = [torch.ones(S, dtype=torch.bool, device=dev), bounce, o.contiguous(), d,
             torch.ones(S, device=dev), torch.ones(S, device=dev),
             torch.ones((3, S), device=dev), u]
    kw = bounce_kwargs(scene, "mis", 16)
    states = []
    for _ in range(bounces):
        states.append(state)
        res = shade.fused_bounce_reference(tables, *state, **kw)
        b = torch.where(res.live, state[1] + 1, state[1])
        state = [res.live, b, res.next_o, res.next_d, res.next_eta, res.next_pdf,
                 res.next_prefix, rng.per_slot_uniforms(keys, b.long())]
    pick = lane % bounces
    batch = []
    for k in range(8):
        st = torch.stack([s[k] for s in states])          # (B, S) or (B, c, S)
        x = st[pick, lane] if st.dim() == 2 else st[pick, :, lane].T
        batch.append(x.contiguous())
    return batch


def bounce_kwargs(scene, integrator, max_bounces):
    return dict(num_tris=scene.tri_v0.shape[0], num_lights=scene.num_lights,
                integrator=integrator, max_bounces=max_bounces,
                has_tri_lights=scene.has_tri_lights, has_sph_lights=scene.has_sph_lights)


def check_kernels(dev):
    """Phase 3: each kernel against its twin on the card."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade

    worst = {"fused_bounce": 0.0, "shadow_any_hit": 0.0}
    ms = {}
    for name, scene, camera in (
        ("cornell", scenes.cornell_box(dev), scenes.cornell_camera(128, 128, dev)),
        ("many_spheres", scenes.many_spheres(device=dev),
         scenes.many_spheres_camera(1920, 1080, dev)),
    ):
        tables = shade.build_tables(scene)
        batch = lane_states(scene, camera, tables, SLICE_S)
        kw = bounce_kwargs(scene, "mis", 16)
        ref = shade.fused_bounce_reference(tables, *batch, **kw)
        out = shade.fused_bounce(tables, *batch, **kw)
        torch.cuda.synchronize()
        agree = (ref.live == out.live) & (ref.shade == out.shade)
        frac = agree.float().mean().item()
        if frac < DISCRETE_AGREE:
            raise AssertionError(f"fused_bounce {name}: live/shade agree on {frac:.5f} of lanes")
        # Float outputs: within tolerance on >= 99.9% of lanes. The rest are
        # near-delta GGX lanes (roughness 0.02), where one ulp anywhere moves
        # a pdf by percents. The shadow ray and NEE gain are compared where
        # they are consumed: on live lanes.
        close = agree.clone()
        for field in ref._fields:
            a, b = getattr(ref, field), getattr(out, field)
            if a.dtype == torch.bool:
                continue
            used = ref.live & agree if field in ("nee_gain", "shadow_d") else agree
            ok = torch.isclose(b, a, rtol=TWIN_RTOL, atol=TWIN_ATOL, equal_nan=True)
            close &= (ok.all(0) if ok.dim() == 2 else ok) | ~used
            err = (b - a)[..., used].abs().nan_to_num(0.0).max().item()
            worst["fused_bounce"] = max(worst["fused_bounce"], err)
        frac_close = close.float().mean().item()
        if frac_close < DISCRETE_AGREE:
            raise AssertionError(
                f"fused_bounce {name}: outputs within rtol {TWIN_RTOL} on only "
                f"{frac_close:.5f} of lanes")

        so, sd, st = ref.next_o, ref.shadow_d, ref.shadow_tmax
        occ_ref = shade.shadow_any_hit_reference(tables, so, sd, st)
        occ = shade.shadow_any_hit(tables, so, sd, st)
        torch.cuda.synchronize()
        frac_occ = (occ == occ_ref).float().mean().item()
        if frac_occ < DISCRETE_AGREE:
            raise AssertionError(f"shadow_any_hit {name}: masks agree on {frac_occ:.5f}")
        worst["shadow_any_hit"] = max(worst["shadow_any_hit"],
                                      float((occ != occ_ref).any().item()))

        # Kernels timed through the raw launch into preallocated outputs, so
        # that the wrapper's allocations do not starve the card.
        out_k = shade.BounceResult(*(torch.empty_like(x) for x in out))
        occ_k = torch.empty_like(occ)
        t_k = cuda_ms(lambda: binding.launch_fused_bounce(
            tables, *batch, out_k, num_tris=kw["num_tris"], num_lights=kw["num_lights"],
            max_bounces=kw["max_bounces"], eps=shade.EPS,
            **shade.kernel_flags("mis", scene.has_tri_lights, scene.has_sph_lights)))
        t_p = cuda_ms(lambda: shade.fused_bounce_reference(tables, *batch, **kw))
        s_k = cuda_ms(lambda: binding.launch_shadow_any_hit(
            tables, so, sd, st, occ_k, eps=shade.EPS))
        s_p = cuda_ms(lambda: shade.shadow_any_hit_reference(tables, so, sd, st))
        ms[name] = {"fused_bounce": (t_k, t_p), "shadow_any_hit": (s_k, s_p)}
        log(f"[kernels] {name} S={SLICE_S}: live/shade agree {frac:.6f}, all outputs "
            f"within tolerance {frac_close:.6f}, occlusion "
            f"agree {frac_occ:.6f} ({int(occ_ref.sum())} blocked); fused_bounce "
            f"{t_k:.4f} ms vs twin {t_p:.4f} ms; shadow_any_hit {s_k:.4f} ms vs twin "
            f"{s_p:.4f} ms")
    log(f"[kernels] worst abs error: fused_bounce {worst['fused_bounce']:.4g}, "
        f"shadow_any_hit {worst['shadow_any_hit']:.4g}")
    return worst, ms


def run_cornell(dev):
    """Phase 4: the compile-check entry point's frame, GPU against CPU."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.pool import ray_count, render_pool

    shade.LAUNCHES.clear()
    W, H = CORNELL["width"], CORNELL["height"]
    img, counters, iters = render_pool(
        scenes.cornell_box(dev), scenes.cornell_camera(W, H, dev), **CORNELL)
    torch.cuda.synchronize()
    launches = dict(shade.LAUNCHES)
    img = img.cpu().numpy()
    if img.shape != (W * H, 3) or not np.isfinite(img).all():
        raise AssertionError(f"cornell image {img.shape} not finite")
    if launches.get("fused_bounce", 0) != iters or launches.get("shadow_any_hit", 0) <= 0:
        raise AssertionError(f"cornell launches {launches} for {iters} iterations")
    img_cpu, counters_cpu, iters_cpu = render_pool(
        scenes.cornell_box(), scenes.cornell_camera(W, H), **CORNELL)
    rays, rays_cpu = ray_count(counters), ray_count(counters_cpu)
    if abs(rays - rays_cpu) > 1e-3 * rays_cpu:
        raise AssertionError(f"cornell rays GPU {rays} vs CPU {rays_cpu}")
    assert_images_match(img, img_cpu.numpy())
    log(f"[cornell] {W}x{H} 1spp MIS: GPU rays {rays}, iters {iters}; CPU rays "
        f"{rays_cpu}, iters {iters_cpu}; max pixel diff "
        f"{np.abs(img - img_cpu.numpy()).max():.4g}; launches {launches}")


def run_bench(dev, smi: str):
    """Phase 5: many-spheres at the benchmark's size, timed."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.pool import busy_count, ray_count, render_pool

    scene = scenes.many_spheres(device=dev)
    camera = scenes.many_spheres_camera(BENCH["width"], BENCH["height"], dev)
    warm = dict(BENCH, spp=1)
    t0 = time.perf_counter()
    render_pool(scene, camera, **warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    spp = BENCH["spp"]
    while spp > 1 and warm_s * spp > BENCH_BUDGET_S:
        spp //= 2
    run = dict(BENCH, spp=spp)

    shade.LAUNCHES.clear()
    t0 = time.perf_counter()
    img, counters, iters = render_pool(scene, camera, **run)
    checksum = float(img.double().sum().item())     # forces completion
    wall = time.perf_counter() - t0
    launches = dict(shade.LAUNCHES)
    if not torch.isfinite(img).all():
        raise AssertionError("many_spheres image not finite")
    for k in KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"{k} was not launched on the main path: {launches}")
    if launches["fused_bounce"] != iters:
        raise AssertionError(f"fused_bounce launches {launches} != iters {iters}")
    rays = ray_count(counters)
    slots = min(run["num_slots"], run["width"] * run["height"])
    result = {
        "workload": f"many_spheres {run['width']}x{run['height']} {spp}spp MIS",
        "spp": spp, "spp_note": "" if spp == BENCH["spp"] else
        f"reduced from {BENCH['spp']}: the 1-spp warm-up took {warm_s:.2f} s",
        "total_rays": rays, "iters": iters,
        "occupancy": busy_count(counters) / max(iters * slots, 1),
        "wall_s": wall, "mrays_per_s": rays / wall / 1e6,
        "image_checksum": checksum,
        "checksum_rel_diff_vs_jax_tpu": (checksum - REFERENCE_CHECKSUM) / REFERENCE_CHECKSUM
        if spp == BENCH["spp"] else None,
        "warmup_1spp_s": warm_s, "card": smi,
    }
    log("[bench] " + json.dumps(result))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from pathtrace_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    path, secs = build.build()
    log(f"[build] {path.name} in {secs:.2f} s")

    worst, ms = check_kernels(dev)
    run_cornell(dev)
    launches = run_bench(dev, smi)

    record = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": worst[k],
         "ms": ms["many_spheres"][k][0], "plain_ms": ms["many_spheres"][k][1]}
        for k, (src, rep) in KERNELS.items()
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
