"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases (each raises on failure, so the script exits non-zero and never prints
its last line):

1. device: torch version, card name and power limit;
2. build: compile the CUDA kernels from ``pathtrace_tpu_torch/csrc``;
3. the pool's two kernels (``fused_bounce`` in its default mode, whose
   raygen mode the pool runs and phase 3i checks; ``shadow_any_hit``) against
   their plain-torch twins on the card, bitwise, at every split of their
   sweeps (1-16 threads a lane) and through the wrappers (the host's split),
   each split timed: S = 16384 lanes of real lane states (camera rays and
   the bounce rays of the first pool bounces) of the Cornell box and the
   many-spheres field, and 4096 edge lanes (rows repeated with other
   materials, so equal t; all-miss lanes; NaN sphere padding; shadow t_max
   of -1, NaN and inf);
4. the Cornell frame of the JAX package's compile-check entry point
   (128x128, 1 spp, MIS, 16 bounces, 4096 slots, seed 0) on the card, checked
   against the same frame rendered on the CPU with the twins, and rendered
   again through ``profiler.profiled_render`` (its ``RenderStats`` printed;
   the same counts and image);
5. the benchmark workload through ``pathtrace_tpu_torch.bench``:
   many-spheres at 1920x1080, 16 spp, MIS, 32 bounces, 16384 slots, timed,
   with launch counts of both kernels; the bench's JSON line is printed, and
   its rays, iterations and checksum must repeat ``BENCH_EXPECT``.

The mesh path (scenes with >= 4096 triangles, the pool's composed branch):

3b. its four kernels against their twins on the card, bitwise, at S = 65536
    lanes of the 70k-triangle mesh scene: camera rays, the bounce rays of
    composed twin bounces, and their NEE shadow rays; the BVH pair also at
    every team size (1-32 threads a ray), with per-ray counters held
    against ``bvh_traversal_reference``, on edge lanes (t_max NaN, -1, 0,
    t_min, inf) and the tie case; ``bvh_closest(counters=True)`` against
    the model's per-span sums; times at every team size, and the mean
    groups, leaves and triangle tests a ray against the bound's;
4b. a mesh frame (8192 triangles, 32x32, 2 spp, MIS, depth 8, 1024 slots)
    on the card, checked against the same frame on the CPU with the twins;
5b. BASELINE config 4: the 70k-triangle mesh scene at 1920x1080, 4 spp,
    MIS, depth 8, 65536 slots, timed, with launch counts of its kernels.

The wave engine (``render.render`` -> ``integrators.trace_wave``; the small
route for scenes of <= 64 triangles, the flat route for 64 < triangles <
4096):

3c. its two closest-hit kernels against their twins on the card, bitwise,
    through the wrappers and at every team size (1-32 threads a ray), at
    S = 65536 lanes (camera rays and bounce rays): ``combined_closest_small``
    on Cornell and many_spheres, ``triangle_closest`` on mesh_scene(2000)
    (1982 triangles), also on 1,024 edge lanes of each (t_max NaN, -1, 0,
    t_min, inf; t_min, t_max or both at the hit's t) and on tie cases
    (:func:`small_tie_tables`, :func:`tie_tables` on flat tables), every
    team timed; and ``any_hit`` with the small and flat triangle tables on
    the lanes' NEE shadow rays;
5c. the reference workload: Cornell 400x400, MIS, 64 bounces, 16 spp, seed
    0, through ``render.render``, timed, its channel means held to within 3%
    of the 8192-spp golden image (``tests/golden/``);
4c. wave renders on the card against the same renders on the CPU twins
    (Cornell 64x64 2 spp; mesh_scene(2000) 32x32 1 spp) and a
    mesh_scene(2000) composed-pool frame (32x32, 2 spp, depth 8): equal ray
    counts, images within the imgutil budget;

The opt-in per-ray mesh traversals (``method="binned"|"resident"``):

3d. their four kernels against their twins on the card, bitwise, at the
    65,536 lanes of phase 3b: the binned round kernels at every team size
    (1-32 threads a sorted ray) on every round's sorted wave of one call of
    each binned driver (captured by wrapping ``binned.round_closest``/
    ``round_anyhit``), on edge waves (sentinel keys, t_up NaN, -1, 0, inf,
    t_min at the hit's t) and on the tie case (:func:`binned_tie_tables`);
    the binned drivers against the same drivers on the round twins; both
    drivers against the brute-force twin on every lane; the resident
    kernels against brute force at every team size (1-32 threads a ray;
    the closest hit with its cluster entries cached in shared memory where
    they fit and recomputed) on the lanes, on edge lanes (t_max NaN, -1, 0,
    t_min, inf; t_min and t_max at the hit's t), on tables padded to 1,544
    boxes and on the tie case (:func:`tie_tables` on resident tables), with
    ``resident_walk_reference`` against the twins; CUDA-event times (the
    round pair at every team on the first round's wave and summed over a
    driver call's waves, the resident pair at every team and mode), the
    drivers' rounds counted, the walk's clusters and rows a ray against the
    bound's tests;
5d. config 4 at 1 spp through ``render_pool(method=m)`` for bvh, binned and
    resident: the same rays and iterations (``METHOD_EXPECT``) and a
    bitwise-equal image; wall, Mrays/s, launches and each hand-written
    kernel's device ms per iteration and the device's busy share;
4d. the wave engine on mesh_scene(2000), 32x32, 1 spp, under binned and
    resident, on the card against the CPU twins;
6.  the CLI: ``python -m pathtrace_tpu_torch render --engine wave --device
    cuda`` (Cornell), ``render --scene mesh --method resident --engine
    pool`` and the pool on a 1,940-sphere field in subprocesses write PNGs;
    ``python -m pathtrace_tpu_torch bench --small`` prints exactly one JSON
    line with the root ``bench.py``'s keys.

The clustered sphere modes (scenes past 512 spheres) and the Oren-Nayar/PBR
lanes of ``fused_bounce``:

3e. the clustered ``sphere_closest`` and ``any_hit`` against their twins,
    bitwise, at every team size (1-32 threads a ray), on all 65,536 lanes of
    ``many_spheres(n_per_side=22)`` (1,940 spheres in 8 clusters, the flat
    route: camera rays, the bounce rays of composed twin bounces and their
    NEE shadow rays, ``any_hit`` with the sphere and the triangle boxes) and
    on their first 16,384 (the field's pool frame runs 16,384 slots), on
    phase 3c's ``mesh_scene(2000)`` shadow lanes with its triangle boxes, on
    edge lanes (t_max NaN, -1, 0, t_min, inf; rays from far outside the
    field; grazing rays) and on the cross-cluster tie
    (:func:`sphere_tie_tables`), with ``cluster_walk_reference`` against
    the twins; every team timed at both lane counts, the walk's clusters
    and rows a ray against the bound's rows; ``triangle_closest`` on the
    field's 2 triangles at every team on the first 16,384 lanes, timed;
    ``fused_bounce`` with its
    ON/PBR lanes and ``shadow_any_hit`` against their twins, bitwise, at
    every split, at S = 16,384 lanes of the ON/PBR scene;
4e. GPU against the CPU twins: the sphere field through the composed pool
    (32x32, 2 spp, depth 8) and the wave engine (32x32, 1 spp), the ON/PBR
    scene through the fused pool (32x32, 2 spp): equal ray counts, images
    within the imgutil budget;
5e. two 1920x1080, 4-spp, MIS, 32-bounce frames with 16,384 slots, timed:
    the sphere field through the composed pool and the ON/PBR scene through
    the fused pool; wall, Mrays/s, rays, iterations, checksum (which must
    repeat ``CLUSTER_EXPECT``), device operations an iteration and the busy
    share (profiler over a 960x540, 1-spp run of the same scene and slots);

Float64, the reference's native precision (the fused pool and every
intersection route; every scene widened from float32 by
``render.cast_floats``):

3f. the float64 instances of ``fused_bounce`` and ``shadow_any_hit``
    against their float64 twins, bitwise, at every split, on 16,384 lanes of
    many_spheres and of the ON/PBR scene and on the edge lanes; of
    ``combined_closest_small`` and the one-tile ``any_hit`` at every team on
    phase 3c's 65,536 wave-Cornell lanes, 1,024 edge lanes and the small tie
    case; each timed against its bound at the FP64 peak;
3g. float64 on the flat and bvh routes: the float64 instances of
    ``sphere_closest`` (one tile and clustered), the clustered ``any_hit``,
    ``triangle_closest``, ``bvh_closest`` (``counters=True`` too) and
    ``bvh_anyhit`` against their float64 twins, bitwise, at every team
    (1-32), on the lanes of phases 3b, 3c and 3e widened to float64: the
    65,536 config-4 rays and shadow rays, the sphere field's first 16,384,
    ``mesh_scene(2000)``'s 65,536; the edge lanes and tie cases in float64;
    each timed by events and queued at the host's team and at every team,
    beside its float32 instance, bound at the FP64 peak; config 4 and the
    sphere field at 1920x1080, 1 spp, in float64 on the composed pool
    (rays within 2% of the float32 frames'), and ``mesh_scene(2000)`` at
    32x32 in float64 on the card against the CPU twins;
3h. float64 on the binned and resident routes: the float64 instances of
    the binned round pair and the resident pair against their float64
    twins, bitwise, at every team (1-32), on phase 3b's 65,536 config-4
    lanes widened to float64: the round pair on every round's sorted wave
    of one call of each binned driver, on edge waves and the tie case; both
    float64 drivers against the same drivers on the round twins and the
    brute-force twin on every lane (their rounds and ray-rounds beside the
    float32 drivers'); the resident pair, the closest hit with its entries
    cached where they fit in double and recomputed, on the lanes, edge
    lanes, tables padded to 1,544 boxes (past the float64 fit) and the tie
    case; each timed at the host's team and at every team beside its
    float32 instance, bound at the FP64 peak; config 4 at 1920x1080, 1 spp,
    in float64 under binned and resident, once each, timed: rays within 2%
    of the float32 frames of phase 5d, the two frames' images equal;

The modes of ``fused_bounce`` (``raygen``, which the fused pool runs, and
``fuse_shadow``, which no pool runs yet):

3i. every mode's instance (the default, raygen, the fused shadow sweep,
    both) in float32 and float64 against its twin, bitwise, through the
    wrapper and at every split, on S = 16,384 real lane states of Cornell,
    many_spheres and the ON/PBR scene and on the edge lanes, ~40% of them
    starting a sample on a real pixel for raygen, and on the many_spheres
    and edge lanes cut to a ragged count (16,383 and 4,093: threads past S
    in the last block at every split); the raygen twin against the split
    path's (``generate_rays`` and the merges); the fused shadow's outputs
    against the split pair's kernels (``fused_bounce`` + ``shadow_any_hit``
    + the pool's mask); each mode timed at every split beside the default,
    and in turns against the split path it replaces, on many_spheres; the
    ON/PBR raygen instance timed at every split; the pool against its split
    path (``split_pool``: ``generate_rays``, the merges and the default
    instance, as the pool ran before) in turns on Cornell 128x128 1 spp,
    many_spheres 1920x1080 1 spp (32 bounces, 16,384 slots) and the ON/PBR
    scene at 32x32 2 spp in float32 and Cornell in float64: equal rays,
    iterations and image, walls, and the Cornell float32 frame's device ops
    an iteration;

The random-number draw (``csrc/rng.cu``; twin ``utils/rng.py``):

3j. its entry points against the twin run on the card, bitwise, in float32
    and float64: the pool's draw (``pool_uniforms``), the wave's keys
    (``pixel_sample_keys``), bounce draw (``bounce_uniforms``) and NEE
    light-sample keys, at seeds 0, 2**31 + 5 and 2**32 - 1 and 1 to
    2,073,600 lanes; one ``rng_pool_uniforms`` launch a pool iteration in a
    traced Cornell pool pass of each dtype, and the wave's key and draw
    launches in a traced wave pass; each draw timed against the torch draw
    it replaces, in turns, at the four benchmark cells' lanes, with its
    bound at INT32 issue or HBM;

8.  float64 frames: the Cornell 128x128 pool frame and a 64x64, 2-spp wave
    Cornell frame on the card against the CPU twins (equal rays and
    iterations); many_spheres at 1920x1080, 4 spp, 32 bounces, 16,384 slots,
    timed in float64, then in float32; the Cornell box at 400x400,
    256 spp, 64 bounces, 160,000 slots, its full-resolution RMSE against the
    golden within 1.15x the noise floor and each channel's mean bias within
    1e-3; ``render --dtype f64`` and ``bench --small --dtype f64`` through
    the CLI. Each frame launches only the float64 kernels of its path.

Multi-process rendering (``parallel/``), every rank a process on the card:

9.  9a: one NCCL rank (world size 1) renders BASELINE config 5's first two
    frames (``mesh_scene()``, ``sweep_cameras(120, 640, 360)``, 16 spp, MIS,
    depth 8, 32,768 slots) through ``frames_pool_sharded``, both in one pool
    of the stacked cameras, timed (wall, Mrays/s), launching
    ``bvh_closest``, ``bvh_anyhit``, ``sphere_closest`` and ``any_hit``;
    each frame's rays and image equal this process's ``render_pool`` of its
    camera bit for bit, the block's iterations on its first frame; 9b: two gloo ranks share the
    card: ``render_pool_sharded`` on phase 4's Cornell frame at ``dp=2``
    (bitwise against ``render_pool``) and at 2 spp at ``sp=2`` (rays exact,
    image within 1e-5); on three 32x32 Cornell frames at ``dp=2``,
    ``frames_sharded`` (within the image budget of ``render.render``) and
    ``frames_pool_sharded`` (bitwise against ``render_pool``, each rank's
    iterations on its block's first frame); 9c: ``python -m
    pathtrace_tpu_torch --coordinator ... --num-processes 2 --process-id
    {0,1} animate`` writes two PNGs from rank 0. Every rank has a time limit
    and a failing rank's peers are killed.

Parity against the C++ oracle (``csrc/oracle.cpp`` through
``pathtrace_tpu_torch.oracle``):

7.  ``tests/test_parity.py``'s five cases at its sizes, seeds and
    tolerances (48x48: a diffuse Cornell under BRDF-only and MIS, NEE with a
    sphere light, the glass Cornell box under MIS, Oren-Nayar walls under
    MIS), the port's wave engine on the card against the oracle on the
    host; the pixel (79, 176) anchor of the 400x400 Cornell box, 2,048
    samples against the oracle's window; and the golden image's window
    ``[240:244, 190:198]`` re-rendered bitwise at 8,192 spp.

The draw counts its launches in ``utils/rng.py``'s ``LAUNCHES``, apart from
``shade.LAUNCHES``: the main path's frames check one ``rng_pool_uniforms``
launch an iteration (phase 5, and phase 8's float64 Cornell pool frame) and
the wave's ``rng_fold`` and ``rng_bounce_uniforms`` launches (phase 5c, and
phase 8's float64 wave frame). The next-to-last lines are the kernels' JSON
record (forty-three entries: the twelve kernels, the four further modes,
the draw's five entry points (their launches the main path's frames', their
times phase 3j's at every cell's lanes beside the torch draw's, events and
queued), the seven instances of
``fused_bounce``'s modes (phase 3i, with their time at every split beside
the default's and, for raygen and the fused shadow, the split path's times
in turns; the raygen instances' launches are the main path's frames',
ON/PBR included; the fused shadow's those of phase 3i's wrapper call, since
no pool runs it) and the fifteen float64
instances (``*_f64``, bound at the FP64 peak; phase 3g's seven and phase
3h's four also with ``ms_f32``, the float32 instance's time on the same
lanes), each with its time, its twin's,
its launches on its path (the default instances of ``fused_bounce``, which
the fused pool no longer runs: phase 3i's split frames') and its roofline
bound; the pool's two kernels with
the host's split and their time at every split, the BVH pair with the host's
team, its time at every team and its work a ray, ``bvh_closest_counters`` with its launches in
phase 3b, the clustered modes with their time and bound at 16,384 lanes, the
host's team, their time at every team and their work a ray, the binned round
pair with the host's team, its time at every team on the first round's wave
and summed over a driver call's waves, and the call's rounds and ray-rounds,
the resident pair with the host's team, its time at every team (the closest
hit's also with its entries recomputed) and the walk's work a ray, the
wave pair with the host's team and its time at every team, many_spheres'
time and bound beside Cornell's, and the field's 16,384 lanes' and frame's
for ``triangle_closest``)
and the card's name and power limit;
the last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SLICE_S = 16384
EDGE_S = 4096               # lanes of the edge scene (phase 3)
EDGE_N = 1024               # edge lanes of each scene of phase 3c
CORNELL = dict(width=128, height=128, spp=1, integrator="mis", max_bounces=16,
               num_slots=4096, seed=0)
BENCH_BUDGET_S = 120.0      # the bench frame (bench.FRAME) halves its spp past this
BENCH_EXTRA_KEYS = {"platform", "spp_per_sec", "total_rays", "pool_iterations", "occupancy",
                    "wall_s", "image_checksum"}   # the root bench.py's "extra"
REFERENCE_CHECKSUM = 29173072.0   # the JAX package's image sum for the bench frame
# The port's own counts for this frame at 16 spp, repeated exactly by every
# version of the kernels since they were first run (rays, iterations, image
# sum to two decimals): any split of the sweeps must give them again.
BENCH_EXPECT = (114892360, 4896, 29178592.04)
MESH_S = 65536
MESH_FRAME = dict(width=32, height=32, spp=2, integrator="mis", max_bounces=8,
                  num_slots=1024, seed=0)
MESH_FRAME_TRIS = 8192
CONFIG4 = dict(width=1920, height=1080, spp=4, integrator="mis", max_bounces=8,
               num_slots=65536, seed=0)
CONFIG4_BUDGET_S = 120.0
KERNELS = {
    "fused_bounce": ("pathtrace_tpu_torch/csrc/fused_bounce.cu",
                     "pathtrace_tpu/ops/pallas_shade.py:537"),
    "shadow_any_hit": ("pathtrace_tpu_torch/csrc/shadow_any_hit.cu",
                       "pathtrace_tpu/ops/pallas_shade.py:1587"),
}
# The fused pool's launches, by counter name: fused_bounce in its raygen mode
# (the default instance is run by phase 3i's split frames alone) and the
# shadow test.
POOL_KERNELS = ("fused_bounce_raygen", "shadow_any_hit")
MESH_KERNELS = {
    "bvh_closest": ("pathtrace_tpu_torch/csrc/bvh.cu",
                    "pathtrace_tpu/ops/bvh_intersect.py:388"),
    "bvh_anyhit": ("pathtrace_tpu_torch/csrc/bvh.cu",
                   "pathtrace_tpu/ops/bvh_intersect.py:596"),
    "sphere_closest": ("pathtrace_tpu_torch/csrc/intersect.cu",
                       "pathtrace_tpu/ops/pallas_intersect.py:240"),
    "any_hit": ("pathtrace_tpu_torch/csrc/intersect.cu",
                "pathtrace_tpu/ops/pallas_intersect.py:679"),
}
# bvh_closest(counters=True), the JAX diagnostic mode: no render path runs
# it, so its launches are those of phase 3b's wrapper call.
COUNTER_KERNELS = {
    "bvh_closest_counters": ("pathtrace_tpu_torch/csrc/bvh.cu",
                             "pathtrace_tpu/ops/bvh_intersect.py:388"),
}
WAVE_S = 65536
WAVE_KERNELS = {
    "combined_closest_small": ("pathtrace_tpu_torch/csrc/combined_closest_small.cu",
                               "pathtrace_tpu/ops/pallas_intersect.py:957"),
    "triangle_closest": ("pathtrace_tpu_torch/csrc/triangle_closest.cu",
                         "pathtrace_tpu/ops/pallas_intersect.py:448"),
}
FLAT_TRIS = 2000            # mesh_scene(2000): 1982 triangles, the flat route
WAVE_CORNELL = dict(width=400, height=400, spp=16, integrator="mis", max_bounces=64, seed=0)
WAVE_BUDGET_S = 240.0       # the 16-spp render halves its spp (down to 8) past this
GOLDEN = "tests/golden/oracle_cornell_400_mis_8192.npz"
GOLDEN_MEAN_RTOL = 0.03
GOLDEN_SIZE, GOLDEN_SPP = 400, 8192
GOLDEN_WINDOW = (190, 240, 8, 4)   # (x0, y0, width, height) re-rendered bitwise
PIXEL_ANCHOR, PIXEL_ANCHOR_SPP = (79, 176), 2048
PARITY_SIZE = 48
# tests/test_parity.py's cases: (scene, integrator, port spp, oracle spp,
# channel-mean bound, RMSE bound); the port renders with seed 5, the oracle 11.
PARITY_CASES = (
    ("diffuse", "brdf_only", 192, 1024, 0.012, 0.18),
    ("diffuse", "mis", 192, 1024, 0.012, 0.18),
    ("sphere_light", "nee", 192, 1024, 0.015, 0.2),
    ("cornell", "mis", 192, 768, 0.02, 0.5),
    ("oren_nayar", "mis", 128, 512, 0.015, 0.2),
)
WAVE_CHECKS = (             # (scene, width, height, spp) rendered on the card and the CPU
    ("cornell", 64, 64, 2),
    ("mesh_2000", 32, 32, 1),
)
FLAT_POOL = dict(width=32, height=32, spp=2, integrator="mis", max_bounces=8,
                 num_slots=1024, seed=0)
TRAVERSAL_KERNELS = {
    "binned_round_closest": ("pathtrace_tpu_torch/csrc/binned.cu",
                             "pathtrace_tpu/ops/binned_intersect.py:99"),
    "binned_round_anyhit": ("pathtrace_tpu_torch/csrc/binned.cu",
                            "pathtrace_tpu/ops/binned_intersect.py:189"),
    "resident_closest": ("pathtrace_tpu_torch/csrc/resident.cu",
                         "pathtrace_tpu/ops/resident_intersect.py:177"),
    "resident_anyhit": ("pathtrace_tpu_torch/csrc/resident.cu",
                        "pathtrace_tpu/ops/resident_intersect.py:259"),
}
METHODS = ("bvh", "binned", "resident")   # the per-ray traversals, config 4 at 1 spp
METHOD_KERNELS = {"bvh": ("bvh_closest", "bvh_anyhit"),
                  "binned": ("binned_round_closest", "binned_round_anyhit"),
                  "resident": ("resident_closest", "resident_anyhit")}
METHOD_EXPECT = (6838144, 88)   # config 4 at 1 spp: rays, iterations under every method
METHOD_WAVE = dict(width=32, height=32, spp=1, integrator="mis", max_bounces=64, seed=0)
FIELD_N = 22                # many_spheres(n_per_side=22): 1,940 spheres in 8 clusters
CLUSTER_KERNELS = {
    "sphere_closest_clustered": ("pathtrace_tpu_torch/csrc/intersect.cu",
                                 "pathtrace_tpu/ops/pallas_intersect.py:240"),
    "any_hit_clustered": ("pathtrace_tpu_torch/csrc/intersect.cu",
                          "pathtrace_tpu/ops/pallas_intersect.py:679"),
    "fused_bounce_on_pbr": ("pathtrace_tpu_torch/csrc/fused_bounce.cu",
                            "pathtrace_tpu/ops/pallas_shade.py:537"),
}
FIELD_POOL = dict(width=32, height=32, spp=2, integrator="mis", max_bounces=8,
                  num_slots=1024, seed=0)
FIELD_WAVE = dict(width=32, height=32, spp=1, integrator="mis", max_bounces=64, seed=0)
ON_PBR_POOL = dict(width=32, height=32, spp=2, integrator="mis", max_bounces=16,
                   num_slots=1024, seed=0)
CLUSTER_FRAME = dict(width=1920, height=1080, spp=4, integrator="mis", max_bounces=32,
                     num_slots=16384, seed=0)
CLUSTER_PROFILED = dict(width=960, height=540, spp=1)   # phase 5e's profiled frame
# The port's counts for phase 5e's two frames (rays, iterations, image sum to
# two decimals), repeated by every version of the kernels since they were
# first run: every team and split must give them again.
CLUSTER_EXPECT = {f"many_spheres(n_per_side={FIELD_N})": (30369475, 1328, 6769461.23),
                  "on_pbr": (21056179, 936, 2927024.11)}
# Roofline of one H100 SXM (NVIDIA's data sheet): float32 and float64
# outside the tensor cores and HBM bandwidth, at the full 700 W power limit.
PEAK_FP32 = 67e12
PEAK_FP64 = 33.5e12
PEAK_HBM = 3.35e12
# The INT32 (ALU) pipe of one H100 SXM: 64 lanes a clock on each of 132 SMs
# at 1.98 GHz.
PEAK_INT32 = 16.7e12
# The random-number draw (phase 3j, csrc/rng.cu): the int32 operations of one
# threefry2x32 block that only the ALU pipe runs, the 20 rounds' rotations
# (SHF) and xors (LOP3); ptxas issues most adds as IMAD on the FMA pipe
# (SASS of rng_pool_uniforms_kernel<float>: 241 SHF, 253 LOP3, 63 IADD3, 265
# IMAD for 12 blocks). Then the seeds and lane counts it is checked at
# (pixels < 2**21, samples < 10**4, bounces < 64), and the lanes of the four
# benchmark cells it is timed at.
THREEFRY_OPS = 40
RNG_SEEDS = (0, 2**31 + 5, 2**32 - 1)
RNG_S = (1, 1000, 160000, 524288, 1048576, 2073600)
RNG_CELLS = {"cornell400.pool": 160000, "rtiow_1080p.pool": 524288,
             "knot70k_1080p.pool": 1048576, "rtiow_1080p.wave": 2073600}
RNG_POOL = dict(width=64, height=64, spp=2, integrator="mis", max_bounces=16,
                num_slots=1024, seed=2**31 + 5)
RNG_WAVE = dict(width=32, height=32, spp=2, integrator="mis", max_bounces=16,
                num_light_samples=2, seed=2**32 - 1)
# The draw's entry points by launch counter name; none replaces a TPU kernel
# (the JAX package draws with jax.random: pathtrace_tpu/pool.py ::
# _per_slot_uniforms, utils/rng.py), so "replaces" names the draw.
RNG_KERNELS = {
    "rng_pool_uniforms": ("pathtrace_tpu_torch/csrc/rng.cu",
                          "pathtrace_tpu/pool.py:131 _per_slot_uniforms (jax.random)"),
    "rng_pool_uniforms_f64": ("pathtrace_tpu_torch/csrc/rng.cu",
                              "pathtrace_tpu/pool.py:131 _per_slot_uniforms (jax.random)"),
    "rng_bounce_uniforms": ("pathtrace_tpu_torch/csrc/rng.cu",
                            "pathtrace_tpu/utils/rng.py bounce_uniforms (jax.random)"),
    "rng_bounce_uniforms_f64": ("pathtrace_tpu_torch/csrc/rng.cu",
                                "pathtrace_tpu/utils/rng.py bounce_uniforms (jax.random)"),
    "rng_fold": ("pathtrace_tpu_torch/csrc/rng.cu",
                 "pathtrace_tpu/utils/rng.py pixel_sample_keys (jax.random.fold_in)"),
}
# Float64 (phases 3f and 8): the four kernels with a float64 instance.
F64_KERNELS = {
    "fused_bounce_f64": ("pathtrace_tpu_torch/csrc/fused_bounce.cu",
                         "pathtrace_tpu/ops/pallas_shade.py:537"),
    "shadow_any_hit_f64": ("pathtrace_tpu_torch/csrc/shadow_any_hit.cu",
                           "pathtrace_tpu/ops/pallas_shade.py:1587"),
    "combined_closest_small_f64": ("pathtrace_tpu_torch/csrc/combined_closest_small.cu",
                                   "pathtrace_tpu/ops/pallas_intersect.py:957"),
    "any_hit_f64": ("pathtrace_tpu_torch/csrc/intersect.cu",
                    "pathtrace_tpu/ops/pallas_intersect.py:679"),
}
# Float64 on the flat and bvh routes (phase 3g): the instances, by launch
# counter name.
F64_ROUTE_KERNELS = {
    "sphere_closest_f64": ("pathtrace_tpu_torch/csrc/intersect.cu",
                           "pathtrace_tpu/ops/pallas_intersect.py:240"),
    "sphere_closest_clustered_f64": ("pathtrace_tpu_torch/csrc/intersect.cu",
                                     "pathtrace_tpu/ops/pallas_intersect.py:240"),
    "any_hit_clustered_f64": ("pathtrace_tpu_torch/csrc/intersect.cu",
                              "pathtrace_tpu/ops/pallas_intersect.py:679"),
    "triangle_closest_f64": ("pathtrace_tpu_torch/csrc/triangle_closest.cu",
                             "pathtrace_tpu/ops/pallas_intersect.py:448"),
    "bvh_closest_f64": ("pathtrace_tpu_torch/csrc/bvh.cu",
                        "pathtrace_tpu/ops/bvh_intersect.py:388"),
    "bvh_closest_counters_f64": ("pathtrace_tpu_torch/csrc/bvh.cu",
                                 "pathtrace_tpu/ops/bvh_intersect.py:388"),
    "bvh_anyhit_f64": ("pathtrace_tpu_torch/csrc/bvh.cu",
                       "pathtrace_tpu/ops/bvh_intersect.py:596"),
}
# The phase 3g frame whose launches an instance's entry reports (else the
# sphere field's): config 4's, or mesh_scene(2000)'s 32x32 frame.
F64_FRAME_OF = {"sphere_closest_f64": "config4", "bvh_closest_f64": "config4",
                "bvh_anyhit_f64": "config4", "triangle_closest_f64": "flat"}
# Float64 on the binned and resident routes (phase 3h): the instances, by
# launch counter name, and the methods whose config-4 frame launches them.
F64_TRAVERSAL_KERNELS = {f"{k}_f64": v for k, v in TRAVERSAL_KERNELS.items()}
F64_METHODS = ("binned", "resident")
F64_RAYS_RTOL = 0.02        # a float64 frame's rays against the float32 frame's
F64_WAVE = dict(width=64, height=64, spp=2, integrator="mis", max_bounces=64, seed=0)
F64_FRAME = dict(width=1920, height=1080, spp=4, integrator="mis", max_bounces=32,
                 num_slots=16384, seed=0)
F64_GOLDEN = dict(width=400, height=400, spp=256, integrator="mis", max_bounces=64,
                  num_slots=160000, seed=0)
# The golden's per-sample sigma (tools/parity_anchor.py): a render at spp
# samples is held to 1.15x the noise floor sigma * sqrt(1/spp + 1/8192), and
# each channel's mean to 1e-3 of the golden's.
GOLDEN_SIGMA = 0.4846
F64_RMSE_OVER_FLOOR = 1.15
F64_MEAN_BIAS = 1e-3
# Float32 operations of one ray-primitive test (csrc/geom.cuh): hit_triangle
# ~50 (two cross products, three dot products, a division, compares),
# sphere_root ~20. A bound counts only the tests the inputs need: for a
# closest hit every box that [t_min, min(t_max, t)] enters, t the answer;
# for an any hit every entered box of an unoccluded ray and one test of an
# occluded one. So it is a least time, below what any traversal could take.
TRI_OPS = 50
SPH_OPS = 20
SPIN_CYCLES = 40_000_000  # ~20 ms of the card's clock: queued_ms's launches queue behind it
CLUSTER_ROWS = 256        # rows of a binned cluster
RESIDENT_PADDED_BOXES = 1544   # phase 3d's padded resident tables: no cached entries at team 16


def log(msg: str) -> None:
    print(msg, flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, n_ops: int, peak: float = PEAK_FP32) -> dict:
    """The least time of a kernel: the larger of its bytes (each input read
    once, each output written once) over HBM bandwidth and its float32
    operations over the FP32 peak (``peak``: PEAK_FP64 for float64 ones)."""
    t_bytes, t_ops = n_bytes / PEAK_HBM * 1e3, n_ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
            "operations", "bytes": n_bytes, "ops": n_ops}


def entered_rows(boxes, rows, o, d, t_min, t_stop) -> int:
    """Primitive rows in the boxes (``rows`` each, or a ``(C,)`` tensor of
    per-box counts) that the segments ``[t_min, t_stop]`` enter, summed over
    rays."""
    from pathtrace_tpu_torch.ops.binned import cluster_entries

    per_box = torch.as_tensor(rows, device=o.device).expand(boxes.shape[0])
    n = 0
    for a in range(0, o.shape[0], 4096):
        b = a + 4096
        entered = cluster_entries(o[a:b], d[a:b], t_min[a:b], t_stop[a:b], boxes) < float("inf")
        n += int((entered * per_box).sum())
    return n


def closest_tests(boxes, rows, o, d, t_min, t_max, t_hit) -> int:
    """Triangle tests a closest hit over the boxes needs: every row of every
    box entered before the answer ``t_hit`` (inf on a miss)."""
    return entered_rows(boxes, rows, o, d, t_min, torch.minimum(t_max, t_hit))


def anyhit_tests(boxes, rows, o, d, t_min, t_max, occ) -> int:
    """Triangle tests an any hit over the boxes needs: every entered row of
    an unoccluded ray, one test of an occluded one."""
    free = ~occ
    return entered_rows(boxes, rows, o[free], d[free], t_min[free], t_max[free]) + int(occ.sum())


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
def queued_ms(fn, runs: int = 10, calls: int = 3) -> float:
    """Device milliseconds per call of ``fn`` (many small kernels): as
    :func:`cuda_ms`, but each run's launches queue behind a spin kernel of
    ~20 ms (``torch.cuda._sleep``) enqueued before the start event, so the
    kernels run back to back and the host's launch overhead between them is
    not counted."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


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


def camera_lanes(camera, S, seed, dev):
    """S lanes at bounce 0 on pixels spread over the image: ``(lane, keys,
    bounce, u, o, d)`` with the uniforms ``(9, S)`` and camera rays ``(3, S)``,
    in the camera's dtype."""
    from pathtrace_tpu_torch.utils import rng

    W, H = camera.width, camera.height
    lane = torch.arange(S, dtype=torch.int64, device=dev)
    pixel = (lane * 7919) % (W * H)
    keys = rng.pixel_sample_keys(rng.base_key(seed, dev), pixel, torch.zeros_like(pixel))
    bounce = torch.zeros(S, dtype=torch.int32, device=dev)
    u = rng.per_slot_uniforms(keys, bounce.long(), camera.origin.dtype)
    jitter = torch.stack([u[rng.SLOT_JITTER_X], u[rng.SLOT_JITTER_Y]], dim=1)
    o, d = camera.generate_rays(pixel % W, (H - 1) - pixel // W, jitter)
    return lane, keys, bounce, u, o.contiguous(), d


def lane_states(scene, camera, tables, S, bounces=4, seed=0):
    """Real lane states: S camera rays spread over the image and advanced by
    the twin for ``bounces`` bounces; lane i takes bounce ``i % bounces``."""
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.utils import rng

    dev = scene.device
    lane, keys, bounce, u, o, d = camera_lanes(camera, S, seed, dev)
    f = o.dtype
    state = [torch.ones(S, dtype=torch.bool, device=dev), bounce, o, d,
             torch.ones(S, dtype=f, device=dev), torch.ones(S, dtype=f, device=dev),
             torch.ones((3, S), dtype=f, device=dev), u]
    kw = bounce_kwargs(scene, "mis", 16)
    states = []
    for _ in range(bounces):
        states.append(state)
        res = shade.fused_bounce_reference(tables, *state, **kw)
        b = torch.where(res.live, state[1] + 1, state[1])
        state = [res.live, b, res.next_o, res.next_d, res.next_eta, res.next_pdf,
                 res.next_prefix, rng.per_slot_uniforms(keys, b.long(), f)]
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
                has_tri_lights=scene.has_tri_lights, has_sph_lights=scene.has_sph_lights,
                has_oren_nayar=scene.has_oren_nayar, has_pbr=scene.has_pbr)


def hold_pool_kernels(name, tables, batch, kw, shadow=None):
    """``fused_bounce`` and ``shadow_any_hit`` against their twins, bitwise
    (NaNs equal whatever their payload), at every split the kernels take and
    through the wrappers (the host's split); the shadow rays are the twin's
    (``shadow``: others in their place). Returns ``(ref, {split: (fused ms,
    shadow ms)}, worst abs error)``, raw launches timed into preallocated
    outputs so that the wrappers' allocations do not starve the card."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.ops import shade

    ref = shade.fused_bounce_reference(tables, *batch, **kw)
    so, sd, st = shadow or (ref.next_o, ref.shadow_d, ref.shadow_tmax)
    occ_ref = shade.shadow_any_hit_reference(tables, so, sd, st)
    err = _bitwise(f"fused_bounce {name}", tuple(ref),
                   tuple(shade.fused_bounce(tables, *batch, **kw)), nan_equal=True)
    _bitwise(f"shadow_any_hit {name}", occ_ref, shade.shadow_any_hit(tables, so, sd, st))
    flags = shade.kernel_flags(kw["integrator"], kw["has_tri_lights"], kw["has_sph_lights"],
                               kw["has_oren_nayar"], kw["has_pbr"])
    launch = dict(num_tris=kw["num_tris"], num_lights=kw["num_lights"],
                  max_bounces=kw["max_bounces"], eps=shade.EPS, **flags)
    out = shade.BounceResult(*(torch.empty_like(x) for x in ref))
    occ = torch.empty_like(occ_ref)
    ms = {}
    for split in binding.SPLITS:
        binding.launch_fused_bounce(tables, *batch, out, split=split, **launch)
        err = max(err, _bitwise(f"fused_bounce {name} split {split}", tuple(ref), tuple(out),
                                nan_equal=True))
        binding.launch_shadow_any_hit(tables, so, sd, st, occ, eps=shade.EPS, split=split)
        _bitwise(f"shadow_any_hit {name} split {split}", occ_ref, occ)
        ms[split] = (
            cuda_ms(lambda: binding.launch_fused_bounce(tables, *batch, out, split=split,
                                                        **launch)),
            cuda_ms(lambda: binding.launch_shadow_any_hit(tables, so, sd, st, occ,
                                                          eps=shade.EPS, split=split)))
    return ref, occ_ref, ms, err


def edge_scene(dev):
    """A scene of knife edges for the split sweep: spheres and triangles
    repeated row for row with other materials (equal t, so the lower row
    must win), at row distances 1, 3, 8 and 16 (within one thread's rows and
    across threads at every split), 37 spheres (three NaN padding rows) and
    11 triangles (five zero padding rows), a spherical and a triangle
    light."""
    from pathtrace_tpu_torch.models.materials import Emissive, Lambertian, Mirror
    from pathtrace_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder(dev)
    rng = np.random.default_rng(7)
    mats = (Lambertian((0.8, 0.2, 0.2)), Mirror(roughness=0.3, metallic=1.0),
            Lambertian((0.2, 0.7, 0.3)))
    sph = [(tuple(rng.uniform(-6, 6, 3)), float(rng.uniform(0.4, 1.2))) for _ in range(37)]
    for a, dist in ((2, 1), (4, 3), (5, 8), (6, 16)):
        sph[a + dist] = sph[a]
    for r, (c, rad) in enumerate(sph):
        b.add_sphere(c, rad, mats[r % 3] if r != 36 else Emissive((6.0, 6.0, 6.0)))
    tri = [tuple(tuple(rng.uniform(-6, 6, 3)) for _ in range(3)) for _ in range(11)]
    for a, dist in ((0, 1), (2, 3), (1, 8)):
        tri[a + dist] = tri[a]
    for r, v in enumerate(tri):
        b.add_triangle(*v, mats[(r + 1) % 3] if r != 10 else Emissive((4.0, 4.0, 4.0)))
    return b.build(), sph, tri


def edge_lanes(dev, S=EDGE_S, seed=0, dtype=torch.float32):
    """Lane states aimed at the edge scene: a third at the repeated spheres'
    centers, a third at the repeated triangles' centroids (each from a
    random point 20 away, jittered), a third pointing away from everything
    (all-miss lanes); random depths, 10% not busy; the shadow rays' t_max
    with some lanes set to NaN and to inf. Returns the scene's tables, the
    batch, the bounce kwargs and a count of the lanes whose nearest sphere or
    triangle t is shared by two rows. ``dtype``: the lanes' and the scene's
    (float64: the float32 scene widened)."""
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.render import cast_floats
    from pathtrace_tpu_torch.utils import rng as prng

    scene, sph, tri = edge_scene(dev)
    scene = cast_floats(scene, dtype)
    tables = shade.build_tables(scene)
    g = np.random.default_rng(seed)
    dup_c = np.array([sph[a][0] for a in (2, 4, 5, 6)])
    dup_t = np.array([np.mean(tri[a], axis=0) for a in (0, 2, 1)])
    k = np.arange(S) % 3
    tgt = np.where((k == 0)[:, None], dup_c[g.integers(0, 4, S)], dup_t[g.integers(0, 3, S)])
    tgt = tgt + g.normal(0, 0.05, (S, 3))
    dirs = g.normal(size=(S, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    o = tgt + 20.0 * dirs
    d = np.where((k == 2)[:, None], dirs, -dirs)            # away from the scene, or at it

    def t(a, dt=dtype):
        return torch.tensor(a, dtype=dt, device=dev)

    lane = torch.arange(S, dtype=torch.int64, device=dev)
    bounce = t(g.integers(0, 6, S), torch.int32)
    keys = prng.pixel_sample_keys(prng.base_key(seed, dev), lane, torch.zeros_like(lane))
    u = prng.per_slot_uniforms(keys, bounce.long(), dtype)
    batch = [t(g.random(S) < 0.9, torch.bool), bounce, t(o.T.copy()), t(d.T.copy()),
             t(g.uniform(0.6, 1.5, S)), t(g.uniform(0.1, 3.0, S)), t(g.uniform(0, 1, (3, S))), u]
    batch = [x.contiguous() for x in batch]
    o3, d3 = tuple(batch[2]), tuple(batch[3])
    ts = shade._sphere_ts(tables.sph, o3, d3, shade.EPS)
    ts = torch.where(ts >= shade.EPS, ts, float("inf"))
    ok, tt = shade._tri_hits(tables.tri, o3, d3, float("inf"), shade.EPS)
    tt = torch.where(ok, tt, float("inf"))
    ties = 0
    for x in (ts, tt):
        best = x.min(0).values
        ties += int((((x == best) & torch.isfinite(best)).sum(0) > 1).sum())
    return scene, tables, batch, ties


def edge_shadow(ref):
    """The twin's shadow rays with every 17th t_max set to NaN and every
    29th to inf."""
    st = ref.shadow_tmax.clone()
    st[::17] = float("nan")
    st[::29] = float("inf")
    return ref.next_o, ref.shadow_d, st


def check_kernels(dev):
    """Phase 3: the pool's two kernels against their twins on the card,
    bitwise, at every split: S = 16,384 real lane states of Cornell and
    many_spheres, and the edge lanes. Returns the worst errors, per scene the
    times at every split, and many_spheres' bounds."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade

    worst = {"fused_bounce": 0.0, "shadow_any_hit": 0.0}
    ms, bounds = {}, {}
    for name, scene, camera in (
        ("cornell", scenes.cornell_box(dev), scenes.cornell_camera(128, 128, dev)),
        ("many_spheres", scenes.many_spheres(device=dev),
         scenes.many_spheres_camera(1920, 1080, dev)),
    ):
        tables = shade.build_tables(scene)
        batch = lane_states(scene, camera, tables, SLICE_S)
        kw = bounce_kwargs(scene, "mis", 16)
        ref, occ_ref, ms_split, err = hold_pool_kernels(name, tables, batch, kw)
        worst["fused_bounce"] = max(worst["fused_bounce"], err)
        so, sd, st = ref.next_o, ref.shadow_d, ref.shadow_tmax
        rows = tables.sph.shape[0] + tables.tri.shape[0]
        ms[name] = {"split": tuple(binding.sweep_split(rows, k) for k in KERNELS),
                    "by_split": ms_split,
                    "twin": (cuda_ms(lambda: shade.fused_bounce_reference(tables, *batch, **kw)),
                             cuda_ms(lambda: shade.shadow_any_hit_reference(tables, so, sd,
                                                                            st)))}
        # Work: the closest-hit tests of the busy lanes over every row
        # (fused_bounce; its shading is not counted); every row for an
        # unoccluded shadow query, one test for an occluded one.
        n_tri, n_sph = scene.tri_v0.shape[0], scene.sph_center.shape[0]
        row_ops = n_tri * TRI_OPS + n_sph * SPH_OPS
        query = st >= shade.EPS
        bounds[name] = {
            "fused_bounce": bound(nbytes(*batch, *tables, *ref), int(batch[0].sum()) * row_ops),
            "shadow_any_hit": bound(nbytes(so, sd, st, occ_ref, *tables),
                                    int((query & ~occ_ref).sum()) * row_ops
                                    + int((query & occ_ref).sum()) * SPH_OPS),
        }
        log(f"[kernels] {name} S={SLICE_S} ({rows} rows, host split {ms[name]['split']}): "
            f"fused_bounce and shadow_any_hit ({int(occ_ref.sum())} blocked) bitwise equal to "
            f"their twins on every lane at splits {list(binding.SPLITS)}; ms (fused_bounce, "
            f"shadow_any_hit) by split {json.dumps(ms_split)}; twins {ms[name]['twin']}")

    scene, tables, batch, ties = edge_lanes(dev)
    kw = bounce_kwargs(scene, "mis", 16)
    ref = shade.fused_bounce_reference(tables, *batch, **kw)
    _, occ_ref, _, err = hold_pool_kernels("edge lanes", tables, batch, kw,
                                           shadow=edge_shadow(ref))
    worst["fused_bounce"] = max(worst["fused_bounce"], err)
    hit = ref.shade | (ref.rad_delta != 0).any(0)
    if ties == 0 or hit.all() or not hit.any():
        raise AssertionError(f"edge lanes: {ties} tied lanes, {int(hit.sum())} hit lanes")
    log(f"[kernels] edge lanes S={EDGE_S} ({tables.sph.shape[0]} sphere rows, "
        f"{tables.tri.shape[0]} triangle rows): both kernels bitwise equal to their twins at "
        f"every split; {ties} lanes' nearest t shared by two rows, {int((~hit).sum())} lanes "
        f"that shade nothing, {int(occ_ref.sum())} blocked shadow rays")
    return worst, ms, bounds["many_spheres"]


def lane_rays(scene, camera, tables, S, bounces=4, seed=0):
    """Real rays of the composed path on the route of ``tables``: S camera
    rays spread over the image, advanced by ``bounces`` composed bounces on
    the twins; lane i takes bounce ``i % bounces``. Returns the closest-hit
    rays ``(o, d)`` and the NEE shadow rays ``(o, d, t_max)`` of the same
    lanes, rays as ``(S, 3)``."""
    from pathtrace_tpu_torch import pool
    from pathtrace_tpu_torch.utils import rng

    dev = scene.device
    lane, keys, bounce, u, o, d = camera_lanes(camera, S, seed, dev)
    f = o.dtype
    busy = torch.ones(S, dtype=torch.bool, device=dev)
    eta, pdf = torch.ones(S, dtype=f, device=dev), torch.ones(S, dtype=f, device=dev)
    prefix = torch.ones((3, S), dtype=f, device=dev)
    rays, shadows = [], []
    for _ in range(bounces):
        res = pool.composed_bounce(scene, tables, busy, bounce, o, d, eta, pdf, prefix, u,
                                   integrator="mis", max_bounces=8, twin=True)
        rays.append((o, d))
        shadows.append((res.next_o, res.shadow_d, res.shadow_tmax))
        bounce = torch.where(res.live, bounce + 1, bounce)
        busy, o, d = res.live, res.next_o, res.next_d
        eta, pdf, prefix = res.next_eta, res.next_pdf, res.next_prefix
        u = rng.per_slot_uniforms(keys, bounce.long(), f)
    pick = lane % bounces

    def gather(states, k):
        st = torch.stack([s[k] for s in states])            # (B, 3, S) or (B, S)
        return (st[pick, :, lane] if st.dim() == 3 else st[pick, lane]).contiguous()

    return ((gather(rays, 0), gather(rays, 1)),
            (gather(shadows, 0), gather(shadows, 1), gather(shadows, 2)))


def tie_tables(dev, upper_leaf, route="bvh"):
    """BVH tables (``route="resident"``: resident tables, a cluster a leaf;
    ``route="flat"``: flat tables, 256-row clusters, the upper one cut to
    two real rows and zero padding) of triangles in a given row order (the
    scene builder would reorder them): triangle A (row 0, leaf 0) and its
    copy B (the first row of ``upper_leaf``), both in the plane z = 0, where
    rays from z = 5 along -z (:data:`TIE_RAYS`) hit them at t = 5. Leaf 0
    reaches up to z = 0, so it is entered at t = 5 (the boxes are not
    widened); ``upper_leaf`` also holds a triangle at z = 1 off the rays'
    path, so it is entered first, at t = 4. Every other row is a small
    triangle at z = -5, x = 20. The brute-force answer is A, the lower row:
    a walk must enter leaf 0 at an entry equal to its best t. Returns the
    tables and B's row."""
    from pathtrace_tpu_torch.ops import intersect

    size = CLUSTER_ROWS if route == "flat" else intersect.LEAF
    b = upper_leaf * size
    n = b + 2 if route == "flat" else b + size
    v0 = torch.tensor([20.0, 20.0, -5.0], device=dev).repeat(n, 1)
    e1 = torch.tensor([0.1, 0.0, 0.0], device=dev).repeat(n, 1)
    e2 = torch.tensor([0.0, 0.1, 0.0], device=dev).repeat(n, 1)
    for r in (0, b):                                   # A and B
        v0[r] = torch.tensor([-1.0, -1.0, 0.0])
        e1[r] = torch.tensor([2.0, 0.0, 0.0])
        e2[r] = torch.tensor([0.0, 2.0, 0.0])
    v0[b + 1] = torch.tensor([10.0, 10.0, 1.0])        # lifts the upper leaf's box to z = 1
    nrm = torch.linalg.cross(e1, e2)
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=1, keepdim=True)
    tri = torch.cat([v0, e1, e2, nrm, torch.ones_like(v0[:, :1]), torch.zeros_like(v0)], dim=1)
    empty = tri.new_zeros((0, 8))
    if route == "resident":
        leaf, group, n_groups = intersect.resident_boxes(v0, e1, e2), empty, 0
    elif route == "flat":
        pad = b + size - n                             # inverted: padding rows add nothing
        lo = torch.minimum(torch.minimum(v0, v0 + e1), v0 + e2)
        hi = torch.maximum(torch.maximum(v0, v0 + e1), v0 + e2)
        lo = torch.cat([lo, lo.new_full((pad, 3), float("inf"))]).view(-1, size, 3).amin(dim=1)
        hi = torch.cat([hi, hi.new_full((pad, 3), float("-inf"))]).view(-1, size, 3).amax(dim=1)
        leaf = torch.cat([lo, hi, lo.new_zeros((lo.shape[0], 2))], dim=1).contiguous()
        group, n_groups = empty, 0
    else:
        leaf, group = intersect.bvh_aabbs(v0, e1, e2)
        n_groups = leaf.shape[0] // intersect.GROUP
    tri = torch.cat([tri, tri.new_zeros((leaf.shape[0] * size - n, 16))])
    tables = intersect.Tables(tri=tri.contiguous(), leaf=leaf, group=group, sph=empty,
                              sph_box=empty, tri_rows=n, n_groups=n_groups, route=route)
    return tables, b


TIE_RAYS = ((-0.5, -0.5), (-0.2, 0.1), (0.3, -0.6), (-0.9, 0.8))   # (x, y) inside A and B


def tie_rays(dev):
    """The rays of :func:`tie_tables`: ``(o, d, t_min, t_max, shadow
    t_max)``, from z = 5 along -z over :data:`TIE_RAYS`; shadow t_max 5 (the
    hit lies at t_max) and 4.5 (no hit) in turn."""
    from pathtrace_tpu_torch.ops import shade

    m = len(TIE_RAYS)
    return (torch.tensor([[x, y, 5.0] for x, y in TIE_RAYS], device=dev),
            torch.tensor([[0.0, 0.0, -1.0]] * m, device=dev),
            torch.full((m,), shade.EPS, device=dev), torch.full((m,), float("inf"), device=dev),
            torch.tensor([5.0, 4.5] * (m // 2), device=dev))


def sphere_tie_tables(dev, upper_cluster, dtype=torch.float32):
    """Clustered sphere tables in a given row order (the scene builder would
    reorder the spheres): sphere A (row 0, cluster 0) and its copy B (the
    first row of ``upper_cluster``), unit spheres at (0, 0, -1) whose top
    z = 0 rays from z = 5 along -z (:data:`SPHERE_TIE_RAYS`) reach at t in
    [5, 6), the same t for both. Cluster 0's box reaches up to z = 0, so it
    is entered at about t = 5; ``upper_cluster`` also holds a sphere at z = 3
    off the rays' path, so it is entered first, at about t = 1.5. Every
    other row is a small sphere at (20, 20, -5). The brute-force answer is
    A, the lower row. Returns ``(sph, box, B's row)``: ``Tables.sph`` and
    ``Tables.sph_box`` rows (``intersect.sphere_cluster_boxes``), in
    ``dtype``."""
    import types

    from pathtrace_tpu_torch.ops import intersect

    n = (upper_cluster + 1) * 256
    b = upper_cluster * 256
    center = torch.tensor([20.0, 20.0, -5.0], dtype=dtype, device=dev).repeat(n, 1)
    radius = torch.full((n,), 0.1, dtype=dtype, device=dev)
    mat = torch.zeros(n, dtype=dtype, device=dev)
    for r, m in ((0, 1.0), (b, 2.0)):                  # A and B, told apart by material
        center[r] = torch.tensor([0.0, 0.0, -1.0])
        radius[r], mat[r] = 1.0, m
    center[b + 1], radius[b + 1] = torch.tensor([10.0, 10.0, 3.0]), 0.5   # lifts B's box
    c2 = center * center
    k = c2[:, 0] + c2[:, 1] + c2[:, 2] - radius * radius
    sph = torch.cat([center, k[:, None], (1.0 / radius)[:, None], mat[:, None],
                     center.new_zeros((n, 2))], dim=1).contiguous()
    lo = (center - radius[:, None]).view(-1, 256, 3).amin(dim=1)
    hi = (center + radius[:, None]).view(-1, 256, 3).amax(dim=1)
    box = intersect.sphere_cluster_boxes(types.SimpleNamespace(
        sph_cluster_min=lo, sph_cluster_max=hi, sph_center=center, sph_radius=radius))
    return sph, box, b


SPHERE_TIE_RAYS = ((0.0, 0.0), (0.3, -0.2), (-0.5, 0.4), (0.1, 0.6))   # (x, y) over A and B


def widen_tables(tables, dtype):
    """``tables`` (an ``intersect.Tables``) with its float tables in
    ``dtype`` (float32 widened exactly to float64)."""
    return tables._replace(**{k: getattr(tables, k).to(dtype)
                              for k in ("tri", "leaf", "group", "sph", "sph_box")})


def small_tie_tables(dev, dtype=torch.float32):
    """Small-route tables of 12 triangles and 40 spheres in a given row
    order, for rays from z = 5 along -z over :data:`SMALL_TIE_RAYS`. The
    first four rays hit :func:`tie_tables`' triangle A (row 7) and its copy
    (row 10), and each a unit sphere centred 1 below its (x, y) (rows 3, 12,
    25, 33), all at t = 5 exactly (the coordinates are binary fractions, so
    both tests round to 5): the triangle A must win, since a sphere wins only
    when strictly nearer and equal t in two triangles goes to the lower row.
    The last two pass beside the triangles and hit the unit sphere at (3, 0,
    -1) and its copy (rows 5 and 30) at equal t: the lower row must win.
    Every other row is a small triangle or sphere off the rays' paths.
    Returns the tables (in ``dtype``) and the expected ``(t, global prim
    id)`` of each ray (t None: any)."""
    from pathtrace_tpu_torch.ops import intersect

    n_tri, n_sph = 12, 40
    v0 = torch.tensor([20.0, 20.0, -5.0], device=dev).repeat(n_tri, 1)
    e1 = torch.tensor([0.1, 0.0, 0.0], device=dev).repeat(n_tri, 1)
    e2 = torch.tensor([0.0, 0.1, 0.0], device=dev).repeat(n_tri, 1)
    for r in (7, 10):                                  # A and its copy
        v0[r] = torch.tensor([-1.0, -1.0, 0.0])
        e1[r] = torch.tensor([2.0, 0.0, 0.0])
        e2[r] = torch.tensor([0.0, 2.0, 0.0])
    nrm = torch.linalg.cross(e1, e2)
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=1, keepdim=True)
    mat = torch.arange(n_tri, device=dev, dtype=torch.float32)[:, None]
    tri = torch.cat([v0, e1, e2, nrm, mat, torch.zeros_like(v0)], dim=1)
    center = torch.tensor([20.0, 20.0, -5.0], device=dev).repeat(n_sph, 1)
    radius = torch.full((n_sph,), 0.1, device=dev)
    rows = (3, 12, 25, 33, 5, 30)
    for r, (x, y) in zip(rows, SMALL_TIE_RAYS[:4] + ((3.0, 0.0), (3.0, 0.0))):
        center[r] = torch.tensor([x, y, -1.0])
        radius[r] = 1.0
    c2 = center * center
    k = c2[:, 0] + c2[:, 1] + c2[:, 2] - radius * radius
    sph = torch.cat([center, k[:, None], (1.0 / radius)[:, None],
                     torch.arange(n_sph, device=dev, dtype=torch.float32)[:, None] + 100.0,
                     center.new_zeros((n_sph, 2))], dim=1)
    tri, sph = tri.to(dtype), sph.to(dtype)
    empty = tri.new_zeros((0, 8))
    tables = intersect.Tables(tri=tri.contiguous(), leaf=empty, group=empty,
                              sph=sph.contiguous(), sph_box=empty, tri_rows=n_tri, n_groups=0,
                              route="small")
    return tables, [(5.0, 7)] * 4 + [(5.0, n_tri + 5), (None, n_tri + 5)]


SMALL_TIE_RAYS = ((-0.5, -0.5), (0.25, -0.75), (-0.75, 0.5), (-0.25, 0.0),   # over A
                  (3.0, 0.0), (3.0, 0.5))                                     # beside it


def hold_bvh_kernels(what, tables, closest, shadow):
    """The BVH pair through raw launches at every team size, with and
    without per-ray counters: the hits bitwise equal to the
    brute-force twins' (``closest`` = ``(o, d, t_min, t_max, twin's
    4-tuple)``, ``shadow`` = ``(o, d, t_min, t_max, twin's occlusion)``),
    the counts equal to ``bvh_traversal_reference``'s. Outputs are scrubbed
    before each launch. Returns the model's closest and any-hit results."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.ops import intersect

    o, d, lo, hi, ref = closest
    so, sd, slo, st, ref_occ = shadow
    model = intersect.bvh_traversal_reference(tables, o, d, lo, hi, chunk=o.shape[0])
    _bitwise(f"{what}: the closest walk (bvh_traversal_reference) vs brute force", ref,
             model[:4])
    a_model = intersect.bvh_traversal_reference(tables, so, sd, slo, st, anyhit=True,
                                                chunk=so.shape[0])
    _bitwise(f"{what}: the any-hit walk vs brute force", ref_occ, a_model[0])
    out = tuple(torch.empty_like(x) for x in ref)
    counts = tuple(torch.empty_like(x) for x in model[4:])
    occ = torch.empty_like(ref_occ)
    a_counts = tuple(torch.empty_like(x) for x in a_model[1:])

    def scrub():
        for x in out + counts + a_counts:
            x.fill_(float("nan") if x.is_floating_point() else -7)
        occ.copy_(~ref_occ)

    for team in binding.TEAMS:
        how = f"{what}, team {team}"
        scrub()
        binding.launch_bvh_closest(tables, o, d, lo, hi, *out, team=team)
        binding.launch_bvh_anyhit(tables, so, sd, slo, st, occ, team=team)
        _bitwise(f"bvh_closest, {how}", ref, out)
        _bitwise(f"bvh_anyhit, {how}", ref_occ, occ)
        scrub()
        binding.launch_bvh_closest(tables, o, d, lo, hi, *out, counts=counts, team=team)
        binding.launch_bvh_anyhit(tables, so, sd, slo, st, occ, counts=a_counts, team=team)
        _bitwise(f"bvh_closest with counters, {how}", ref + model[4:], out + counts)
        _bitwise(f"bvh_anyhit with counters, {how}", (ref_occ,) + a_model[1:],
                 (occ,) + a_counts)
    return model, a_model


def bvh_edge_cases(dev, tables, o, d, so, sd, lo):
    """The BVH pair on edge lanes: 1,024 of the mesh lanes with t_max NaN,
    -1, 0 (below t_min), t_min itself and inf; and the tie case
    (:func:`tie_tables`, the upper leaf in the same group and in the next
    one), where the kernels must return the lower row, with shadow t_max 5
    (the hit lies at t_max) and 4.5 (no hit). All in the lanes' dtype."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.ops import intersect, shade

    n = 1024
    hi = torch.full((n,), float("inf"), dtype=o.dtype, device=dev)
    st = torch.full((n,), 6.0, dtype=o.dtype, device=dev)
    for k, v in enumerate((float("nan"), -1.0, 0.0, shade.EPS, float("inf"))):
        hi[k::7] = v
        st[k::7] = v
    e = (o[:n], d[:n], lo[:n], hi), (so[:n], sd[:n], lo[:n], st)
    hold_bvh_kernels("edge lanes", tables, (*e[0], intersect.bvh_closest_reference(tables, *e[0])),
                     (*e[1], intersect.bvh_anyhit_reference(tables, *e[1])))
    to, td, tlo, thi, tst = (x.to(o.dtype) for x in tie_rays(dev))
    for upper in (1, 16):
        tt, b = tie_tables(dev, upper)
        tt = widen_tables(tt, o.dtype)
        ref = intersect.bvh_closest_reference(tt, to, td, tlo, thi)
        if not ((ref[0] == 5.0).all() and (ref[1] == 0).all()):
            raise AssertionError(f"tie case (upper leaf {upper}): twin gave {ref[:2]}")
        model, a_model = hold_bvh_kernels(
            f"tie case, upper leaf {upper}", tt, (to, td, tlo, thi, ref),
            (to, td, tlo, tst, intersect.bvh_anyhit_reference(tt, to, td, tlo, tst)))
        if not ((model[5] == 2).all() and torch.equal(a_model[0], tst == 5.0)):
            raise AssertionError(f"tie case (upper leaf {upper}): leaves swept {model[5]}, "
                                 f"occlusion {a_model[0]}")
    log(f"[mesh-kernels] edge lanes ({o.dtype}): bvh_closest and bvh_anyhit bitwise equal to "
        f"their twins, their counts to the model's, at teams {list(binding.TEAMS)}, on {n} mesh "
        f"lanes with t_max NaN, -1, 0, t_min, inf, and the tie case (B at row 128 and at row "
        f"2048, entered first): row 0, both leaves swept")


def check_mesh_kernels(dev, scene, camera):
    """Phase 3b: the mesh path's four kernels against their twins on the
    card, bitwise; the BVH pair also at every team size, with per-ray
    counters held against the traversal model, on edge lanes and the tie case; ``bvh_closest(counters
    =True)`` against the model's per-span sums. Times, bounds and the BVH
    pair's per-ray work."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.ops import intersect, shade

    tables = intersect.build_tables(scene)
    t0 = time.perf_counter()
    (o, d), (so, sd, st) = lane_rays(scene, camera, tables, MESH_S)
    torch.cuda.synchronize()
    log(f"[mesh-kernels] {scene.num_tris} triangles, {tables.n_groups} groups; lane "
        f"states from twin bounces in {time.perf_counter() - t0:.2f} s")
    S = MESH_S
    lo = torch.full((S,), shade.EPS, device=dev)
    hi = torch.full((S,), float("inf"), device=dev)
    no_tris = tables.tri[:0]
    worst, ms, extra = {}, {}, {}

    ref_s = intersect.sphere_closest_reference(tables.sph, o, d, lo, hi)
    worst["sphere_closest"] = _bitwise("sphere_closest", ref_s,
                                       intersect.sphere_closest(tables.sph, o, d, lo, hi))
    hi_t = torch.minimum(hi, ref_s[0])                       # as intersect() caps it
    ref_t = intersect.bvh_closest_reference(tables, o, d, lo, hi_t)
    worst["bvh_closest"] = _bitwise("bvh_closest", ref_t,
                                    intersect.bvh_closest(tables, o, d, lo, hi_t))
    ref_occ = intersect.bvh_anyhit_reference(tables, so, sd, lo, st)
    worst["bvh_anyhit"] = _bitwise("bvh_anyhit", ref_occ,
                                   intersect.bvh_anyhit(tables, so, sd, lo, st))
    ref_socc = intersect.any_hit_reference(tables.sph, no_tris, so, sd, lo, st)
    worst["any_hit"] = _bitwise("any_hit", ref_socc,
                                intersect.any_hit(tables.sph, no_tris, so, sd, lo, st))
    log(f"[mesh-kernels] sphere_closest, bvh_closest ({int((ref_t[1] >= 0).sum())} hits), "
        f"bvh_anyhit ({int(ref_occ.sum())} blocked of {int((st >= shade.EPS).sum())} queries) and "
        f"any_hit bitwise equal to their twins on all {S} lanes (max abs error "
        f"{max(worst.values()):.4g})")

    # The BVH pair at every team size, with counters.
    model, a_model = hold_bvh_kernels("config-4 lanes", tables, (o, d, lo, hi_t, ref_t),
                                      (so, sd, lo, st, ref_occ))
    shade.LAUNCHES.clear()
    sums = tuple(intersect.bvh_span_sums(c, S) for c in model[4:])
    worst["bvh_closest_counters"] = _bitwise(
        "bvh_closest(counters=True) vs the model's per-span sums", ref_t + sums,
        intersect.bvh_closest(tables, o, d, lo, hi_t, counters=True))
    counter_launches = shade.LAUNCHES["bvh_closest_counters"]
    bvh_edge_cases(dev, tables, o, d, so, sd, lo)

    # Kernels: raw launches into preallocated outputs; twins: fewer runs
    # (brute force over 70k triangles takes a large share of a second).
    f32, i32 = torch.float32, torch.int32
    out = (torch.empty(S, device=dev), torch.empty(S, dtype=i32, device=dev),
           torch.empty((S, 3), dtype=f32, device=dev), torch.empty(S, dtype=i32, device=dev))
    counts = (torch.empty(S, dtype=i32, device=dev), torch.empty(S, dtype=i32, device=dev))
    occ = torch.empty(S, dtype=torch.bool, device=dev)
    slow = dict(runs=3, calls=1)
    ms["sphere_closest"] = (
        cuda_ms(lambda: binding.launch_sphere_closest(tables.sph, o, d, lo, hi, *out)),
        cuda_ms(lambda: intersect.sphere_closest_reference(tables.sph, o, d, lo, hi)))
    ms["bvh_closest"] = (
        cuda_ms(lambda: binding.launch_bvh_closest(tables, o, d, lo, hi_t, *out)),
        cuda_ms(lambda: intersect.bvh_closest_reference(tables, o, d, lo, hi_t), **slow))
    ms["bvh_anyhit"] = (
        cuda_ms(lambda: binding.launch_bvh_anyhit(tables, so, sd, lo, st, occ)),
        cuda_ms(lambda: intersect.bvh_anyhit_reference(tables, so, sd, lo, st), **slow))
    ms["bvh_closest_counters"] = (
        cuda_ms(lambda: binding.launch_bvh_closest(tables, o, d, lo, hi_t, *out, counts=counts)),
        cuda_ms(lambda: intersect.bvh_traversal_reference(tables, o, d, lo, hi_t, chunk=S),
                **slow))
    ms["any_hit"] = (
        cuda_ms(lambda: binding.launch_any_hit(tables.sph, no_tris, so, sd, lo, st, occ)),
        cuda_ms(lambda: intersect.any_hit_reference(tables.sph, no_tris, so, sd, lo, st)))
    # The BVH pair at every team size.
    by_team = {team: (
        cuda_ms(lambda: binding.launch_bvh_closest(tables, o, d, lo, hi_t, *out, team=team)),
        cuda_ms(lambda: binding.launch_bvh_anyhit(tables, so, sd, lo, st, occ, team=team)))
        for team in binding.TEAMS}
    log("[mesh-kernels] ms kernel vs twin at S=65536: " + ", ".join(
        f"{k} {a:.4f} vs {b:.4f}" for k, (a, b) in ms.items()))

    n_sph = tables.sph.shape[0]
    query = st >= shade.EPS
    rays, closest_out = nbytes(o, d, lo, hi), nbytes(*out)
    need_c = closest_tests(tables.leaf, intersect.LEAF, o, d, lo, hi_t, ref_t[0])
    need_a = anyhit_tests(tables.leaf, intersect.LEAF, so, sd, lo, st, ref_occ)
    bounds = {
        "sphere_closest": bound(rays + nbytes(tables.sph) + closest_out, S * n_sph * SPH_OPS),
        "bvh_closest": bound(rays + nbytes(tables.tri, tables.leaf, tables.group) + closest_out,
                             TRI_OPS * need_c),
        "bvh_closest_counters": bound(
            rays + nbytes(tables.tri, tables.leaf, tables.group) + closest_out + nbytes(*counts),
            TRI_OPS * need_c),
        "bvh_anyhit": bound(nbytes(so, sd, lo, st, occ, tables.tri, tables.leaf, tables.group),
                            TRI_OPS * need_a),
        "any_hit": bound(nbytes(so, sd, lo, st, occ, tables.sph),
                         SPH_OPS * (int((query & ~ref_socc).sum()) * n_sph
                                    + int((query & ref_socc).sum()))),
    }
    log("[mesh-kernels] bounds: " + json.dumps(bounds))

    def per_ray(res, need):
        """Mean groups visited, leaves swept and triangle tests a ray, beside
        the tests the bound counts."""
        visited, swept = res[-2:]
        return {"groups": visited.double().mean().item(), "leaves": swept.double().mean().item(),
                "tests": swept.double().mean().item() * intersect.LEAF, "bound_tests": need / S}

    work = {"bvh_closest": per_ray(model, need_c), "bvh_anyhit": per_ray(a_model, need_a)}
    for which, k in enumerate(("bvh_closest", "bvh_anyhit")):
        extra[k] = {"team": binding.BVH_TEAM[k],
                    "ms_by_team": {t: v[which] for t, v in by_team.items()},
                    "per_ray": work[k]}
    log(f"[mesh-kernels] BVH pair (closest, any hit) ms by team {json.dumps(by_team)}; host "
        f"team {binding.BVH_TEAM['bvh_closest']}, {binding.BVH_TEAM['bvh_anyhit']}; per ray "
        f"{json.dumps(work)}")
    lanes = dict(o=o, d=d, lo=lo, hi_t=hi_t, ref_t=ref_t, so=so, sd=sd, st=st, ref_occ=ref_occ)
    return worst, ms, bounds, lanes, extra, counter_launches


def _bitwise(name, ref, got, nan_equal=False) -> float:
    """Raise unless ``got`` equals ``ref`` bit for bit (a tensor or a tuple of
    them; ``nan_equal``: two NaNs are equal whatever their payload); returns
    the largest absolute difference of the float outputs on hit lanes (0
    when they are equal)."""
    torch.cuda.synchronize()
    ref, got = (ref, got) if isinstance(ref, tuple) else ((ref,), (got,))
    err = 0.0
    for a, b in zip(ref, got):
        if a.is_floating_point():
            bits = torch.int32 if a.dtype == torch.float32 else torch.int64
            bad = a.view(bits) != b.view(bits)
            if nan_equal:
                bad &= ~(a.isnan() & b.isnan())
            live = torch.isfinite(a)
            if live.any():
                err = max(err, (a - b)[live].abs().max().item())
        else:
            bad = a != b
        if bad.any():
            lanes = bad.any(1) if bad.dim() == 2 else bad
            raise AssertionError(f"{name}: {int(lanes.sum())} of {lanes.shape[0]} lanes differ")
    return err


BINNED_TIE_PAIRS = ((31, 32), (259, 387))   # (A, B) rows of the binned tie case
BINNED_EDGE_S = 2048        # rays of an edge wave


def binned_tie_tables(dev):
    """Binned tables of two 256-row clusters in a given row order: each holds
    a triangle A and its copy B in a higher row with another material
    (:data:`BINNED_TIE_PAIRS`), in the plane z = 0, cluster 1's pair shifted
    by 10 in x, so rays from z = 5 along -z (:data:`TIE_RAYS`) hit both at
    t = 5. In cluster 0 a team of K >= 2 tests B (row 32, thread 0) on a
    lower thread than A (row 31, thread K - 1); in cluster 1 one thread
    tests both (rows 259 and 387) at every K. Every other row is a small
    triangle at z = -5, x = 20. The twin's answer is A, the lower row.
    Returns the tables and the rays ``(o, d, key)``, keyed to their pair's
    cluster."""
    from pathtrace_tpu_torch.ops import intersect

    n = 2 * CLUSTER_ROWS
    v0 = torch.tensor([20.0, 20.0, -5.0], device=dev).repeat(n, 1)
    e1 = torch.tensor([0.1, 0.0, 0.0], device=dev).repeat(n, 1)
    e2 = torch.tensor([0.0, 0.1, 0.0], device=dev).repeat(n, 1)
    mat = torch.ones(n, device=dev)
    for c, (a, b) in enumerate(BINNED_TIE_PAIRS):
        for r in (a, b):
            v0[r] = torch.tensor([10.0 * c - 1.0, -1.0, 0.0])
            e1[r] = torch.tensor([2.0, 0.0, 0.0])
            e2[r] = torch.tensor([0.0, 2.0, 0.0])
        mat[b] = 2.0
    nrm = torch.linalg.cross(e1, e2)
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=1, keepdim=True)
    tri = torch.cat([v0, e1, e2, nrm, mat[:, None], torch.zeros_like(v0)], dim=1).contiguous()
    pts = torch.stack([v0, v0 + e1, v0 + e2]).view(3, 2, CLUSTER_ROWS, 3)
    empty = tri.new_zeros((0, 8))
    tables = intersect.Tables(tri=tri, leaf=intersect._widen(pts.amin(dim=(0, 2)),
                                                             pts.amax(dim=(0, 2))),
                              group=empty, sph=empty, sph_box=empty, tri_rows=n, n_groups=0,
                              route="binned")
    m = len(TIE_RAYS)
    o = torch.tensor([[x + 10.0 * c, y, 5.0] for c in range(2) for x, y in TIE_RAYS],
                     device=dev)
    d = torch.tensor([[0.0, 0.0, -1.0]] * (2 * m), device=dev)
    key = torch.tensor([0] * m + [1] * m, dtype=torch.int32, device=dev)
    return tables, o, d, key


def capture_rounds(driver, *args, **kw):
    """``(result, waves)``: ``driver(*args, **kw)`` (a binned driver of
    ``ops/binned.py`` on the kernels) and the inputs ``(o, d, t_min, t_up,
    key)`` of every round kernel it called, in order, taken by wrapping
    ``binned.round_closest``/``round_anyhit`` for the call."""
    from pathtrace_tpu_torch.ops import binned

    waves = []
    rounds = binned.round_closest, binned.round_anyhit

    def capture(round_fn):
        def wrapped(tables, *wave):
            waves.append(wave)      # fresh gathers: the driver never writes them again
            return round_fn(tables, *wave)
        return wrapped

    binned.round_closest, binned.round_anyhit = (capture(f) for f in rounds)
    try:
        result = driver(*args, **kw)
    finally:
        binned.round_closest, binned.round_anyhit = rounds
    return result, waves


def binned_edge_wave(wave, t_hit, n_clusters, n=BINNED_EDGE_S):
    """Edge rays of a sorted round wave ``(o, d, t_min, t_up, key)`` whose
    twin gave ``t_hit``: ``n`` of its rays, evenly spaced in sorted order
    (so keys change mid-warp), with, by ray index mod 16: t_up NaN (0), -1
    (1), 0 (2), inf (4); the sentinel keys -1 (3), C (7) and C + 3 (11) and
    the next cluster's key (5) mixed in; on hit rays t_min at the hit's t
    (6), t_up at it (8), or both (9)."""
    pick = torch.linspace(0, wave[4].shape[0] - 1, n, device=wave[4].device).long()
    o, d, lo, hi, key = (x[pick].clone() for x in wave)
    t = t_hit[pick]
    j = torch.arange(n, device=key.device) % 16
    hit = torch.isfinite(t)
    for m, v in ((0, float("nan")), (1, -1.0), (2, 0.0), (4, float("inf"))):
        hi[j == m] = v
    for m, v in ((3, -1), (7, n_clusters), (11, n_clusters + 3)):
        key[j == m] = v
    key = torch.where(j == 5, (key + 1) % n_clusters, key).to(torch.int32)
    lo = torch.where(hit & ((j == 6) | (j == 9)), t, lo)
    hi = torch.where(hit & ((j == 8) | (j == 9)), t, torch.where(j == 6, float("inf"), hi))
    return o, d, lo.contiguous(), hi.contiguous(), key.contiguous()


def hold_binned_rounds(what, tb, closest_waves, anyhit_waves):
    """Both round kernels through raw launches at every team size (1-32) on
    each wave, bitwise equal to their twins, outputs scrubbed before each
    launch. Returns the twins' results."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.ops import binned

    refs_c = [binned.round_closest_reference(tb, *w) for w in closest_waves]
    refs_a = [binned.round_anyhit_reference(tb, *w) for w in anyhit_waves]
    for team in binding.TEAMS:
        for j, (w, ref) in enumerate(zip(closest_waves, refs_c)):
            out = tuple(torch.full_like(x, float("nan") if x.is_floating_point() else -7)
                        for x in ref)
            binding.launch_binned_round_closest(tb, *w, *out, team=team)
            _bitwise(f"binned_round_closest, {what} wave {j}, team {team}", ref, out)
        for j, (w, ref) in enumerate(zip(anyhit_waves, refs_a)):
            occ = ~ref
            binding.launch_binned_round_anyhit(tb, *w, occ, team=team)
            _bitwise(f"binned_round_anyhit, {what} wave {j}, team {team}", ref, occ)
    return refs_c, refs_a


def binned_edge_cases(dev, tb, rc, ra, t_rc, t_ra):
    """The round kernels at every team on the edge waves of the first
    closest and any-hit rounds (:func:`binned_edge_wave`) and on the tie
    case (:func:`binned_tie_tables`), where the lower row must win; the
    closest driver on the tie tables against brute force. All in the
    dtype of ``tb``."""
    from pathtrace_tpu_torch.ops import binned, intersect, shade

    dtype = tb.tri.dtype
    n_clusters = tb.leaf.shape[0]
    edges = [binned_edge_wave(rc, t_rc, n_clusters), binned_edge_wave(ra, t_ra, n_clusters)]
    refs_c, _ = hold_binned_rounds("edge", tb, edges, edges)
    tt, to, td, key = binned_tie_tables(dev)
    tt, to, td = widen_tables(tt, dtype), to.to(dtype), td.to(dtype)
    m = to.shape[0]
    tlo = torch.full((m,), shade.EPS, dtype=dtype, device=dev)
    thi = torch.full((m,), float("inf"), dtype=dtype, device=dev)
    # The hit at t_max, or short.
    tst = torch.tensor([5.0, 4.5] * (m // 2), dtype=dtype, device=dev)
    (ref,), (occ,) = hold_binned_rounds("tie", tt, [(to, td, tlo, thi, key)],
                                        [(to, td, tlo, tst, key)])
    lower = torch.tensor([a for a, _ in BINNED_TIE_PAIRS], device=dev).repeat_interleave(m // 2)
    if not ((ref[0] == 5.0).all() and torch.equal(ref[1], lower.to(torch.int32))
            and (ref[3] == 1).all() and torch.equal(occ, tst == 5.0)):
        raise AssertionError(f"binned tie case: twin gave {ref}, occlusion {occ}")
    _bitwise("binned closest driver on the tie tables vs brute force",
             intersect.triangle_closest_reference(tt, to, td, tlo, thi),
             binned.triangle_closest_binned(tt, to, td, tlo, thi))
    dead = sum(int(((w[4] < 0) | (w[4] >= n_clusters)).sum()) for w in edges)
    hits = sum(int((r[1] >= 0).sum()) for r in refs_c)
    log(f"[traversal-kernels] {dtype} edge waves ({len(edges)} x {BINNED_EDGE_S} rays, {dead} "
        f"sentinel keys, {hits} hits; t_up NaN, -1, 0, inf; t_min and t_up at the hit's t) and "
        f"the tie case (rows {BINNED_TIE_PAIRS}): both round kernels bitwise equal to their "
        f"twins at every team, the tie to the lower row")


def hold_resident_kernels(what, tables, closest, shadow):
    """The resident pair through raw launches at every team size, the
    closest hit with its entries cached (where they fit) and recomputed:
    bitwise equal to the brute-force twins (``closest`` = ``(o, d, t_min,
    t_max, twin's 4-tuple)``, ``shadow`` = ``(o, d, t_min, t_max, twin's
    occlusion)``), outputs scrubbed before each launch; the walk model
    (``resident_walk_reference``) equal to the twins too. Returns the
    model's closest and any-hit results."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.ops import intersect

    o, d, lo, hi, ref = closest
    so, sd, slo, st, ref_occ = shadow
    model = intersect.resident_walk_reference(tables, o, d, lo, hi)
    _bitwise(f"{what}: the resident closest walk vs brute force", ref, model[:4])
    a_model = intersect.resident_walk_reference(tables, so, sd, slo, st, anyhit=True)
    _bitwise(f"{what}: the resident any-hit walk vs brute force", ref_occ, a_model[0])
    n_boxes, size = tables.leaf.shape[0], tables.leaf.element_size()
    for team in binding.TEAMS:
        for cached in (True, False):
            if cached and not binding.resident_cached(n_boxes, team, size):
                continue
            out = tuple(torch.full_like(x, float("nan") if x.is_floating_point() else -7)
                        for x in ref)
            binding.launch_resident_closest(tables, o, d, lo, hi, *out, team=team, cached=cached)
            _bitwise(f"resident_closest, {what}, team {team}, cached {cached}", ref, out)
        occ = ~ref_occ
        binding.launch_resident_anyhit(tables, so, sd, slo, st, occ, team=team)
        _bitwise(f"resident_anyhit, {what}, team {team}", ref_occ, occ)
    return model, a_model


def resident_edge_cases(dev, tr, closest, shadow, n=1024):
    """The resident pair at every team and mode on edge lanes (``n`` of the
    mesh lanes with t_max NaN, -1, 0, t_min itself and inf; on hit lanes
    t_min, t_max or both at the hit's t), on the tables padded with
    inverted boxes to :data:`RESIDENT_PADDED_BOXES` (so that at the host's
    team the closest hit recomputes its entries, and caches them at 32),
    and on the tie case (:func:`tie_tables` on resident tables, the upper
    cluster next to cluster 0 and 16 clusters up), where the kernels must
    return the lower row, with shadow t_max 5 (the hit lies at t_max) and
    4.5 (no hit). ``closest`` and ``shadow`` are the lanes as
    :func:`hold_resident_kernels` takes them. All in the dtype of ``tr``
    (in float64 the padded tables recompute their entries at every team)."""
    from pathtrace_tpu_torch.ops import intersect

    dtype = tr.tri.dtype
    o, d, lo, hi_t, ref_t = closest
    so, sd, _, st, _ = shadow
    elo, hi = edge_ranges(lo, hi_t, ref_t[0], n)
    sst = st[:n].clone()
    for k, v in enumerate(edge_t_max()):
        sst[k::9] = v
    e = (o[:n], d[:n], elo, hi), (so[:n], sd[:n], elo, sst)
    hold_resident_kernels("edge lanes", tr, (*e[0], intersect.triangle_closest_reference(tr, *e[0])),
                          (*e[1], intersect.bvh_anyhit_reference(tr, *e[1])))
    # Padded with inverted boxes and zero rows: the same answers.
    pad = RESIDENT_PADDED_BOXES - tr.leaf.shape[0]
    inverted = torch.tensor([float("inf")] * 3 + [float("-inf")] * 3 + [0.0, 0.0], dtype=dtype,
                            device=dev)
    big = tr._replace(leaf=torch.cat([tr.leaf, inverted.expand(pad, 8)]).contiguous(),
                      tri=torch.cat([tr.tri, tr.tri.new_zeros((pad * intersect.LEAF, 16))]))
    hold_resident_kernels("padded tables", big, closest, shadow)
    del big
    to, td, tlo, thi, tst = (x.to(dtype) for x in tie_rays(dev))
    for upper in (1, 16):
        tt, _ = tie_tables(dev, upper, route="resident")
        tt = widen_tables(tt, dtype)
        ref = intersect.triangle_closest_reference(tt, to, td, tlo, thi)
        if not ((ref[0] == 5.0).all() and (ref[1] == 0).all()):
            raise AssertionError(f"resident tie case (upper cluster {upper}): twin gave {ref[:2]}")
        model, a_model = hold_resident_kernels(
            f"tie case, upper cluster {upper}", tt, (to, td, tlo, thi, ref),
            (to, td, tlo, tst, intersect.bvh_anyhit_reference(tt, to, td, tlo, tst)))
        if not ((model[4] == 2).all() and torch.equal(a_model[0], tst == 5.0)):
            raise AssertionError(f"resident tie case (upper cluster {upper}): clusters visited "
                                 f"{model[4]}, occlusion {a_model[0]}")
    log(f"[traversal-kernels] {dtype} resident edge lanes ({n} lanes: t_max NaN, -1, 0, t_min, "
        f"inf; t_min, t_max or both at the hit's t), the tables padded to {RESIDENT_PADDED_BOXES} "
        f"boxes ({o.shape[0]} lanes) and the tie case (B at row 128 and at row 2048, entered first): "
        f"both kernels bitwise equal to brute force at every team and mode, the walk model "
        f"too, the tie to row 0 with both clusters visited")


def check_traversal_kernels(dev, scene, lanes):
    """Phase 3d: the binned and resident kernels against their twins on the
    card, bitwise, at the mesh lanes of phase 3b: the round kernels at every
    team size on every round's sorted wave of one call of each binned
    driver (the first round's and every tail round's), on edge waves and on
    the tie case; the binned drivers against the same drivers on the round
    twins; both drivers against the brute-force twin on every lane; the
    resident kernels at every team and mode on the lanes, edge lanes,
    padded tables and the tie case (:func:`hold_resident_kernels`). The
    round kernels timed at every team on the first round's wave and summed
    over the driver call's waves, the resident pair at every team and
    mode."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.ops import binned, intersect

    o, d, lo, hi_t, ref_t = (lanes[k] for k in ("o", "d", "lo", "hi_t", "ref_t"))
    so, sd, st, ref_occ = (lanes[k] for k in ("so", "sd", "st", "ref_occ"))
    S = o.shape[0]
    tb = intersect.build_tables(scene, "binned")
    tr = intersect.build_tables(scene, "resident")
    f32, i32 = torch.float32, torch.int32
    worst, ms, bounds = {}, {}, {}
    slow = dict(runs=3, calls=1)

    def outs(n):
        return (torch.empty(n, device=dev), torch.empty(n, dtype=i32, device=dev),
                torch.empty((n, 3), dtype=f32, device=dev), torch.empty(n, dtype=i32, device=dev))

    # The whole binned drivers on the kernels (every round's wave captured),
    # on the round twins, brute force.
    stats = {"closest": {}, "anyhit": {}}
    got_c, waves_c = capture_rounds(binned.triangle_closest_binned, tb, o, d, lo, hi_t,
                                    stats=stats["closest"])
    _bitwise("binned closest driver vs its round twin",
             binned.triangle_closest_binned(tb, o, d, lo, hi_t, round_twin=True), got_c)
    _bitwise("binned closest driver vs brute force", ref_t, got_c)
    got_a, waves_a = capture_rounds(binned.triangle_anyhit_binned, tb, so, sd, lo, st,
                                    stats=stats["anyhit"])
    _bitwise("binned any-hit driver vs its round twin",
             binned.triangle_anyhit_binned(tb, so, sd, lo, st, round_twin=True), got_a)
    _bitwise("binned any-hit driver vs brute force", ref_occ, got_a)
    for k, waves in (("closest", waves_c), ("anyhit", waves_a)):
        sizes = [w[4].shape[0] for w in waves]
        if (len(sizes), sum(sizes)) != (stats[k]["rounds"], stats[k]["ray_rounds"]):
            raise AssertionError(f"binned {k}: captured {len(sizes)} waves of {sum(sizes)} rays, "
                                 f"the driver counted {stats[k]}")
    # One round of each binned kernel through its wrapper (the host's team),
    # then both raw at every team on every captured wave: the first round's
    # wave (the drivers' first sorted wave, no hit yet) and every tail wave.
    rc, ra = waves_c[0], waves_a[0]
    refs_c, refs_a = hold_binned_rounds("driver call", tb, waves_c, waves_a)
    ref_rc, ref_ra = refs_c[0], refs_a[0]
    worst["binned_round_closest"] = _bitwise("binned_round_closest", ref_rc,
                                             binned.round_closest(tb, *rc))
    worst["binned_round_anyhit"] = _bitwise("binned_round_anyhit", ref_ra,
                                            binned.round_anyhit(tb, *ra))
    binned_edge_cases(dev, tb, rc, ra, ref_rc[0],
                      binned.round_closest_reference(tb, *ra)[0])
    # The resident kernels against brute force: through the wrappers (the
    # host's team and mode), then raw at every team and mode on the lanes,
    # edge lanes, padded tables and the tie case.
    worst["resident_closest"] = _bitwise("resident_closest", ref_t,
                                         intersect.resident_closest(tr, o, d, lo, hi_t))
    worst["resident_anyhit"] = _bitwise("resident_anyhit", ref_occ,
                                        intersect.resident_anyhit(tr, so, sd, lo, st))
    r_lanes = (o, d, lo, hi_t, ref_t), (so, sd, lo, st, ref_occ)
    r_model, r_a_model = hold_resident_kernels("config-4 lanes", tr, *r_lanes)
    resident_edge_cases(dev, tr, *r_lanes)

    # The round kernels at every team: the first round's wave, and the sum
    # over the driver call's waves (kernels only, into preallocated outputs).
    outs_c = [outs(w[4].shape[0]) for w in waves_c]
    occs_a = [torch.empty(w[4].shape[0], dtype=torch.bool, device=dev) for w in waves_a]

    def launch_c(j, team):
        binding.launch_binned_round_closest(tb, *waves_c[j], *outs_c[j], team=team)

    def launch_a(j, team):
        binding.launch_binned_round_anyhit(tb, *waves_a[j], occs_a[j], team=team)

    by_team, call_by_team = {}, {}
    for k, launch, waves in (("binned_round_closest", launch_c, waves_c),
                             ("binned_round_anyhit", launch_a, waves_a)):
        by_team[k] = {team: cuda_ms(lambda: launch(0, team)) for team in binding.TEAMS}
        call_by_team[k] = {team: queued_ms(lambda: [launch(j, team) for j in range(len(waves))])
                           for team in binding.TEAMS}
    ms["binned_round_closest"] = (
        by_team["binned_round_closest"][binding.BINNED_TEAM["binned_round_closest"]],
        cuda_ms(lambda: binned.round_closest_reference(tb, *rc), **slow))
    ms["binned_round_anyhit"] = (
        by_team["binned_round_anyhit"][binding.BINNED_TEAM["binned_round_anyhit"]],
        cuda_ms(lambda: binned.round_anyhit_reference(tb, *ra), **slow))
    out, occ = outs(S), torch.empty(S, dtype=torch.bool, device=dev)
    # The resident pair at every team (the closest hit in both modes where
    # its entries fit in shared memory, else recomputed only).
    r_by_team = {"resident_closest": {}, "resident_closest_recomputed": {},
                 "resident_anyhit": {}}
    for team in binding.TEAMS:
        if binding.resident_cached(tr.leaf.shape[0], team):
            r_by_team["resident_closest"][team] = cuda_ms(lambda: binding.launch_resident_closest(
                tr, o, d, lo, hi_t, *out, team=team, cached=True))
        r_by_team["resident_closest_recomputed"][team] = cuda_ms(
            lambda: binding.launch_resident_closest(tr, o, d, lo, hi_t, *out, team=team,
                                                    cached=False))
        r_by_team["resident_anyhit"][team] = cuda_ms(
            lambda: binding.launch_resident_anyhit(tr, so, sd, lo, st, occ, team=team))
    ms["resident_closest"] = (
        cuda_ms(lambda: binding.launch_resident_closest(tr, o, d, lo, hi_t, *out)),
        cuda_ms(lambda: intersect.triangle_closest_reference(tr, o, d, lo, hi_t), **slow))
    ms["resident_anyhit"] = (
        cuda_ms(lambda: binding.launch_resident_anyhit(tr, so, sd, lo, st, occ)),
        cuda_ms(lambda: intersect.bvh_anyhit_reference(tr, so, sd, lo, st), **slow))
    drivers = {
        "closest": cuda_ms(lambda: binned.triangle_closest_binned(tb, o, d, lo, hi_t), runs=5,
                           calls=1),
        "anyhit": cuda_ms(lambda: binned.triangle_anyhit_binned(tb, so, sd, lo, st), runs=5,
                          calls=1),
    }

    need_c = closest_tests(tr.leaf, intersect.LEAF, o, d, lo, hi_t, ref_t[0])
    need_a = anyhit_tests(tr.leaf, intersect.LEAF, so, sd, lo, st, ref_occ)
    cluster_bytes = CLUSTER_ROWS * tb.tri.shape[1] * 4
    n_rc, n_ra = rc[0].shape[0], ra[0].shape[0]
    bounds = {
        "binned_round_closest": bound(
            nbytes(*rc, *outs_c[0]) + cluster_bytes * torch.unique(rc[4]).numel(),
            n_rc * CLUSTER_ROWS * TRI_OPS),
        "binned_round_anyhit": bound(
            nbytes(*ra, occs_a[0]) + cluster_bytes * torch.unique(ra[4]).numel(),
            TRI_OPS * (int((~ref_ra).sum()) * CLUSTER_ROWS + int(ref_ra.sum()))),
        "resident_closest": bound(
            nbytes(o, d, lo, hi_t, tr.tri, tr.leaf, *out), TRI_OPS * need_c),
        "resident_anyhit": bound(
            nbytes(so, sd, lo, st, tr.tri, tr.leaf, occ), TRI_OPS * need_a),
    }
    extra = {}
    for k, model, need in (("resident_closest", r_model, need_c),
                           ("resident_anyhit", r_a_model, need_a)):
        extra[k] = {"team": binding.RESIDENT_TEAM[k], "ms_by_team": r_by_team[k],
                    "per_ray": {"clusters": model[-2].double().mean().item(),
                                "tests": model[-1].double().mean().item(),
                                "bound_tests": need / S}}
    extra["resident_closest"]["ms_by_team_recomputed"] = r_by_team["resident_closest_recomputed"]
    for k, waves, name in (("binned_round_closest", waves_c, "closest"),
                           ("binned_round_anyhit", waves_a, "anyhit")):
        extra[k] = {"team": binding.BINNED_TEAM[k], "ms_by_team": by_team[k],
                    "call_ms_by_team": call_by_team[k], "rounds": stats[name]["rounds"],
                    "ray_rounds": stats[name]["ray_rounds"],
                    "wave_sizes": [w[4].shape[0] for w in waves]}
    log(f"[traversal-kernels] {scene.num_tris} triangles: binned {tb.leaf.shape[0]} clusters "
        f"of 256 rows, resident {tr.leaf.shape[0]} boxes of 128 rows; S={S}. Bitwise equal to "
        f"their twins at teams {list(binding.TEAMS)}: binned_round_closest on all "
        f"{len(waves_c)} waves of a closest driver call (first round {n_rc} rays), "
        f"binned_round_anyhit on all {len(waves_a)} of an any-hit call (first {n_ra}); the "
        f"binned drivers equal the same drivers on the round twins and the brute-force twin on "
        f"every lane; resident_closest (entries cached where they fit, and recomputed) and "
        f"resident_anyhit equal brute force at every team on every lane, on edge lanes, on the "
        f"tables padded to {RESIDENT_PADDED_BOXES} boxes and on the tie case")
    log("[traversal-kernels] ms kernel vs twin: " + ", ".join(
        f"{k} {a:.4f} vs {b:.4f}" for k, (a, b) in ms.items())
        + f"; whole binned driver on the kernels: closest {drivers['closest']:.4f} ms, "
        f"any hit {drivers['anyhit']:.4f} ms; bounds: {json.dumps(bounds)}")
    log("[traversal-kernels] binned round pair by team (first round ms, driver call's sum "
        "ms), waves: " + json.dumps({k: v for k, v in extra.items() if "binned" in k}))
    log(f"[traversal-kernels] resident pair by team (ms; the walk model's clusters and rows "
        f"tested a ray against the bound's tests): "
        f"{json.dumps({k: v for k, v in extra.items() if 'resident' in k})}; host team "
        f"{binding.RESIDENT_TEAM['resident_closest']} (closest, entries cached: "
        f"{binding.resident_cached(tr.leaf.shape[0], binding.RESIDENT_TEAM['resident_closest'])}"
        f"), {binding.RESIDENT_TEAM['resident_anyhit']} (any hit)")
    return worst, ms, bounds, extra


def run_mesh_frame(dev):
    """Phase 4b: a small mesh frame through the composed branch, GPU
    against CPU."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.pool import ray_count, render_pool

    W, H = MESH_FRAME["width"], MESH_FRAME["height"]
    shade.LAUNCHES.clear()
    img, counters, iters = render_pool(
        scenes.mesh_scene(MESH_FRAME_TRIS, device=dev), scenes.mesh_scene_camera(W, H, dev),
        **MESH_FRAME)
    torch.cuda.synchronize()
    launches = dict(shade.LAUNCHES)
    img = img.cpu().numpy()
    if img.shape != (W * H, 3) or not np.isfinite(img).all():
        raise AssertionError(f"mesh image {img.shape} not finite")
    if launches.get("bvh_closest", 0) != iters or any(
            launches.get(k, 0) <= 0 for k in MESH_KERNELS):
        raise AssertionError(f"mesh launches {launches} for {iters} iterations")
    t0 = time.perf_counter()
    img_cpu, counters_cpu, iters_cpu = render_pool(
        scenes.mesh_scene(MESH_FRAME_TRIS, device="cpu"),
        scenes.mesh_scene_camera(W, H, device="cpu"), **MESH_FRAME)
    cpu_s = time.perf_counter() - t0
    rays, rays_cpu = ray_count(counters), ray_count(counters_cpu)
    if abs(rays - rays_cpu) > 1e-3 * rays_cpu:
        raise AssertionError(f"mesh rays GPU {rays} vs CPU {rays_cpu}")
    assert_images_match(img, img_cpu.numpy())
    log(f"[mesh-frame] {MESH_FRAME_TRIS} tris {W}x{H} {MESH_FRAME['spp']}spp MIS depth "
        f"{MESH_FRAME['max_bounces']}: GPU rays {rays}, iters {iters}; CPU rays {rays_cpu}, "
        f"iters {iters_cpu} ({cpu_s:.1f} s); max pixel diff "
        f"{np.abs(img - img_cpu.numpy()).max():.4g}; launches {launches}")


def run_config4(scene, camera, smi: str):
    """Phase 5b: BASELINE config 4, the 70k-triangle mesh frame, timed."""
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.pool import busy_count, ray_count, render_pool

    warm = dict(CONFIG4, spp=1)
    t0 = time.perf_counter()
    render_pool(scene, camera, **warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    spp = CONFIG4["spp"]
    while spp > 1 and warm_s * spp > CONFIG4_BUDGET_S:
        spp //= 2
    run = dict(CONFIG4, spp=spp)

    shade.LAUNCHES.clear()
    t0 = time.perf_counter()
    img, counters, iters = render_pool(scene, camera, **run)
    checksum = float(img.double().sum().item())     # forces completion
    wall = time.perf_counter() - t0
    launches = dict(shade.LAUNCHES)
    if img.shape != (run["width"] * run["height"], 3) or not torch.isfinite(img).all():
        raise AssertionError("config-4 image not finite")
    for k in MESH_KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"{k} was not launched on the mesh path: {launches}")
    if launches["bvh_closest"] != iters:
        raise AssertionError(f"bvh_closest launches {launches} != iters {iters}")
    rays = ray_count(counters)
    slots = min(run["num_slots"], run["width"] * run["height"])
    result = {
        "workload": f"mesh_scene {scene.num_tris} tris {run['width']}x{run['height']} "
                    f"{spp}spp MIS depth {run['max_bounces']}",
        "spp": spp, "spp_note": "" if spp == CONFIG4["spp"] else
        f"reduced from {CONFIG4['spp']}: the 1-spp warm-up took {warm_s:.2f} s",
        "total_rays": rays, "iters": iters,
        "occupancy": busy_count(counters) / max(iters * slots, 1),
        "wall_s": wall, "mrays_per_s": rays / wall / 1e6,
        "image_checksum": checksum, "warmup_1spp_s": warm_s, "card": smi,
    }
    log("[config4] " + json.dumps(result))
    return launches


def device_work(fn) -> tuple[float | None, int, dict]:
    """``profiler.device_work`` over one call of ``fn``, with the names of
    every hand-written kernel: ``(ms, ops, kernel_ms)``."""
    from pathtrace_tpu_torch.profiler import device_work as work

    return work(fn, {**KERNELS, **MESH_KERNELS, **WAVE_KERNELS, **TRAVERSAL_KERNELS})


def run_config4_methods(scene, camera, smi: str):
    """Phase 5d: config 4 at 1 spp through ``render_pool(method=m)`` for the
    three per-ray traversals. Each equals brute force, so the frames must
    give the same rays, iterations and a bitwise-equal image. Each is timed
    twice, in turns (bvh, binned, resident, resident, binned, bvh: wall,
    Mrays/s); its hand-written kernels' launches and device ms and all its
    device operations (a third, profiled run) are counted per iteration, and
    its device busy share is the profiler's device time over each unprofiled
    wall. The rays and iterations must repeat ``METHOD_EXPECT``."""
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.pool import ray_count, render_pool

    run = dict(CONFIG4, spp=1)
    launches, walls, first = {}, {m: [] for m in METHODS}, None
    for m in METHODS + METHODS[::-1]:
        shade.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, counters, iters = render_pool(scene, camera, method=m, **run)
        checksum = float(img.double().sum().item())     # forces completion
        walls[m].append(time.perf_counter() - t0)
        if m in launches:
            continue
        launches[m] = dict(shade.LAUNCHES)
        if img.shape != (run["width"] * run["height"], 3) or not torch.isfinite(img).all():
            raise AssertionError(f"config 4 under {m}: image not finite")
        for k in METHOD_KERNELS[m]:
            if launches[m].get(k, 0) <= 0:
                raise AssertionError(f"{k} was not launched under method {m}: {launches[m]}")
        rays = ray_count(counters)
        if first is None:
            first = (m, img, rays, iters, checksum)
        elif (rays, iters) != first[2:4] or not torch.equal(img, first[1]):
            raise AssertionError(
                f"config 4: {m} gave {rays} rays, {iters} iterations, checksum {checksum}; "
                f"{first[0]} gave {first[2]}, {first[3]}, {first[4]} (or the images differ)")
    rays, iters = first[2], first[3]
    if (rays, iters) != METHOD_EXPECT:
        raise AssertionError(f"config 4 at 1 spp: {rays} rays, {iters} iterations; expected "
                             f"{METHOD_EXPECT}")
    for m in METHODS:
        dev_ms, dev_ops, kernel_ms = device_work(
            lambda: render_pool(scene, camera, method=m, **run))
        result = {
            "workload": f"mesh_scene {scene.num_tris} tris {run['width']}x{run['height']} 1spp "
                        f"MIS depth {run['max_bounces']} method {m}",
            "total_rays": rays, "iters": iters, "wall_s": walls[m],
            "mrays_per_s": [rays / w / 1e6 for w in walls[m]],
            "device_ops_per_iter": dev_ops / iters,
            "kernel_launches_per_iter": {k: launches[m][k] / iters for k in sorted(launches[m])},
            "device_ms": dev_ms,
            "kernel_device_ms_per_iter": {k: v / iters for k, v in sorted(kernel_ms.items())},
            "busy_share": [dev_ms / 1e3 / w for w in walls[m]] if dev_ms else None,
            "card": smi,
        }
        log("[config4-methods] " + json.dumps(result))
    log(f"[config4-methods] {', '.join(METHODS)}: the same {first[2]} rays, {first[3]} "
        f"iterations and a bitwise-equal image (checksum {first[4]})")
    return launches


def run_wave_methods(dev):
    """Phase 4d: the wave engine on mesh_scene(2000) with ``method="binned"``
    and ``"resident"`` on the card against the same renders on the CPU
    twins: equal ray queries, images within the imgutil budget."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.render import RenderConfig, render

    W, H = METHOD_WAVE["width"], METHOD_WAVE["height"]
    for m in ("binned", "resident"):
        cfg = RenderConfig(method=m, **METHOD_WAVE)
        shade.LAUNCHES.clear()
        gpu = render(scenes.mesh_scene(FLAT_TRIS, device=dev),
                     scenes.mesh_scene_camera(W, H, dev), cfg)
        img = gpu.image.cpu().numpy()
        launches = dict(shade.LAUNCHES)
        cpu = render(scenes.mesh_scene(FLAT_TRIS, device="cpu"),
                     scenes.mesh_scene_camera(W, H, "cpu"), cfg)
        if gpu.ray_queries != cpu.ray_queries:
            raise AssertionError(f"wave {m}: rays GPU {gpu.ray_queries} vs CPU "
                                 f"{cpu.ray_queries}")
        assert_images_match(img, cpu.image.numpy())
        want = {"sphere_closest", "any_hit", *METHOD_KERNELS[m]}
        if set(launches) != want:
            raise AssertionError(f"wave {m} launched {launches}")
        log(f"[wave-methods] mesh_scene({FLAT_TRIS}) {W}x{H} 1spp MIS method {m}: rays "
            f"{gpu.ray_queries} on both; max pixel diff "
            f"{np.abs(img - cpu.image.numpy()).max():.4g}; launches {launches}")


def run_cornell(dev):
    """Phase 4: the compile-check entry point's frame, GPU against CPU."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.pool import ray_count, render_pool
    from pathtrace_tpu_torch.profiler import profiled_render

    shade.LAUNCHES.clear()
    W, H = CORNELL["width"], CORNELL["height"]
    img, counters, iters = render_pool(
        scenes.cornell_box(dev), scenes.cornell_camera(W, H, dev), **CORNELL)
    torch.cuda.synchronize()
    launches = dict(shade.LAUNCHES)
    img = img.cpu().numpy()
    if img.shape != (W * H, 3) or not np.isfinite(img).all():
        raise AssertionError(f"cornell image {img.shape} not finite")
    if launches.get("fused_bounce_raygen", 0) != iters or \
            launches.get("shadow_any_hit", 0) <= 0 or set(launches) != set(POOL_KERNELS):
        raise AssertionError(f"cornell launches {launches} for {iters} iterations")
    img_cpu, counters_cpu, iters_cpu = render_pool(
        scenes.cornell_box("cpu"), scenes.cornell_camera(W, H, "cpu"), **CORNELL)
    rays, rays_cpu = ray_count(counters), ray_count(counters_cpu)
    if abs(rays - rays_cpu) > 1e-3 * rays_cpu:
        raise AssertionError(f"cornell rays GPU {rays} vs CPU {rays_cpu}")
    assert_images_match(img, img_cpu.numpy())
    log(f"[cornell] {W}x{H} 1spp MIS: GPU rays {rays}, iters {iters}; CPU rays "
        f"{rays_cpu}, iters {iters_cpu}; max pixel diff "
        f"{np.abs(img - img_cpu.numpy()).max():.4g}; launches {launches}")
    # The same frame through the profiler: the same counts and image.
    state, stats = profiled_render(scenes.cornell_box(dev), scenes.cornell_camera(W, H, dev),
                                   **CORNELL)
    if ((stats.traced_rays, stats.pool_iterations, stats.platform) != (rays, iters, "cuda")
            or state.num_samples != CORNELL["spp"]
            or not np.array_equal(state.image_sum.reshape(-1, 3).cpu().numpy(), img)):
        raise AssertionError(f"cornell profiled_render {stats} differs from render_pool's "
                             f"{rays} rays, {iters} iterations (or its image does)")
    log("[cornell] profiled_render: " + stats.to_json())


def run_bench(dev, smi: str):
    """Phase 5: many-spheres at the benchmark's size through
    ``pathtrace_tpu_torch.bench``, timed; prints the bench's JSON line.
    Returns its launches, the draw's (one ``rng_pool_uniforms`` an
    iteration) with the intersection and shading kernels'."""
    from pathtrace_tpu_torch import bench
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.utils import rng

    scene, camera, frame = bench.setup(dev.type)
    warm_s = bench.warm_up(scene, camera, frame)
    spp = frame["spp"]
    while spp > 1 and warm_s * spp > BENCH_BUDGET_S:
        spp //= 2

    shade.LAUNCHES.clear()
    rng.LAUNCHES.clear()
    record = bench.timed(scene, camera, dict(frame, spp=spp))
    launches = dict(shade.LAUNCHES)
    draws = dict(rng.LAUNCHES)
    print(json.dumps(record), flush=True)
    extra = record["extra"]
    rays, iters, checksum = extra["total_rays"], extra["pool_iterations"], extra["image_checksum"]
    if not np.isfinite(checksum):
        raise AssertionError(f"many_spheres image not finite: checksum {checksum}")
    for k in POOL_KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"{k} was not launched on the main path: {launches}")
    if launches["fused_bounce_raygen"] != iters:
        raise AssertionError(f"fused_bounce_raygen launches {launches} != iters {iters}")
    if draws != {"rng_pool_uniforms": iters}:
        raise AssertionError(f"draw launches {draws} for {iters} iterations")
    if spp == frame["spp"] and (rays, iters, checksum) != BENCH_EXPECT:
        raise AssertionError(f"many_spheres: {rays} rays, {iters} iterations, checksum "
                             f"{checksum}; expected {BENCH_EXPECT}")
    result = {
        "spp": spp, "spp_note": "" if spp == frame["spp"] else
        f"reduced from {frame['spp']}: the 1-spp warm-up took {warm_s:.2f} s",
        "checksum_rel_diff_vs_jax_tpu": (checksum - REFERENCE_CHECKSUM) / REFERENCE_CHECKSUM
        if spp == frame["spp"] else None,
        "warmup_1spp_s": warm_s, "draw_launches": draws, "card": smi,
    }
    log("[bench] " + json.dumps(result))
    return {**launches, **draws}


def edge_t_max() -> tuple:
    """The edge lanes' t_max, one a lane in turn: NaN, -1, 0 (below t_min),
    t_min itself and inf."""
    from pathtrace_tpu_torch.ops import shade

    return float("nan"), -1.0, 0.0, shade.EPS, float("inf")


def edge_ranges(lo, hi, t_hit, n):
    """The first ``n`` lanes' ``(t_min, t_max)`` made edge cases, in turn:
    the t_max of :func:`edge_t_max`, and on hit lanes (``t_hit``: the twin's
    t, inf on a miss) t_min, t_max or both at the hit's t."""
    elo, ehi = lo[:n].clone(), hi[:n].clone()
    for k, v in enumerate(edge_t_max()):
        ehi[k::9] = v
    j = torch.arange(n, device=lo.device) % 9
    t = t_hit[:n]
    hit = torch.isfinite(t)
    elo = torch.where(hit & ((j == 5) | (j == 7)), t, elo)
    ehi = torch.where(hit & ((j == 6) | (j == 7)), t, ehi)
    return elo, ehi


def hold_wave_kernel(kernel, what, tables, o, d, lo, hi):
    """``kernel`` (``"combined_closest_small"`` or ``"triangle_closest"``)
    through raw launches at every team size (1-32 threads a ray), bitwise
    equal to its brute-force twin, outputs scrubbed before each launch.
    Returns the twin's answer."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.ops import intersect

    ref = getattr(intersect, kernel + "_reference")(tables, o, d, lo, hi)
    launch = getattr(binding, "launch_" + kernel)
    for team in binding.TEAMS:
        out = tuple(torch.full_like(x, float("nan") if x.is_floating_point() else -7)
                    for x in ref)
        launch(tables, o, d, lo, hi, *out, team=team)
        _bitwise(f"{kernel}, {what}, team {team}", ref, out)
    return ref


def team_times(kernel, tables, o, d, lo, hi):
    """``{team: ms}`` of raw launches of ``kernel`` at every team size."""
    from pathtrace_tpu_torch.kernels import binding

    launch = getattr(binding, "launch_" + kernel)
    out = (torch.empty_like(lo), torch.empty(lo.shape, dtype=torch.int32, device=lo.device),
           torch.empty_like(o), torch.empty(lo.shape, dtype=torch.int32, device=lo.device))
    return {team: cuda_ms(lambda: launch(tables, o, d, lo, hi, *out, team=team))
            for team in binding.TEAMS}


def real_rows(tables):
    """The real triangle rows of each of the flat route's 256-row clusters."""
    n = tables.leaf.shape[0]
    return torch.clamp(tables.tri_rows - CLUSTER_ROWS * torch.arange(n, device=tables.tri.device),
                       0, CLUSTER_ROWS)


def check_wave_kernels(dev):
    """Phase 3c: the wave engine's two closest-hit kernels, and ``any_hit``
    with the small and flat triangle tables, against their twins on the
    card. The expected result is bitwise agreement: any lane that differs
    fails. ``combined_closest_small`` (Cornell, many_spheres) and
    ``triangle_closest`` (``mesh_scene(2000)``, capped by the sphere hits as
    ``intersect`` caps it) through their wrappers and at every team size
    (:func:`hold_wave_kernel`) on the 65,536 lanes and on 1,024
    edge lanes (:func:`edge_ranges`) of each scene, and on their tie cases
    (:func:`small_tie_tables`; :func:`tie_tables` on flat tables, B in the
    next cluster and in cluster 7); every team timed. Returns the worst
    errors, times, bounds, the kernels' teams and times by team, and the
    flat route's tables, shadow lanes and closest-hit rays ``(tables, o, d,
    t_max, o, d)``."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import intersect, shade

    S = WAVE_S
    lo = torch.full((S,), shade.EPS, device=dev)
    hi = torch.full((S,), float("inf"), device=dev)
    worst = {"combined_closest_small": 0.0, "triangle_closest": 0.0, "any_hit": 0.0}
    ms, bounds, extra, flat = {}, {}, {}, None
    f32, i32 = torch.float32, torch.int32
    out = (torch.empty(S, device=dev), torch.empty(S, dtype=i32, device=dev),
           torch.empty((S, 3), dtype=f32, device=dev), torch.empty(S, dtype=i32, device=dev))
    occ_k = torch.empty(S, dtype=torch.bool, device=dev)
    slow = dict(runs=3, calls=1)

    def same(name, ref, got):
        worst[name] = max(worst[name], _bitwise(name, ref, got))
        return int((ref[1] >= 0).sum())

    def same_occ(ref, got):
        _bitwise("any_hit", ref, got)
        return int(ref.sum())

    cases = (
        ("cornell", scenes.cornell_box(dev), scenes.cornell_camera(400, 400, dev)),
        ("many_spheres", scenes.many_spheres(device=dev),
         scenes.many_spheres_camera(1920, 1080, dev)),
        (f"mesh_{FLAT_TRIS}", scenes.mesh_scene(FLAT_TRIS, device=dev),
         scenes.mesh_scene_camera(1920, 1080, dev)),
    )
    for name, scene, camera in cases:
        tables = intersect.build_tables(scene)
        (o, d), (so, sd, st) = lane_rays(scene, camera, tables, S)
        tri = tables.tri[:tables.tri_rows]
        small = tables.route == "small"
        kname = "combined_closest_small" if small else "triangle_closest"
        hi_k = hi if small else torch.minimum(hi, intersect.sphere_closest_reference(
            tables.sph, o, d, lo, hi)[0])                # as intersect() caps it
        ref = hold_wave_kernel(kname, f"{name}, {S} lanes", tables, o, d, lo, hi_k)
        hits = same(kname, ref, getattr(intersect, kname)(tables, o, d, lo, hi_k))
        hold_wave_kernel(kname, f"{name}, edge lanes", tables, o[:EDGE_N], d[:EDGE_N],
                         *edge_ranges(lo, hi_k, ref[0], EDGE_N))
        by_team = team_times(kname, tables, o, d, lo, hi_k)
        team = binding.small_team(tables) if small else binding.flat_team(tables)
        k_ms = by_team[team]
        q_ms = queued_ms(lambda: getattr(binding, "launch_" + kname)(tables, o, d, lo, hi_k, *out))
        p_ms = cuda_ms(lambda: getattr(intersect, kname + "_reference")(tables, o, d, lo, hi_k),
                       **({} if small else slow))
        extra.setdefault(kname, {"team": team, "ms_by_team": by_team, "queued_ms": q_ms})
        tri_box = None if small else tables.leaf              # as occluded() passes it
        if not small:
            flat = (tables, so, sd, st, o, d)
        blocked = same_occ(intersect.any_hit_reference(tables.sph, tri, so, sd, lo, st),
                           intersect.any_hit(tables.sph, tri, so, sd, lo, st, tri_box=tri_box))
        a_ms = cuda_ms(lambda: binding.launch_any_hit(tables.sph, tri, so, sd, lo, st, occ_k,
                                                      tri_box=tri_box))
        a_p = cuda_ms(lambda: intersect.any_hit_reference(tables.sph, tri, so, sd, lo, st),
                      **({} if small else slow))
        ms[name] = {kname: (k_ms, p_ms), "any_hit": (a_ms, a_p)}
        if small:     # no cull: every row for every lane
            bounds[name] = {kname: bound(
                nbytes(o, d, lo, hi, tables.tri, tables.sph, *out),
                S * (tables.tri_rows * TRI_OPS + tables.sph.shape[0] * SPH_OPS))}
        else:         # the real rows of every cluster entered before the hit
            bounds[name] = {kname: bound(
                nbytes(o, d, lo, hi_k, tri, tables.leaf, *out),
                TRI_OPS * closest_tests(tables.leaf, real_rows(tables), o, d, lo, hi_k, ref[0]))}
        if name == "many_spheres":
            extra[kname].update(ms_many_spheres=k_ms, plain_ms_many_spheres=p_ms,
                                bound_ms_many_spheres=bounds[name][kname]["bound_ms"],
                                ms_by_team_many_spheres=by_team,
                                queued_ms_many_spheres=q_ms)
        log(f"[wave-kernels] {name} ({tables.route} route, {tables.tri_rows} triangle rows, "
            f"{tables.sph.shape[0]} spheres) S={S}: {kname} equals its twin bitwise on every "
            f"lane ({hits} hits) through the wrapper (team {team}) and at every team, also "
            f"on {EDGE_N} edge lanes; {k_ms:.4f} ms ({q_ms:.4f} queued) vs twin {p_ms:.4f} ms; "
            f"by team "
            f"{json.dumps(by_team)}; any_hit equals its twin ({blocked} blocked of "
            f"{int((st >= shade.EPS).sum())} queries), {a_ms:.4f} ms vs twin {a_p:.4f} ms")

    tables, want = small_tie_tables(dev)
    m = len(SMALL_TIE_RAYS)
    to = torch.tensor([[x, y, 5.0] for x, y in SMALL_TIE_RAYS], device=dev)
    td = torch.tensor([[0.0, 0.0, -1.0]] * m, device=dev)
    ref = hold_wave_kernel("combined_closest_small", "tie case", tables, to, td, lo[:m], hi[:m])
    if [int(p) for p in ref[1]] != [p for _, p in want] or any(
            w is not None and float(t) != w for (w, _), t in zip(want, ref[0])):
        raise AssertionError(f"small tie case: twin gave {ref[:2]}, expected {want}")
    to, td, tlo, thi, _ = tie_rays(dev)
    for upper in (1, 7):
        tables, b = tie_tables(dev, upper, route="flat")
        ref = hold_wave_kernel("triangle_closest", f"tie case, B at row {b}", tables, to, td,
                               tlo, thi)
        if not ((ref[0] == 5.0).all() and (ref[1] == 0).all()):
            raise AssertionError(f"flat tie case (B at row {b}): twin gave {ref[:2]}")
    log(f"[wave-kernels] tie cases at every team: combined_closest_small gives the "
        f"triangle on a triangle/sphere equal t and the lower row of two equal spheres or "
        f"triangles; triangle_closest gives row 0 with B (rows 256, 1792) in a cluster entered "
        f"first; worst abs error: {worst}; bounds: {json.dumps(bounds)}")
    return worst, ms, bounds, extra, flat


def check_wave_draws(what, cfg, closest: int, draws: dict, sfx: str = "") -> None:
    """A wave frame's draw launches (``rng.LAUNCHES`` over the frame) against
    its closest-hit launches, for an MIS or NEE frame in whole waves (one a
    sample): a wave folds its keys once and each further light sample's
    once (``rng_fold``), and draws its jitter once and each light sample's
    uniforms once a bounce (``rng_bounce_uniforms``); a bounce is one
    closest-hit launch past the wave's first."""
    waves, lights = cfg.spp, cfg.num_light_samples
    if cfg.pixel_chunk is not None or cfg.integrator == "brdf":
        raise ValueError(f"{what}: draws counted for MIS or NEE frames in whole waves")
    want = {"rng_fold": waves * lights,
            "rng_bounce_uniforms" + sfx: (closest - waves) * lights + waves}
    if draws != want:
        raise AssertionError(f"{what}: draw launches {draws}, want {want} for {waves} waves, "
                             f"{closest - waves} bounces")


def run_wave_cornell(dev, smi: str):
    """Phase 5c: the reference workload through the wave engine, timed and
    held against the golden image's channel means. Returns its launches,
    the draw's with the intersection kernels'."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.render import RenderConfig, render
    from pathtrace_tpu_torch.utils import rng

    W, H = WAVE_CORNELL["width"], WAVE_CORNELL["height"]
    scene, camera = scenes.cornell_box(dev), scenes.cornell_camera(W, H, dev)
    t0 = time.perf_counter()
    render(scene, camera, RenderConfig(**dict(WAVE_CORNELL, spp=1)))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    spp = WAVE_CORNELL["spp"]
    while spp > 8 and warm_s * spp > WAVE_BUDGET_S:
        spp //= 2
    cfg = RenderConfig(**dict(WAVE_CORNELL, spp=spp))

    shade.LAUNCHES.clear()
    rng.LAUNCHES.clear()
    t0 = time.perf_counter()
    state = render(scene, camera, cfg)
    img = state.image.cpu().numpy()                   # forces completion
    wall = time.perf_counter() - t0
    launches = dict(shade.LAUNCHES)
    draws = dict(rng.LAUNCHES)
    if img.shape != (H, W, 3) or not np.isfinite(img).all():
        raise AssertionError(f"wave cornell image {img.shape} not finite")
    if set(launches) != {"combined_closest_small", "any_hit"}:
        raise AssertionError(f"wave cornell launched {launches}")
    check_wave_draws("wave cornell", cfg, launches["combined_closest_small"], draws)
    golden = np.load(GOLDEN)["image"]
    mean, gmean = img.mean(axis=(0, 1)), golden.mean(axis=(0, 1))
    rel = np.abs(mean - gmean) / gmean
    result = {
        "workload": f"cornell {W}x{H} {spp}spp MIS depth {cfg.max_bounces} wave engine",
        "spp": spp, "spp_note": "" if spp == WAVE_CORNELL["spp"] else
        f"reduced from {WAVE_CORNELL['spp']}: the 1-spp warm-up took {warm_s:.2f} s",
        "ray_queries": state.ray_queries, "wall_s": wall,
        "mrays_per_s": state.ray_queries / wall / 1e6,
        "mean_rgb": mean.tolist(), "golden_mean_rgb": gmean.tolist(),
        "mean_rel_diff": rel.tolist(),
        "rmse_vs_golden": float(np.sqrt(((img - golden) ** 2).mean())),
        "warmup_1spp_s": warm_s, "launches": launches, "draw_launches": draws, "card": smi,
    }
    log("[wave-cornell] " + json.dumps(result))
    if (rel > GOLDEN_MEAN_RTOL).any():
        raise AssertionError(f"channel means {mean} differ from the golden's {gmean} by "
                             f"{rel} (bound {GOLDEN_MEAN_RTOL})")
    return {**launches, **draws}


def run_wave_gpu_vs_cpu(dev):
    """Phase 4c: wave renders and a flat-route pool frame on the card
    against the same renders on the CPU twins."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.pool import ray_count, render_pool
    from pathtrace_tpu_torch.render import RenderConfig, render

    def build(name, W, H, device):
        if name == "cornell":
            return scenes.cornell_box(device), scenes.cornell_camera(W, H, device)
        return (scenes.mesh_scene(FLAT_TRIS, device=device),
                scenes.mesh_scene_camera(W, H, device))

    flat_launches = {}
    for name, W, H, spp in WAVE_CHECKS:
        cfg = RenderConfig(width=W, height=H, spp=spp, integrator="mis", max_bounces=64,
                           seed=0)
        shade.LAUNCHES.clear()
        gpu = render(*build(name, W, H, dev), cfg)
        img = gpu.image.cpu().numpy()
        launches = dict(shade.LAUNCHES)
        t0 = time.perf_counter()
        cpu = render(*build(name, W, H, "cpu"), cfg)
        cpu_s = time.perf_counter() - t0
        if gpu.ray_queries != cpu.ray_queries:
            raise AssertionError(f"wave {name}: rays GPU {gpu.ray_queries} vs CPU "
                                 f"{cpu.ray_queries}")
        assert_images_match(img, cpu.image.numpy())
        want = ({"combined_closest_small", "any_hit"} if name == "cornell"
                else {"triangle_closest", "sphere_closest", "any_hit_clustered"})
        if set(launches) != want:
            raise AssertionError(f"wave {name} launched {launches}")
        if name != "cornell":
            flat_launches = launches
        log(f"[wave-gpu-cpu] {name} {W}x{H} {spp}spp MIS: rays {gpu.ray_queries} on both "
            f"(CPU {cpu_s:.1f} s); max pixel diff {np.abs(img - cpu.image.numpy()).max():.4g}; "
            f"launches {launches}")

    W, H = FLAT_POOL["width"], FLAT_POOL["height"]
    shade.LAUNCHES.clear()
    img, counters, iters = render_pool(*build("mesh", W, H, dev), **FLAT_POOL)
    img = img.cpu().numpy()
    launches = dict(shade.LAUNCHES)
    img_cpu, counters_cpu, iters_cpu = render_pool(*build("mesh", W, H, "cpu"), **FLAT_POOL)
    rays, rays_cpu = ray_count(counters), ray_count(counters_cpu)
    if (rays, iters) != (rays_cpu, iters_cpu):
        raise AssertionError(f"flat pool: GPU {rays} rays {iters} iters, CPU {rays_cpu} "
                             f"rays {iters_cpu} iters")
    assert_images_match(img, img_cpu.numpy())
    if launches.get("triangle_closest", 0) != iters or set(launches) != {
            "triangle_closest", "sphere_closest", "any_hit_clustered"}:
        raise AssertionError(f"flat pool launches {launches} for {iters} iterations")
    log(f"[flat-pool] mesh_scene({FLAT_TRIS}) {W}x{H} {FLAT_POOL['spp']}spp MIS depth "
        f"{FLAT_POOL['max_bounces']}: rays {rays}, iters {iters} on both; max pixel diff "
        f"{np.abs(img - img_cpu.numpy()).max():.4g}; launches {launches}")
    return flat_launches


def on_pbr_scene(dev):
    """The ON/PBR scene of the JAX package's ``tests/test_fused.py``: an
    Oren-Nayar ground, two PBR spheres (dielectric and metal), a GGX mirror,
    a Lambert sphere, a spherical and a triangle light."""
    from pathtrace_tpu_torch.models.materials import (Emissive, Lambertian, Mirror, OrenNayar,
                                                      PBRMaterial)
    from pathtrace_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder(dev)
    b.add_quad((-20, 0, -20), (20, 0, -20), (20, 0, 20), (-20, 0, 20),
               OrenNayar((0.6, 0.55, 0.5), 0.5))
    b.add_sphere((0.0, 1.0, -3.0), 1.0, PBRMaterial((0.7, 0.3, 0.3), roughness=0.4, metallic=0.0))
    b.add_sphere((-2.2, 1.0, -3.0), 1.0, PBRMaterial((0.9, 0.8, 0.4), roughness=0.35,
                                                     metallic=1.0))
    b.add_sphere((2.2, 1.0, -3.0), 1.0, Mirror(roughness=0.4, metallic=1.0))
    b.add_sphere((4.0, 1.0, -5.0), 1.0, Lambertian((0.3, 0.5, 0.7)))
    b.add_sphere((0.0, 6.0, -3.0), 1.5, Emissive((12.0, 12.0, 12.0)))
    b.add_triangle((-3.0, 5.0, -1.0), (-1.0, 5.0, -1.0), (-2.0, 5.0, -2.0),
                   Emissive((8.0, 8.0, 8.0)))
    return b.build()


def sphere_field(dev):
    from pathtrace_tpu_torch.models import scenes

    return scenes.many_spheres(n_per_side=FIELD_N, device=dev)


def hold_cluster_kernels(what, sph, box, closest, shadow, tri=None, tri_box=None):
    """The clustered pair through raw launches at every team size (1-32):
    ``sphere_closest`` (``closest`` = ``(o, d, t_min, t_max, twin's
    4-tuple)``, or None) and ``any_hit`` over ``sph`` and ``tri`` (``shadow``
    = ``(o, d, t_min, t_max, twin's occlusion)``) bitwise equal to the
    brute-force twins, outputs scrubbed before each launch; the walk model
    (``cluster_walk_reference``) equal to the twins too. Returns the model's
    closest (None without ``closest``) and any-hit results, counts
    included."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.ops import intersect

    tri = sph.new_zeros((0, 16)) if tri is None else tri
    model = None
    if closest is not None:
        o, d, lo, hi, ref = closest
        model = intersect.cluster_walk_reference(sph, o, d, lo, hi, box)
        _bitwise(f"{what}: the closest walk (cluster_walk_reference) vs brute force", ref,
                 model[:4])
        out = tuple(torch.empty_like(x) for x in ref)
    so, sd, slo, st, ref_occ = shadow
    a_model = intersect.cluster_walk_reference(sph, so, sd, slo, st, box, tri, tri_box,
                                               anyhit=True)
    _bitwise(f"{what}: the any-hit walk vs brute force", ref_occ, a_model[0])
    occ = torch.empty_like(ref_occ)
    for team in binding.TEAMS:
        if closest is not None:
            for x in out:
                x.fill_(float("nan") if x.is_floating_point() else -7)
            binding.launch_sphere_closest(sph, o, d, lo, hi, *out, box=box, team=team)
            _bitwise(f"sphere_closest_clustered, {what}, team {team}", ref, out)
        occ.copy_(~ref_occ)
        binding.launch_any_hit(sph, tri, so, sd, slo, st, occ, sph_box=box, tri_box=tri_box,
                               team=team)
        _bitwise(f"any_hit_clustered, {what}, team {team}", ref_occ, occ)
    return model, a_model


def cluster_edge_lanes(dev, tables, o, d, so, sd, lo, n=1024, seed=0):
    """Edge lanes of the sphere field: ``n`` of its lanes with t_max NaN, -1,
    0 (below t_min), t_min itself and inf; ``n`` rays from 150-200 away aimed
    at its spheres; ``n`` grazing rays aimed at sphere silhouettes from up to
    ~100 away, a third with directions up to 1e-3 off unit length (the cases
    the sphere boxes' pad covers). Returns closest ``(o, d, t_min, t_max)``
    and shadow ``(o, d, t_min, t_max)`` lanes, in the dtype of ``o``."""
    from pathtrace_tpu_torch.ops import shade

    g = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=o.dtype, device=dev)

    hi = torch.full((n,), float("inf"), dtype=o.dtype, device=dev)
    st = t(g.uniform(0.05, 60.0, n))
    for k, v in enumerate((float("nan"), -1.0, 0.0, shade.EPS, float("inf"))):
        hi[k::7] = v
        st[k::7] = v
    center = tables.sph[:, 0:3].cpu().numpy()
    radius = np.where(tables.sph[:, 4].cpu().numpy() > 0, 1.0 / tables.sph[:, 4].cpu().numpy(), 0)
    pick = g.choice(np.nonzero(radius > 0)[0], 2 * n)
    far = g.normal(size=(n, 3))
    far_o = far / np.linalg.norm(far, axis=1, keepdims=True) * g.uniform(150, 200, (n, 1))
    far_d = center[pick[:n]] + g.uniform(-1, 1, (n, 3)) * radius[pick[:n], None] - far_o
    v = g.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    aim = center[pick[n:]] + v * (radius[pick[n:]] * (1 + g.uniform(-1e-3, 1e-3, n)))[:, None]
    graze_o = g.uniform(-100, 100, (n, 3))
    graze_d = aim - graze_o
    eo = np.concatenate([far_o, graze_o])
    ed = np.concatenate([far_d, graze_d])
    ed /= np.linalg.norm(ed, axis=1, keepdims=True)
    ed[n:] *= np.where(g.random(n) < 0.3, 1 + g.uniform(-1e-3, 1e-3, n), 1.0)[:, None]
    eo, ed = t(eo), t(ed)
    inf = torch.full((2 * n,), float("inf"), dtype=o.dtype, device=dev)
    elo = torch.full((2 * n,), shade.EPS, dtype=o.dtype, device=dev)
    return ((torch.cat([o[:n], eo]), torch.cat([d[:n], ed]), torch.cat([lo[:n], elo]),
             torch.cat([hi, inf])),
            (torch.cat([so[:n], eo]), torch.cat([sd[:n], ed]), torch.cat([lo[:n], elo]),
             torch.cat([st, t(g.uniform(0.05, 250.0, 2 * n))])))


def check_cluster_edges(dev, tables, lanes):
    """The clustered pair at every team size on the field's edge lanes
    (:func:`cluster_edge_lanes`) and the cross-cluster tie
    (:func:`sphere_tie_tables`, B in the next cluster and the one after),
    where both must return row 0, the twin's answer, with shadow t_max at
    the hit (occluded) and 0.5 before it (not)."""
    from pathtrace_tpu_torch.ops import intersect

    box, tri = tables.sph_box, tables.tri[:tables.tri_rows]
    c, s = cluster_edge_lanes(dev, tables, *lanes)
    ref = intersect.sphere_closest_reference(tables.sph, *c)
    ref_occ = intersect.any_hit_reference(tables.sph, tri, *s)
    hold_cluster_kernels("edge lanes", tables.sph, box, (*c, ref), (*s, ref_occ), tri,
                         tables.leaf)
    dt = lanes[0].dtype
    for upper in (1, 2):
        sph, tbox, b = sphere_tie_tables(dev, upper, dt)
        m = len(SPHERE_TIE_RAYS)
        to = torch.tensor([[x, y, 5.0] for x, y in SPHERE_TIE_RAYS], dtype=dt, device=dev)
        td = torch.tensor([[0.0, 0.0, -1.0]] * m, dtype=dt, device=dev)
        tlo = torch.full((m,), 1e-3, dtype=dt, device=dev)
        thi = torch.full((m,), float("inf"), dtype=dt, device=dev)
        tref = intersect.sphere_closest_reference(sph, to, td, tlo, thi)
        if not (tref[1] == 0).all():
            raise AssertionError(f"sphere tie case (B at row {b}): twin gave {tref[:2]}")
        tst = tref[0] - torch.tensor([0.0, 0.5] * (m // 2), dtype=dt, device=dev)
        model, a_model = hold_cluster_kernels(
            f"sphere tie case, B at row {b}", sph, tbox, (to, td, tlo, thi, tref),
            (to, td, tlo, tst, intersect.any_hit_reference(sph, sph.new_zeros((0, 16)), to, td,
                                                           tlo, tst)))
        if not ((model[4] == 2).all() and torch.equal(a_model[0], tst == tref[0])):
            raise AssertionError(f"sphere tie case (B at row {b}): clusters visited {model[4]}, "
                                 f"occlusion {a_model[0]}")
    log(f"[cluster-kernels] edge lanes ({dt}): sphere_closest_clustered and any_hit_clustered "
        f"bitwise equal to their twins at every team on {c[0].shape[0]} lanes (field lanes "
        f"with t_max NaN, -1, 0, t_min, inf; rays from 150-200 away; grazing rays) and on the "
        f"sphere tie case (B at row 256 and 512, its cluster entered first): row 0, both "
        f"clusters swept")


def check_clustered_kernels(dev, flat):
    """Phase 3e: the clustered sphere_closest and any_hit against their twins,
    bitwise, at every team size 1-32: the sphere field's 65,536 lanes and
    their first 16,384, the flat ``mesh_scene(2000)`` shadow lanes of phase
    3c (``flat``: ``(tables, o, d, t_max, ...)``) with the triangle boxes, the
    field's edge lanes and the cross-cluster tie; every team timed at both
    lane counts, the flat any hit at 65,536; the walk's work a ray against
    the bound's. Then fused_bounce with its ON/PBR lanes against its twin at
    S = 16,384 lanes of the ON/PBR scene."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import intersect, shade

    scene = sphere_field(dev)
    tables = intersect.build_tables(scene)
    box = tables.sph_box
    t0 = time.perf_counter()
    (o, d), (so, sd, st) = lane_rays(scene, scenes.many_spheres_camera(1920, 1080, dev),
                                     tables, WAVE_S)
    torch.cuda.synchronize()
    S = WAVE_S
    lo = torch.full((S,), shade.EPS, device=dev)
    hi = torch.full((S,), float("inf"), device=dev)
    tri = tables.tri[:tables.tri_rows]
    worst, ms, bounds = {}, {}, {}
    ref_s = intersect.sphere_closest_reference(tables.sph, o, d, lo, hi)
    worst["sphere_closest_clustered"] = _bitwise(
        "sphere_closest_clustered", ref_s, intersect.sphere_closest(tables.sph, o, d, lo, hi,
                                                                    box=box))
    ref_occ = intersect.any_hit_reference(tables.sph, tri, so, sd, lo, st)
    worst["any_hit_clustered"] = _bitwise(
        "any_hit_clustered", ref_occ,
        intersect.any_hit(tables.sph, tri, so, sd, lo, st, sph_box=box, tri_box=tables.leaf))
    ref_socc = intersect.any_hit_reference(tables.sph, tri[:0], so, sd, lo, st)
    _bitwise("any_hit_clustered, spheres only", ref_socc,
             intersect.any_hit(tables.sph, tri[:0], so, sd, lo, st, sph_box=box))

    # Every team size: all lanes, the first 16,384, the flat shadow lanes.
    n = SLICE_S
    model, a_model = hold_cluster_kernels(
        f"field, {S} lanes", tables.sph, box, (o, d, lo, hi, ref_s),
        (so, sd, lo, st, ref_occ), tri, tables.leaf)
    hold_cluster_kernels(f"field, first {n} lanes", tables.sph, box,
                         (o[:n], d[:n], lo[:n], hi[:n], tuple(x[:n] for x in ref_s)),
                         (so[:n], sd[:n], lo[:n], st[:n], ref_occ[:n]), tri, tables.leaf)
    ft, fo, fd, fst = flat[:4]
    ftri = ft.tri[:ft.tri_rows]
    flo = torch.full((fo.shape[0],), shade.EPS, device=dev)
    f_occ = intersect.any_hit_reference(ft.sph, ftri, fo, fd, flo, fst)
    hold_cluster_kernels(f"mesh_{FLAT_TRIS} shadow lanes", ft.sph, ft.sph_box, None,
                         (fo, fd, flo, fst, f_occ), ftri, ft.leaf)
    check_cluster_edges(dev, tables, (o, d, so, sd, lo))

    f32, i32 = torch.float32, torch.int32
    out = (torch.empty(S, device=dev), torch.empty(S, dtype=i32, device=dev),
           torch.empty((S, 3), dtype=f32, device=dev), torch.empty(S, dtype=i32, device=dev))
    occ = torch.empty(S, dtype=torch.bool, device=dev)
    slow = dict(runs=5, calls=1)       # twins: 10-40 ms a call
    host = {"sphere_closest_clustered": binding.cluster_team("sphere_closest", (tables.sph, box)),
            "any_hit_clustered": binding.cluster_team("any_hit", (tables.sph, box),
                                                      (tri, tables.leaf))}

    def team_ms(m, team):
        """(closest ms, any-hit ms) on the first ``m`` lanes at ``team``."""
        return (cuda_ms(lambda: binding.launch_sphere_closest(
                    tables.sph, o[:m], d[:m], lo[:m], hi[:m], *(x[:m] for x in out), box=box,
                    team=team)),
                cuda_ms(lambda: binding.launch_any_hit(
                    tables.sph, tri, so[:m], sd[:m], lo[:m], st[:m], occ[:m], sph_box=box,
                    tri_box=tables.leaf, team=team)))

    by_team = {m: {team: team_ms(m, team) for team in binding.TEAMS} for m in (n, S)}
    ms["sphere_closest_clustered"] = (
        by_team[S][host["sphere_closest_clustered"]][0],
        cuda_ms(lambda: intersect.sphere_closest_reference(tables.sph, o, d, lo, hi), **slow))
    ms["any_hit_clustered"] = (
        by_team[S][host["any_hit_clustered"]][1],
        cuda_ms(lambda: intersect.any_hit_reference(tables.sph, tri, so, sd, lo, st), **slow))
    # The field frame's third kernel, on its 2 triangles (one cluster, 2 real
    # rows), capped by the sphere hits as intersect() caps it, at the 16,384
    # lanes its pool frame runs: bitwise at every team, timed at every team.
    fl = (o[:n], d[:n], lo[:n], torch.minimum(hi, ref_s[0])[:n])
    ref_t = hold_wave_kernel("triangle_closest", f"field, first {n} lanes", tables, *fl)
    tri_by_team = team_times("triangle_closest", tables, *fl)
    tri_team = binding.flat_team(tables)
    tri_ms = tri_by_team[tri_team]
    tri_q = queued_ms(lambda: binding.launch_triangle_closest(tables, *fl,
                                                              *(x[:n] for x in out)))
    tri_bound = bound(nbytes(*fl, tri, tables.leaf, *(x[:n] for x in out)),
                      TRI_OPS * closest_tests(tables.leaf, real_rows(tables), *fl, ref_t[0]))
    focc = torch.empty_like(f_occ)
    flat_by_team = {team: cuda_ms(lambda: binding.launch_any_hit(
        ft.sph, ftri, fo, fd, flo, fst, focc, sph_box=ft.sph_box, tri_box=ft.leaf, team=team))
        for team in binding.TEAMS}
    n_sph = tables.sph.shape[0]
    per_box = torch.clamp(n_sph - 256 * torch.arange(box.shape[0], device=dev), 0, 256)

    def work(m):
        """Bounds of both kernels on the first ``m`` lanes, and the rows a ray
        their operation counts test."""
        free = ~ref_occ[:m]
        fo_, fd_, flo_, fst_ = so[:m][free], sd[:m][free], lo[:m][free], st[:m][free]
        rows_c = closest_tests(box, per_box, o[:m], d[:m], lo[:m], hi[:m], ref_s[0][:m])
        rows_s = entered_rows(box, per_box, fo_, fd_, flo_, fst_)
        rows_t = entered_rows(tables.leaf, tables.tri_rows, fo_, fd_, flo_, fst_)
        n_occ = int(ref_occ[:m].sum())
        return {
            "sphere_closest_clustered": bound(
                nbytes(o[:m], d[:m], lo[:m], hi[:m], tables.sph, box, *(x[:m] for x in out)),
                SPH_OPS * rows_c),
            "any_hit_clustered": bound(
                nbytes(so[:m], sd[:m], lo[:m], st[:m], occ[:m], tables.sph, box, tri,
                       tables.leaf),
                SPH_OPS * rows_s + TRI_OPS * rows_t + SPH_OPS * n_occ),
        }, {"sphere_closest_clustered": rows_c / m,
            "any_hit_clustered": (rows_s + rows_t + n_occ) / m}

    bounds_s, bound_rows = work(S)
    bounds.update(bounds_s)
    # The same kernels at the 16,384 lanes the field's pool frame runs.
    at_slice = {k: {"ms": by_team[n][host[k]][which], **work(n)[0][k]}
                for which, k in enumerate(host)}
    extra = {}
    for which, (k, res) in enumerate(zip(host, (model, a_model))):
        visited, tested = res[-2:]
        extra[k] = {
            "team": host[k],
            "ms_by_team": {t: v[which] for t, v in by_team[n].items()},
            "ms_by_team_65536": {t: v[which] for t, v in by_team[S].items()},
            "per_ray": {"clusters": visited.double().mean().item(),
                        "rows": tested.double().mean().item(), "bound_rows": bound_rows[k]}}
    extra["any_hit_clustered"]["flat_ms_by_team"] = flat_by_team
    log(f"[cluster-kernels] many_spheres(n_per_side={FIELD_N}): {n_sph} spheres in "
        f"{box.shape[0]} clusters, {tables.tri_rows} triangles ({tables.route} route); lanes "
        f"from twin bounces in {time.perf_counter() - t0:.2f} s. Bitwise equal to their twins on "
        f"all {S} lanes and the first {n} at teams {list(binding.TEAMS)}: "
        f"sphere_closest_clustered ({int((ref_s[1] >= 0).sum())} hits), any_hit_clustered "
        f"({int(ref_occ.sum())} blocked of {int((st >= shade.EPS).sum())} queries; spheres alone "
        f"{int(ref_socc.sum())}); any_hit on mesh_{FLAT_TRIS}'s {fo.shape[0]} shadow lanes with "
        f"its {ft.leaf.shape[0]} triangle boxes ({int(f_occ.sum())} blocked). ms kernel vs twin: "
        + ", ".join(f"{k} {a:.4f} vs {b:.4f}" for k, (a, b) in ms.items())
        + "; bounds " + json.dumps(bounds) + f"; on the first {n} lanes: " + json.dumps(at_slice))
    log("[cluster-kernels] (closest, any hit) ms by team: " + json.dumps(by_team)
        + f"; flat any hit by team {json.dumps(flat_by_team)}; triangle_closest on the "
        f"field's first {n} lanes ({int((ref_t[1] >= 0).sum())} hits) bitwise equal to its twin "
        f"at every team, {tri_ms:.4f} ms ({tri_q:.4f} queued) at team {tri_team}, by team {json.dumps(tri_by_team)}, "
        f"bound {json.dumps(tri_bound)}; host team "
        + json.dumps({k: v["team"] for k, v in extra.items()}) + "; per ray "
        + json.dumps({k: v["per_ray"] for k, v in extra.items()}))

    extra["triangle_closest"] = {"team_16384": tri_team, "ms_16384": tri_ms,
                                 "queued_ms_16384": tri_q,
                                 "bound_ms_16384": tri_bound["bound_ms"],
                                 "bound_by_16384": tri_bound["bound_by"],
                                 "ms_by_team_16384": tri_by_team}

    scene = on_pbr_scene(dev)
    camera = scenes.default_spheres_camera(1920, 1080, dev)
    ft = shade.build_tables(scene)
    batch = lane_states(scene, camera, ft, SLICE_S)
    kw = bounce_kwargs(scene, "mis", 16)
    ref, occ_ref, ms_split, err = hold_pool_kernels("ON/PBR", ft, batch, kw)
    worst["fused_bounce_on_pbr"] = err
    split = tuple(binding.sweep_split(ft.sph.shape[0] + ft.tri.shape[0], k) for k in KERNELS)
    ms["fused_bounce_on_pbr"] = {
        "split": split, "by_split": ms_split,
        "twin": (cuda_ms(lambda: shade.fused_bounce_reference(ft, *batch, **kw), **slow),)}
    row_ops = scene.tri_v0.shape[0] * TRI_OPS + scene.sph_center.shape[0] * SPH_OPS
    bounds["fused_bounce_on_pbr"] = bound(nbytes(*batch, *ft, *ref),
                                          int(batch[0].sum()) * row_ops)
    kinds = ft.sph[:, 5].tolist() + ft.tri[:, 12].tolist()
    log(f"[cluster-kernels] ON/PBR scene S={SLICE_S} (kinds "
        f"{sorted(set(int(k) for k in kinds))}, host split {split}): fused_bounce_on_pbr and "
        f"shadow_any_hit ({int(occ_ref.sum())} blocked) bitwise equal to their twins at every "
        f"split; ms (fused, shadow) by split {json.dumps(ms_split)}; twin "
        f"{ms['fused_bounce_on_pbr']['twin'][0]:.4f} ms; bound "
        f"{json.dumps(bounds['fused_bounce_on_pbr'])}")
    return worst, ms, bounds, at_slice, extra, (tables, o, d, so, sd, st)


def run_cluster_frames(dev):
    """Phase 4e: the sphere field through the composed pool and the wave
    engine, and the ON/PBR scene through the fused pool, on the card against
    the CPU twins: equal ray counts, images within the imgutil budget."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.pool import ray_count, render_pool
    from pathtrace_tpu_torch.render import RenderConfig, render

    for name, build, cam_fn, kw, want in (
        ("sphere field pool", sphere_field, scenes.many_spheres_camera, FIELD_POOL,
         {"sphere_closest_clustered", "triangle_closest", "any_hit_clustered"}),
        ("ON/PBR fused pool", on_pbr_scene, scenes.default_spheres_camera, ON_PBR_POOL,
         {"fused_bounce_raygen_on_pbr", "shadow_any_hit"}),
    ):
        W, H = kw["width"], kw["height"]
        shade.LAUNCHES.clear()
        img, counters, iters = render_pool(build(dev), cam_fn(W, H, dev), **kw)
        img = img.cpu().numpy()
        launches = dict(shade.LAUNCHES)
        t0 = time.perf_counter()
        img_cpu, counters_cpu, iters_cpu = render_pool(build("cpu"), cam_fn(W, H, "cpu"), **kw)
        cpu_s = time.perf_counter() - t0
        rays, rays_cpu = ray_count(counters), ray_count(counters_cpu)
        if (rays, iters) != (rays_cpu, iters_cpu):
            raise AssertionError(f"{name}: GPU {rays} rays {iters} iters, CPU {rays_cpu} rays "
                                 f"{iters_cpu} iters")
        assert_images_match(img, img_cpu.numpy())
        if set(launches) != want or min(launches.values()) <= 0:
            raise AssertionError(f"{name} launched {launches}")
        log(f"[cluster-frames] {name} {W}x{H} {kw['spp']}spp MIS depth {kw['max_bounces']}: "
            f"rays {rays}, iters {iters} on both (CPU {cpu_s:.1f} s); max pixel diff "
            f"{np.abs(img - img_cpu.numpy()).max():.4g}; launches {launches}")

    W, H = FIELD_WAVE["width"], FIELD_WAVE["height"]
    cfg = RenderConfig(**FIELD_WAVE)
    shade.LAUNCHES.clear()
    gpu = render(sphere_field(dev), scenes.many_spheres_camera(W, H, dev), cfg)
    img = gpu.image.cpu().numpy()
    launches = dict(shade.LAUNCHES)
    cpu = render(sphere_field("cpu"), scenes.many_spheres_camera(W, H, "cpu"), cfg)
    if gpu.ray_queries != cpu.ray_queries:
        raise AssertionError(f"sphere field wave: rays GPU {gpu.ray_queries} vs CPU "
                             f"{cpu.ray_queries}")
    assert_images_match(img, cpu.image.numpy())
    if set(launches) != {"sphere_closest_clustered", "triangle_closest", "any_hit_clustered"}:
        raise AssertionError(f"sphere field wave launched {launches}")
    log(f"[cluster-frames] sphere field wave {W}x{H} 1spp MIS: rays {gpu.ray_queries} on both; "
        f"max pixel diff {np.abs(img - cpu.image.numpy()).max():.4g}; launches {launches}")


def run_cluster_bench(dev, smi: str):
    """Phase 5e: the sphere field (composed pool) and the ON/PBR scene (fused
    pool) at 1920x1080, 4 spp, MIS, 32 bounces, 16,384 slots, timed, after a
    1-spp warm-up. The profiler's device time and operations come from the
    same scene at ``CLUSTER_PROFILED`` (a quarter of the pixels, the same
    slots, so the same work an iteration in a quarter of the iterations:
    the profiler takes ~0.25 ms an event), divided by that frame's unprofiled
    wall (busy share) and by its iterations; the 4-spp frame gives wall,
    Mrays/s, rays, iterations and the checksum. Returns the launches of both
    frames' kernels, and those of the sphere field's frame alone."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.pool import busy_count, ray_count, render_pool

    W, H = CLUSTER_FRAME["width"], CLUSTER_FRAME["height"]
    all_launches = {}
    field_launches = {}
    for name, build, cam_fn, want in (
        (f"many_spheres(n_per_side={FIELD_N})", sphere_field, scenes.many_spheres_camera,
         ("sphere_closest_clustered", "any_hit_clustered", "triangle_closest")),
        ("on_pbr", on_pbr_scene, scenes.default_spheres_camera,
         ("fused_bounce_raygen_on_pbr",)),
    ):
        scene, camera = build(dev), cam_fn(W, H, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_pool(scene, camera, **dict(CLUSTER_FRAME, spp=1))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        small = dict(CLUSTER_FRAME, **CLUSTER_PROFILED)
        small_cam = cam_fn(small["width"], small["height"], dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, iters1 = render_pool(scene, small_cam, **small)
        torch.cuda.synchronize()
        small_s = time.perf_counter() - t0
        dev_ms, dev_ops, _ = device_work(lambda: render_pool(scene, small_cam, **small))
        shade.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, counters, iters = render_pool(scene, camera, **CLUSTER_FRAME)
        checksum = float(img.double().sum().item())     # forces completion
        wall = time.perf_counter() - t0
        launches = dict(shade.LAUNCHES)
        if not torch.isfinite(img).all():
            raise AssertionError(f"{name}: image not finite")
        for k in want:
            if launches.get(k, 0) <= 0:
                raise AssertionError(f"{k} was not launched on the {name} frame: {launches}")
        rays = ray_count(counters)
        if (rays, iters, round(checksum, 2)) != CLUSTER_EXPECT[name]:
            raise AssertionError(f"{name}: {rays} rays, {iters} iterations, checksum {checksum}; "
                                 f"expected {CLUSTER_EXPECT[name]}")
        slots = min(CLUSTER_FRAME["num_slots"], W * H)
        result = {
            "workload": f"{name} {W}x{H} {CLUSTER_FRAME['spp']}spp MIS depth "
                        f"{CLUSTER_FRAME['max_bounces']}",
            "total_rays": rays, "iters": iters,
            "occupancy": busy_count(counters) / max(iters * slots, 1),
            "wall_s": wall, "mrays_per_s": rays / wall / 1e6, "image_checksum": checksum,
            "warmup_1spp_s": warm_s,
            "profiled": f"{small['width']}x{small['height']} {small['spp']}spp",
            "iters_profiled": iters1, "wall_s_profiled_frame": small_s,
            "device_ms_profiled": dev_ms, "device_ops_per_iter": dev_ops / iters1,
            "busy_share": dev_ms / 1e3 / small_s if dev_ms else None,
            "kernel_launches_per_iter": {k: launches[k] / iters for k in sorted(launches)},
            "card": smi,
        }
        log("[cluster-bench] " + json.dumps(result))
        all_launches.update(launches)
        field_launches = field_launches or launches
    return all_launches, field_launches


def parity_scene(name: str, builder, M):
    """A parity scene of ``tests/test_parity.py``, built with ``builder`` (a
    ``SceneBuilder`` of either package) from the materials of ``M`` (that
    package's ``models.materials``), so both packages build it from one
    recipe: ``"diffuse"`` (its ``cornell_diffuse``: Lambert walls, a
    triangle light, a grey sphere), ``"sphere_light"`` (its
    ``cornell_sphere_light``: the walls lit by an emissive sphere) or
    ``"oren_nayar"`` (its Oren-Nayar walls and sphere)."""
    s, d, ls = 1.0, -2.0, 0.3
    if name == "oren_nayar":
        rough, grey = M.OrenNayar((0.7, 0.4, 0.3), 0.5), M.OrenNayar((0.6, 0.6, 0.6), 0.8)
        walls = (rough, rough, grey, grey, grey)
    else:
        walls = (M.Lambertian((0.8, 0.1, 0.1)), M.Lambertian((0.1, 0.8, 0.1)),
                 M.Lambertian((0.2, 0.2, 0.8)), M.Lambertian((0.2, 0.8, 0.8)),
                 M.Lambertian((0.8, 0.8, 0.8)))
    left, right, back, floor, ceiling = walls
    b = builder
    b.add_triangle((-s, -s, d - s), (-s, s, d - s), (-s, s, d + s), left)
    b.add_triangle((-s, -s, d - s), (-s, s, d + s), (-s, -s, d + s), left)
    b.add_triangle((s, -s, d - s), (s, s, d + s), (s, s, d - s), right)
    b.add_triangle((s, -s, d - s), (s, -s, d + s), (s, s, d + s), right)
    b.add_triangle((-s, -s, d - s), (s, -s, d - s), (s, s, d - s), back)
    b.add_triangle((-s, -s, d - s), (s, s, d - s), (-s, s, d - s), back)
    b.add_triangle((-s, -s, d - s), (s, -s, d + s), (s, -s, d - s), floor)
    b.add_triangle((-s, -s, d - s), (-s, -s, d + s), (s, -s, d + s), floor)
    b.add_triangle((-s, s, d - s), (s, s, d - s), (s, s, d + s), ceiling)
    b.add_triangle((-s, s, d - s), (s, s, d + s), (-s, s, d + s), ceiling)
    if name == "sphere_light":
        b.add_sphere((0.0, s - 0.21, d), 0.2, M.Emissive((36.0, 36.0, 36.0)))
    else:
        light = M.Emissive((15.0, 15.0, 15.0))
        b.add_triangle((-ls, s - 0.01, d - ls), (ls, s - 0.01, d - ls), (ls, s - 0.01, d + ls),
                       light)
        b.add_triangle((-ls, s - 0.01, d - ls), (ls, s - 0.01, d + ls), (-ls, s - 0.01, d + ls),
                       light)
    if name == "oren_nayar":
        b.add_sphere((0.4, -0.6, d), 0.4, M.OrenNayar((0.5, 0.5, 0.7), 0.3))
    else:
        b.add_sphere((0.4, -0.6, d), 0.4, M.Lambertian((0.6, 0.6, 0.6)))
    return b.build()


def parity_stats(img, ref) -> tuple[np.ndarray, float]:
    """``(|channel-mean difference|, RMSE)`` of two ``(H, W, 3)`` images, as
    ``tests/test_parity.py`` compares a render with the oracle."""
    img, ref = np.asarray(img, np.float64), np.asarray(ref, np.float64)
    return (np.abs(img.mean(axis=(0, 1)) - ref.mean(axis=(0, 1))),
            float(np.sqrt(((img - ref) ** 2).mean())))


def run_parity(dev, smi: str):
    """Phase 7: parity against the C++ oracle (``csrc/oracle.cpp``), on the
    card: ``tests/test_parity.py``'s five cases at their own sizes, seeds and
    tolerances through the port's ``render`` on the card against
    ``oracle.render_oracle`` on the host; the pixel (79, 176) anchor (2,048
    samples through ``debug.render_pixel_samples`` against
    ``render_oracle_window``, with the blue-wall shape check); and the
    golden window, bitwise through the port's bridge."""
    from pathtrace_tpu_torch import oracle
    from pathtrace_tpu_torch.debug import render_pixel_samples
    from pathtrace_tpu_torch.models import materials, scenes
    from pathtrace_tpu_torch.models.scene import SceneBuilder
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.render import RenderConfig, render

    t0 = time.perf_counter()
    oracle.build()
    log(f"[parity] oracle built in {time.perf_counter() - t0:.2f} s")
    W = PARITY_SIZE
    shade.LAUNCHES.clear()
    for name, integrator, spp, oracle_spp, mean_tol, rmse_tol in PARITY_CASES:
        t0 = time.perf_counter()
        scene = (scenes.cornell_box(dev) if name == "cornell" else
                 parity_scene(name, SceneBuilder(dev), materials))
        camera = scenes.cornell_camera(W, W, dev)
        state = render(scene, camera, RenderConfig(
            width=W, height=W, spp=spp, integrator=integrator,
            samples_per_batch=min(spp, 32), seed=5))
        img = state.image.cpu().numpy()
        port_s = time.perf_counter() - t0
        ref = oracle.render_oracle(scene, camera, W, W, oracle_spp, integrator, seed=11)
        mean_diff, rmse = parity_stats(img, ref)
        log("[parity] " + json.dumps({
            "case": f"{name} {integrator}", "size": f"{W}x{W}", "spp": spp,
            "oracle_spp": oracle_spp, "mean_abs_diff": mean_diff.tolist(),
            "mean_tol": mean_tol, "rmse": rmse, "rmse_tol": rmse_tol, "port_s": port_s,
            "oracle_s": time.perf_counter() - t0 - port_s}))
        if not np.isfinite(img).all() or (mean_diff >= mean_tol).any() or rmse >= rmse_tol:
            raise AssertionError(f"parity {name} {integrator}: mean diff {mean_diff} (bound "
                                 f"{mean_tol}), RMSE {rmse} (bound {rmse_tol})")
    launches = dict(shade.LAUNCHES)
    if set(launches) != {"combined_closest_small", "any_hit"}:
        raise AssertionError(f"parity renders launched {launches}")

    G = GOLDEN_SIZE
    scene, camera = scenes.cornell_box(dev), scenes.cornell_camera(G, G, dev)
    x, y = PIXEL_ANCHOR
    ours = render_pixel_samples(scene, camera, x, y, width=G, height=G, spp=PIXEL_ANCHOR_SPP,
                                integrator="mis", max_bounces=64, seed=0).mean(axis=0)
    ref = oracle.render_oracle_window(scene, camera, G, G, x, y, 1, 1, PIXEL_ANCHOR_SPP,
                                      integrator="mis", seed=0)[0, 0]
    log(f"[parity] pixel {PIXEL_ANCHOR} at {PIXEL_ANCHOR_SPP} spp: port {ours.tolist()}, "
        f"oracle {ref.tolist()}")
    if not (ref[2] > 2.5 * ref[0] and ref[2] > 2.5 * ref[1]):
        raise AssertionError(f"pixel {PIXEL_ANCHOR}: the oracle's {ref} is not the blue wall")
    np.testing.assert_allclose(ours, ref, atol=0.02, rtol=0.12)

    x0, y0, w, h = GOLDEN_WINDOW
    win = oracle.render_oracle_window(scene, camera, G, G, x0, y0, w, h, GOLDEN_SPP,
                                      integrator="mis", seed=0)
    np.testing.assert_array_equal(win, np.load(GOLDEN)["image"][y0:y0 + h, x0:x0 + w])
    log(f"[parity] golden window [{y0}:{y0 + h}, {x0}:{x0 + w}] at {GOLDEN_SPP} spp: "
        f"bitwise equal; card {smi}")


def run_cli():
    """Phase 6: the port's CLI renders a wave frame, and a mesh pool frame
    under ``--method resident``, on the card."""
    for args in (["--scene", "cornell", "--engine", "wave", "--width", "64", "--height", "64",
                  "--spp", "2"],
                 ["--scene", "mesh", "--method", "resident", "--engine", "pool", "--width",
                  "32", "--height", "32", "--spp", "1", "--max-bounces", "4",
                  "--pool-slots", "1024"],
                 ["--scene", "many-spheres", "--engine", "pool", "--width", "32", "--height",
                  "32", "--spp", "1", "--max-bounces", "4", "--pool-slots", "1024"]):
        # The last one renders the 1,940-sphere field: the CLI's many-spheres
        # scene built with n_per_side=22 (the clustered sphere kernels).
        entry = ("from pathtrace_tpu_torch import cli; raise SystemExit(cli.main())"
                 if "many-spheres" not in args else
                 "import functools; from pathtrace_tpu_torch import cli; "
                 "from pathtrace_tpu_torch.models import scenes; "
                 f"scenes.many_spheres = functools.partial(scenes.many_spheres, "
                 f"n_per_side={FIELD_N}); raise SystemExit(cli.main())")
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "cli.png")
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-c", entry, "render", *args, "--device", "cuda", "--out", out],
                capture_output=True, text=True, timeout=300)
            if r.returncode != 0:
                raise AssertionError(f"CLI {args} exited {r.returncode}: {r.stderr[-2000:]}")
            with open(out, "rb") as f:
                if f.read(8) != b"\x89PNG\r\n\x1a\n":
                    raise AssertionError(f"CLI {args}: output is not a PNG")
        log(f"[cli] render {' '.join(args)} --device cuda: exit 0, PNG written "
            f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pathtrace_tpu_torch", "bench", "--small"],
                       capture_output=True, text=True, timeout=300)
    lines = r.stdout.splitlines()
    if r.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"CLI bench --small exited {r.returncode} with {len(lines)} "
                             f"lines: {r.stdout[-2000:]} {r.stderr[-2000:]}")
    line = json.loads(lines[0])
    if (set(line) != {"metric", "value", "unit", "vs_baseline", "extra"}
            or set(line["extra"]) != BENCH_EXTRA_KEYS or line["vs_baseline"] is not None
            or line["extra"]["platform"] != "cuda"):
        raise AssertionError(f"CLI bench --small printed {lines[0]}")
    log(f"[cli] bench --small: {lines[0]} ({time.perf_counter() - t0:.1f} s)")


def check_f64_kernels(dev):
    """Phase 3f: the float64 instances of the four kernels against their
    float64 twins on the card, bitwise. ``fused_bounce`` and
    ``shadow_any_hit`` at every split on S = 16,384 real lane states of
    many_spheres and of the ON/PBR scene and on the edge lanes (repeated
    rows, misses, t_max NaN and inf); ``combined_closest_small`` and
    ``any_hit`` (one tile) at every team on phase 3c's 65,536 wave-Cornell
    lanes, on 1,024 edge lanes (t_max NaN, -1, 0, t_min, inf; t_min and t_max
    at the hit) and on the small tie case. Scenes are the float32 ones
    widened (``render.cast_floats``). Returns the worst errors, the times
    (kernel at the host's split or team, twin), the bounds (FP64 peak) and
    the times at every split or team."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import intersect, shade
    from pathtrace_tpu_torch.render import cast_floats

    f64 = torch.float64
    worst = dict.fromkeys(F64_KERNELS, 0.0)
    ms, bounds, extra = {}, {}, {}
    for name, scene, camera in (
        ("many_spheres", scenes.many_spheres(device=dev),
         scenes.many_spheres_camera(1920, 1080, dev)),
        ("on_pbr", on_pbr_scene(dev), scenes.default_spheres_camera(1920, 1080, dev)),
    ):
        scene, camera = cast_floats(scene, f64), cast_floats(camera, f64)
        tables = shade.build_tables(scene)
        batch = lane_states(scene, camera, tables, SLICE_S)
        if batch[2].dtype != f64 or batch[7].dtype != f64:
            raise AssertionError(f"{name}: lanes in {batch[2].dtype}, uniforms {batch[7].dtype}")
        kw = bounce_kwargs(scene, "mis", 16)
        ref, occ_ref, ms_split, err = hold_pool_kernels(f"{name} f64", tables, batch, kw)
        worst["fused_bounce_f64"] = max(worst["fused_bounce_f64"], err)
        rows = tables.sph.shape[0] + tables.tri.shape[0]
        split = tuple(binding.sweep_split(rows, k) for k in KERNELS)
        so, sd, st = ref.next_o, ref.shadow_d, ref.shadow_tmax
        twin = (cuda_ms(lambda: shade.fused_bounce_reference(tables, *batch, **kw)),
                cuda_ms(lambda: shade.shadow_any_hit_reference(tables, so, sd, st)))
        log(f"[f64-kernels] {name} S={SLICE_S} float64 ({rows} rows, host split {split}): "
            f"fused_bounce and shadow_any_hit ({int(occ_ref.sum())} blocked) bitwise equal to "
            f"their float64 twins on every lane at splits {list(binding.SPLITS)}; ms "
            f"(fused_bounce, shadow_any_hit) by split {json.dumps(ms_split)}; twins {twin}")
        if name != "many_spheres":
            continue
        n_tri, n_sph = scene.tri_v0.shape[0], scene.sph_center.shape[0]
        row_ops = n_tri * TRI_OPS + n_sph * SPH_OPS
        query = st >= shade.EPS
        for which, k in enumerate(("fused_bounce_f64", "shadow_any_hit_f64")):
            ms[k] = (ms_split[split[which]][which], twin[which])
            extra[k] = {"split": split[which],
                        "ms_by_split": {t: v[which] for t, v in ms_split.items()}}
        bounds["fused_bounce_f64"] = bound(nbytes(*batch, *tables, *ref),
                                           int(batch[0].sum()) * row_ops, PEAK_FP64)
        bounds["shadow_any_hit_f64"] = bound(
            nbytes(so, sd, st, occ_ref, *tables),
            int((query & ~occ_ref).sum()) * row_ops + int((query & occ_ref).sum()) * SPH_OPS,
            PEAK_FP64)

    scene, tables, batch, ties = edge_lanes(dev, dtype=f64)
    kw = bounce_kwargs(scene, "mis", 16)
    ref = shade.fused_bounce_reference(tables, *batch, **kw)
    _, occ_ref, _, err = hold_pool_kernels("edge lanes f64", tables, batch, kw,
                                           shadow=edge_shadow(ref))
    worst["fused_bounce_f64"] = max(worst["fused_bounce_f64"], err)
    if ties == 0:
        raise AssertionError("f64 edge lanes: no tied lanes")
    log(f"[f64-kernels] edge lanes S={EDGE_S} float64: both kernels bitwise equal to their "
        f"twins at every split; {ties} lanes' nearest t shared by two rows, "
        f"{int(occ_ref.sum())} blocked shadow rays")

    # The wave engine's pair on the small route.
    S = WAVE_S
    scene = cast_floats(scenes.cornell_box(dev), f64)
    camera = cast_floats(scenes.cornell_camera(400, 400, dev), f64)
    tables = intersect.build_tables(scene)
    (o, d), (so, sd, st) = lane_rays(scene, camera, tables, S)
    lo = torch.full((S,), shade.EPS, dtype=f64, device=dev)
    hi = torch.full((S,), float("inf"), dtype=f64, device=dev)
    if o.dtype != f64 or st.dtype != f64 or tables.route != "small":
        raise AssertionError(f"wave lanes in {o.dtype}/{st.dtype} on {tables.route}")
    k = "combined_closest_small"
    ref = hold_wave_kernel(k, f"cornell f64, {S} lanes", tables, o, d, lo, hi)
    worst[k + "_f64"] = max(worst[k + "_f64"],
                            _bitwise(k + " f64", ref, intersect.combined_closest_small(
                                tables, o, d, lo, hi)))
    hold_wave_kernel(k, "cornell f64, edge lanes", tables, o[:EDGE_N], d[:EDGE_N],
                     *edge_ranges(lo, hi, ref[0], EDGE_N))
    m = len(SMALL_TIE_RAYS)
    tie, want = small_tie_tables(dev, f64)
    to = torch.tensor([[x, y, 5.0] for x, y in SMALL_TIE_RAYS], dtype=f64, device=dev)
    td = torch.tensor([[0.0, 0.0, -1.0]] * m, dtype=f64, device=dev)
    tref = hold_wave_kernel(k, "tie case f64", tie, to, td, lo[:m], hi[:m])
    if [int(p) for p in tref[1]] != [p for _, p in want]:
        raise AssertionError(f"small tie case f64: twin gave {tref[:2]}, expected {want}")
    by_team = team_times(k, tables, o, d, lo, hi)
    team = binding.small_team(tables)
    out = (torch.empty_like(lo), torch.empty(S, dtype=torch.int32, device=dev),
           torch.empty_like(o), torch.empty(S, dtype=torch.int32, device=dev))
    q_ms = queued_ms(lambda: binding.launch_combined_closest_small(tables, o, d, lo, hi, *out))
    ms[k + "_f64"] = (by_team[team],
                      cuda_ms(lambda: intersect.combined_closest_small_reference(
                          tables, o, d, lo, hi)))
    extra[k + "_f64"] = {"team": team, "ms_by_team": by_team, "queued_ms": q_ms}
    bounds[k + "_f64"] = bound(nbytes(o, d, lo, hi, tables.tri, tables.sph, *out),
                               S * (tables.tri_rows * TRI_OPS + tables.sph.shape[0] * SPH_OPS),
                               PEAK_FP64)

    tri = tables.tri[:tables.tri_rows]
    occ_ref = intersect.any_hit_reference(tables.sph, tri, so, sd, lo, st)
    worst["any_hit_f64"] = _bitwise("any_hit f64", occ_ref,
                                    intersect.any_hit(tables.sph, tri, so, sd, lo, st))
    occ = torch.empty_like(occ_ref)
    elo, ehi = edge_ranges(lo, st, torch.where(occ_ref, st, float("inf")), EDGE_N)
    eref = intersect.any_hit_reference(tables.sph, tri, so[:EDGE_N], sd[:EDGE_N], elo, ehi)
    a_team = {}
    for t in binding.TEAMS:
        occ.fill_(True)
        binding.launch_any_hit(tables.sph, tri, so, sd, lo, st, occ, team=t)
        _bitwise(f"any_hit f64 team {t}", occ_ref, occ)
        eocc = torch.ones_like(eref)
        binding.launch_any_hit(tables.sph, tri, so[:EDGE_N], sd[:EDGE_N], elo, ehi, eocc,
                               team=t)
        _bitwise(f"any_hit f64 edge lanes, team {t}", eref, eocc)
        a_team[t] = cuda_ms(lambda: binding.launch_any_hit(tables.sph, tri, so, sd, lo, st,
                                                           occ, team=t))
    a_host = binding.cluster_team("any_hit", (tables.sph, None), (tri, None))
    ms["any_hit_f64"] = (a_team[a_host], cuda_ms(lambda: intersect.any_hit_reference(
        tables.sph, tri, so, sd, lo, st)))
    extra["any_hit_f64"] = {"team": a_host, "ms_by_team": a_team,
                            "queued_ms": queued_ms(lambda: binding.launch_any_hit(
                                tables.sph, tri, so, sd, lo, st, occ))}
    query = st >= lo
    row_ops = tables.tri_rows * TRI_OPS + tables.sph.shape[0] * SPH_OPS
    bounds["any_hit_f64"] = bound(nbytes(so, sd, lo, st, tri, tables.sph, occ_ref),
                                  int((query & ~occ_ref).sum()) * row_ops
                                  + int((query & occ_ref).sum()) * SPH_OPS, PEAK_FP64)
    log(f"[f64-kernels] cornell wave S={S} float64: combined_closest_small ({int((ref[1] >= 0).sum())} "
        f"hits) bitwise equal to its twin through the wrapper (team {team}) and at every team, "
        f"on {EDGE_N} edge lanes and the tie case; {by_team[team]:.4f} ms ({q_ms:.4f} queued), "
        f"by team {json.dumps(by_team)}; any_hit ({int(occ_ref.sum())} blocked) bitwise at "
        f"every team and on {EDGE_N} edge lanes, by team {json.dumps(a_team)}; worst abs "
        f"error {worst}; bounds {json.dumps(bounds)}")
    return worst, ms, bounds, extra


def timed_once(fn):
    """``(fn(), ms)``: one call between CUDA events (the float64 twins,
    0.01-2 s a call, are timed on the call that gives the reference)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def teams_bitwise(name, ref, launch):
    """``launch(team, out)`` at every team size into outputs shaped as
    ``ref`` (scrubbed first), bitwise equal to ``ref``."""
    from pathtrace_tpu_torch.kernels import binding

    ref = ref if isinstance(ref, tuple) else (ref,)
    for team in binding.TEAMS:
        out = tuple(torch.full_like(x, float("nan") if x.is_floating_point() else -7)
                    if x.dtype != torch.bool else ~x for x in ref)
        launch(team, out)
        _bitwise(f"{name}, team {team}", ref, out)


def check_f64_route_kernels(dev, mesh, lanes, flat, field):
    """Phase 3g, kernels: the float64 instances of the flat and bvh routes
    against their float64 twins on the card, bitwise, at every team size
    1-32, on the lanes of phases 3b, 3c and 3e widened to float64 (exact):
    ``bvh_closest`` (also ``counters=True`` against the walk model),
    ``bvh_anyhit``, ``sphere_closest`` and the one-tile ``any_hit`` on the
    65,536 config-4 lanes (``lanes``), with :func:`bvh_edge_cases`;
    the clustered ``sphere_closest``/``any_hit`` and ``triangle_closest``
    on the first 16,384 lanes of the sphere field (``field``), with
    :func:`check_cluster_edges`; ``triangle_closest`` and the flat any hit
    on ``mesh_scene(2000)``'s 65,536 lanes (``flat``), edge lanes and the
    flat tie case. Each timed by events and queued at the host's team, at
    every team, its twin on the call that gives the reference, the float32
    instance on the float32 lanes beside it; bounds at the FP64 peak.
    Scenes are the float32 ones widened (``render.cast_floats``)."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import intersect, shade
    from pathtrace_tpu_torch.render import cast_floats

    f64, i32, inf = torch.float64, torch.int32, float("inf")
    worst, ms, bounds, extra = {}, {}, {}, {}

    def outs(o):
        n = o.shape[0]
        return (torch.empty(n, dtype=o.dtype, device=dev), torch.empty(n, dtype=i32, device=dev),
                torch.empty((n, 3), dtype=o.dtype, device=dev),
                torch.empty(n, dtype=i32, device=dev))

    def record(k, err, by_team, team, twin_ms, bnd, q_ms, f32_ms, **more):
        worst[k] = err
        ms[k] = (by_team[team], twin_ms)
        bounds[k] = bnd
        extra[k] = {"team": team, "ms_by_team": by_team, "queued_ms": q_ms, "ms_f32": f32_ms,
                    **more}

    # Config 4 (the bvh route): phase 3b's lanes, widened.
    S = MESH_S
    t32 = intersect.build_tables(mesh)
    tables = intersect.build_tables(cast_floats(mesh, f64))
    o, d, lo, so, sd, st = (lanes[k].to(f64) for k in ("o", "d", "lo", "so", "sd", "st"))
    hi = torch.full((S,), inf, dtype=f64, device=dev)
    ref_s, s_twin = timed_once(lambda: intersect.sphere_closest_reference(tables.sph, o, d, lo,
                                                                          hi))
    err_s = _bitwise("sphere_closest f64", ref_s,
                     intersect.sphere_closest(tables.sph, o, d, lo, hi))
    hi_t = torch.minimum(hi, ref_s[0])
    ref_t, t_twin = timed_once(lambda: intersect.bvh_closest_reference(tables, o, d, lo, hi_t))
    err_t = _bitwise("bvh_closest f64", ref_t, intersect.bvh_closest(tables, o, d, lo, hi_t))
    ref_occ, a_twin = timed_once(lambda: intersect.bvh_anyhit_reference(tables, so, sd, lo, st))
    _bitwise("bvh_anyhit f64", ref_occ, intersect.bvh_anyhit(tables, so, sd, lo, st))
    no_tris = tables.tri[:0]
    ref_socc = intersect.any_hit_reference(tables.sph, no_tris, so, sd, lo, st)
    _bitwise("any_hit f64, config-4 spheres", ref_socc,
             intersect.any_hit(tables.sph, no_tris, so, sd, lo, st))
    model, a_model = hold_bvh_kernels("config-4 lanes f64", tables, (o, d, lo, hi_t, ref_t),
                                      (so, sd, lo, st, ref_occ))
    _, m_twin = timed_once(lambda: intersect.bvh_traversal_reference(tables, o, d, lo, hi_t,
                                                                     chunk=S))
    shade.LAUNCHES.clear()
    sums = tuple(intersect.bvh_span_sums(c, S) for c in model[4:])
    err_c = _bitwise("bvh_closest(counters=True) f64 vs the model's per-span sums", ref_t + sums,
                     intersect.bvh_closest(tables, o, d, lo, hi_t, counters=True))
    counter_launches = shade.LAUNCHES["bvh_closest_counters_f64"]
    bvh_edge_cases(dev, tables, o, d, so, sd, lo)
    teams_bitwise("sphere_closest f64", ref_s, lambda team, out: binding.launch_sphere_closest(
        tables.sph, o, d, lo, hi, *out, team=team))
    teams_bitwise("any_hit f64, config-4 spheres", ref_socc, lambda team, out: (
        binding.launch_any_hit(tables.sph, no_tris, so, sd, lo, st, *out, team=team)))

    out, out32 = outs(o), outs(lanes["o"])
    counts = (torch.empty(S, dtype=i32, device=dev), torch.empty(S, dtype=i32, device=dev))
    occ = torch.empty(S, dtype=torch.bool, device=dev)
    l32 = [lanes[k] for k in ("o", "d", "lo", "hi_t", "so", "sd", "st")]
    by_team = {team: (
        cuda_ms(lambda: binding.launch_bvh_closest(tables, o, d, lo, hi_t, *out, team=team)),
        cuda_ms(lambda: binding.launch_bvh_anyhit(tables, so, sd, lo, st, occ, team=team)),
        cuda_ms(lambda: binding.launch_bvh_closest(tables, o, d, lo, hi_t, *out, counts=counts,
                                                   team=team)),
        cuda_ms(lambda: binding.launch_sphere_closest(tables.sph, o, d, lo, hi, *out,
                                                      team=team)))
        for team in binding.TEAMS}
    q = (queued_ms(lambda: binding.launch_bvh_closest(tables, o, d, lo, hi_t, *out)),
         queued_ms(lambda: binding.launch_bvh_anyhit(tables, so, sd, lo, st, occ)),
         queued_ms(lambda: binding.launch_bvh_closest(tables, o, d, lo, hi_t, *out,
                                                      counts=counts)),
         queued_ms(lambda: binding.launch_sphere_closest(tables.sph, o, d, lo, hi, *out)))
    f32 = (cuda_ms(lambda: binding.launch_bvh_closest(t32, *l32[:4], *out32)),
           cuda_ms(lambda: binding.launch_bvh_anyhit(t32, l32[4], l32[5], l32[2], l32[6],
                                                     occ)),
           cuda_ms(lambda: binding.launch_bvh_closest(t32, *l32[:4], *out32, counts=counts)),
           cuda_ms(lambda: binding.launch_sphere_closest(t32.sph, l32[0], l32[1], l32[2],
                                                         lanes["lo"].new_full((S,), inf),
                                                         *out32)))
    rays, c_out = nbytes(o, d, lo, hi), nbytes(*out)
    tri_bytes = nbytes(tables.tri, tables.leaf, tables.group)
    need_c = closest_tests(tables.leaf, intersect.LEAF, o, d, lo, hi_t, ref_t[0])
    need_a = anyhit_tests(tables.leaf, intersect.LEAF, so, sd, lo, st, ref_occ)
    mesh_bounds = (
        bound(rays + tri_bytes + c_out, TRI_OPS * need_c, PEAK_FP64),
        bound(nbytes(so, sd, lo, st, occ) + tri_bytes, TRI_OPS * need_a, PEAK_FP64),
        bound(rays + tri_bytes + c_out + nbytes(*counts), TRI_OPS * need_c, PEAK_FP64),
        bound(rays + nbytes(tables.sph) + c_out, S * tables.sph.shape[0] * SPH_OPS,
              PEAK_FP64))
    per_ray = {"groups": model[4].double().mean().item(),
               "leaves": model[5].double().mean().item(), "bound_tests": need_c / S}
    a_per_ray = {"groups": a_model[1].double().mean().item(),
                 "leaves": a_model[2].double().mean().item(), "bound_tests": need_a / S}
    for which, (k, team, twin, err, more) in enumerate((
            ("bvh_closest_f64", binding._bvh_team(tables, None, "bvh_closest"), t_twin, err_t,
             {"per_ray": per_ray}),
            ("bvh_anyhit_f64", binding._bvh_team(tables, None, "bvh_anyhit"), a_twin, 0.0,
             {"per_ray": a_per_ray}),
            ("bvh_closest_counters_f64", binding._bvh_team(tables, None, "bvh_closest"), m_twin,
             err_c, {}),
            ("sphere_closest_f64", binding.cluster_team("sphere_closest", (tables.sph, None)),
             s_twin, err_s, {}))):
        record(k, err, {t: v[which] for t, v in by_team.items()}, team, twin,
               mesh_bounds[which], q[which], f32[which], **more)
    log(f"[f64-routes] config 4 float64, {S} lanes: sphere_closest ({int((ref_s[1] >= 0).sum())} "
        f"hits), bvh_closest ({int((ref_t[1] >= 0).sum())} hits, counters too), bvh_anyhit "
        f"({int(ref_occ.sum())} blocked) and any_hit bitwise equal to their float64 twins at "
        f"every team, on edge lanes and the tie case; ms by team (closest, any hit, counters, "
        f"spheres) {json.dumps(by_team)}; queued {q}; float32 {f32}; twins {t_twin:.1f}, "
        f"{a_twin:.1f}, {m_twin:.1f}, {s_twin:.2f} ms; per ray {per_ray}, {a_per_ray}")

    # The sphere field (clustered spheres, the flat route's 2 triangles):
    # phase 3e's first 16,384 lanes, widened.
    ft32, fo, fd, fso, fsd, fst = field
    n = SLICE_S
    ft = intersect.build_tables(cast_floats(sphere_field(dev), f64))
    box, tri = ft.sph_box, ft.tri[:ft.tri_rows]
    o, d, so, sd, st = (x[:n].to(f64) for x in (fo, fd, fso, fsd, fst))
    lo = torch.full((n,), shade.EPS, dtype=f64, device=dev)
    hi = torch.full((n,), inf, dtype=f64, device=dev)
    ref_s, s_twin = timed_once(lambda: intersect.sphere_closest_reference(ft.sph, o, d, lo, hi))
    err_s = _bitwise("sphere_closest_clustered f64", ref_s,
                     intersect.sphere_closest(ft.sph, o, d, lo, hi, box=box))
    ref_occ, a_twin = timed_once(lambda: intersect.any_hit_reference(ft.sph, tri, so, sd, lo, st))
    _bitwise("any_hit_clustered f64", ref_occ,
             intersect.any_hit(ft.sph, tri, so, sd, lo, st, sph_box=box, tri_box=ft.leaf))
    c_model, ca_model = hold_cluster_kernels("field f64, first 16384 lanes", ft.sph, box,
                                             (o, d, lo, hi, ref_s), (so, sd, lo, st, ref_occ),
                                             tri, ft.leaf)
    check_cluster_edges(dev, ft, (o, d, so, sd, lo))
    fl = (o, d, lo, torch.minimum(hi, ref_s[0]))
    ref_ft, ft_twin = timed_once(lambda: intersect.triangle_closest_reference(ft, *fl))
    hold_wave_kernel("triangle_closest", "field f64, first 16384 lanes", ft, *fl)
    out, out32 = outs(o), outs(fo[:n])
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    f32l = (fo[:n], fd[:n], lanes["lo"][:n], torch.full((n,), inf, device=dev))
    ftri32 = ft32.tri[:ft32.tri_rows]
    by_team = {team: (
        cuda_ms(lambda: binding.launch_sphere_closest(ft.sph, o, d, lo, hi, *out, box=box,
                                                      team=team)),
        cuda_ms(lambda: binding.launch_any_hit(ft.sph, tri, so, sd, lo, st, occ, sph_box=box,
                                               tri_box=ft.leaf, team=team)))
        for team in binding.TEAMS}
    host = (binding.cluster_team("sphere_closest", (ft.sph, box)),
            binding.cluster_team("any_hit", (ft.sph, box), (tri, ft.leaf)))
    q = (queued_ms(lambda: binding.launch_sphere_closest(ft.sph, o, d, lo, hi, *out, box=box)),
         queued_ms(lambda: binding.launch_any_hit(ft.sph, tri, so, sd, lo, st, occ, sph_box=box,
                                                  tri_box=ft.leaf)))
    f32 = (cuda_ms(lambda: binding.launch_sphere_closest(ft32.sph, *f32l, *out32,
                                                         box=ft32.sph_box)),
           cuda_ms(lambda: binding.launch_any_hit(ft32.sph, ftri32, fso[:n], fsd[:n], f32l[2],
                                                  fst[:n], occ, sph_box=ft32.sph_box,
                                                  tri_box=ft32.leaf)))
    tri_by_team = team_times("triangle_closest", ft, *fl)
    tri_team = binding.flat_team(ft)
    tri_q = queued_ms(lambda: binding.launch_triangle_closest(ft, *fl, *out))
    tri_bound = bound(nbytes(*fl, tri, ft.leaf, *out),
                      TRI_OPS * closest_tests(ft.leaf, real_rows(ft), *fl, ref_ft[0]), PEAK_FP64)
    per_box = torch.clamp(ft.sph.shape[0] - 256 * torch.arange(box.shape[0], device=dev), 0, 256)
    free = ~ref_occ
    rows_c = closest_tests(box, per_box, o, d, lo, hi, ref_s[0])
    rows_s = entered_rows(box, per_box, so[free], sd[free], lo[free], st[free])
    rows_t = entered_rows(ft.leaf, ft.tri_rows, so[free], sd[free], lo[free], st[free])
    n_occ = int(ref_occ.sum())
    field_bounds = (
        bound(nbytes(o, d, lo, hi, ft.sph, box, *out), SPH_OPS * rows_c, PEAK_FP64),
        bound(nbytes(so, sd, lo, st, occ, ft.sph, box, tri, ft.leaf),
              SPH_OPS * (rows_s + n_occ) + TRI_OPS * rows_t, PEAK_FP64))
    for which, (k, twin, err, res) in enumerate((
            ("sphere_closest_clustered_f64", s_twin, err_s, c_model),
            ("any_hit_clustered_f64", a_twin, 0.0, ca_model))):
        visited, tested = res[-2:]
        record(k, err, {t: v[which] for t, v in by_team.items()}, host[which], twin,
               field_bounds[which], q[which], f32[which], lanes=n,
               per_ray={"clusters": visited.double().mean().item(),
                        "rows": tested.double().mean().item()})
    field_tri = {"team_16384": tri_team, "ms_16384": tri_by_team[tri_team],
                 "queued_ms_16384": tri_q, "plain_ms_16384": ft_twin,
                 "bound_ms_16384": tri_bound["bound_ms"], "bound_by_16384": tri_bound["bound_by"],
                 "ms_by_team_16384": tri_by_team}
    log(f"[f64-routes] sphere field float64 ({ft.sph.shape[0]} spheres, {box.shape[0]} clusters), "
        f"first {n} lanes: sphere_closest_clustered ({int((ref_s[1] >= 0).sum())} hits), "
        f"any_hit_clustered ({n_occ} blocked) and triangle_closest "
        f"({int((ref_ft[1] >= 0).sum())} hits) bitwise equal to their float64 twins at every team, "
        f"on edge lanes and the sphere tie case; (closest, any hit) ms by team "
        f"{json.dumps(by_team)}; queued {q}; float32 {f32}; twins {s_twin:.2f}, {a_twin:.2f} ms; "
        f"triangle_closest {json.dumps(field_tri)}; bounds {json.dumps(field_bounds)}")

    # mesh_scene(2000) (the flat route): phase 3c's lanes, widened.
    mt32, mso, msd, mst, mo, md = flat
    S = WAVE_S
    mt = intersect.build_tables(cast_floats(scenes.mesh_scene(FLAT_TRIS, device=dev), f64))
    o, d, so, sd, st = (x.to(f64) for x in (mo, md, mso, msd, mst))
    lo = torch.full((S,), shade.EPS, dtype=f64, device=dev)
    hi = torch.full((S,), inf, dtype=f64, device=dev)
    hi_k = torch.minimum(hi, intersect.sphere_closest_reference(mt.sph, o, d, lo, hi)[0])
    ref, t_twin = timed_once(lambda: intersect.triangle_closest_reference(mt, o, d, lo, hi_k))
    hold_wave_kernel("triangle_closest", f"mesh_{FLAT_TRIS} f64, {S} lanes", mt, o, d, lo, hi_k)
    err_t = _bitwise("triangle_closest f64", ref, intersect.triangle_closest(mt, o, d, lo, hi_k))
    hold_wave_kernel("triangle_closest", f"mesh_{FLAT_TRIS} f64, edge lanes", mt, o[:EDGE_N],
                     d[:EDGE_N], *edge_ranges(lo, hi_k, ref[0], EDGE_N))
    to, td, tlo, thi, _ = (x.to(f64) for x in tie_rays(dev))
    for upper in (1, 7):
        tt, b = tie_tables(dev, upper, route="flat")
        tref = hold_wave_kernel("triangle_closest", f"tie case f64, B at row {b}",
                                widen_tables(tt, f64), to, td, tlo, thi)
        if not ((tref[0] == 5.0).all() and (tref[1] == 0).all()):
            raise AssertionError(f"flat tie case f64 (B at row {b}): twin gave {tref[:2]}")
    mtri = mt.tri[:mt.tri_rows]
    m_occ, ma_twin = timed_once(lambda: intersect.any_hit_reference(mt.sph, mtri, so, sd, lo, st))
    _bitwise("any_hit flat f64", m_occ,
             intersect.any_hit(mt.sph, mtri, so, sd, lo, st, sph_box=mt.sph_box, tri_box=mt.leaf))
    hold_cluster_kernels(f"mesh_{FLAT_TRIS} shadow lanes f64", mt.sph, mt.sph_box, None,
                         (so, sd, lo, st, m_occ), mtri, mt.leaf)
    out, out32 = outs(o), outs(mo)
    occ = torch.empty(S, dtype=torch.bool, device=dev)
    t_by_team = team_times("triangle_closest", mt, o, d, lo, hi_k)
    team = binding.flat_team(mt)
    t_q = queued_ms(lambda: binding.launch_triangle_closest(mt, o, d, lo, hi_k, *out))
    hi32 = torch.minimum(torch.full((S,), inf, device=dev), intersect.sphere_closest_reference(
        mt32.sph, mo, md, lanes["lo"].new_full((S,), shade.EPS), torch.full((S,), inf,
                                                                            device=dev))[0])
    lo32 = hi32.new_full((S,), shade.EPS)
    t_f32 = cuda_ms(lambda: binding.launch_triangle_closest(mt32, mo, md, lo32, hi32, *out32))
    flat_any = {t: cuda_ms(lambda: binding.launch_any_hit(
        mt.sph, mtri, so, sd, lo, st, occ, sph_box=mt.sph_box, tri_box=mt.leaf, team=t))
        for t in binding.TEAMS}
    extra["any_hit_clustered_f64"]["flat_ms_by_team"] = flat_any
    extra["any_hit_clustered_f64"]["flat_plain_ms"] = ma_twin
    t_bound = bound(nbytes(o, d, lo, hi_k, mtri, mt.leaf, *out),
                    TRI_OPS * closest_tests(mt.leaf, real_rows(mt), o, d, lo, hi_k, ref[0]),
                    PEAK_FP64)
    record("triangle_closest_f64", err_t, t_by_team, team, t_twin, t_bound, t_q, t_f32,
           **field_tri)
    log(f"[f64-routes] mesh_{FLAT_TRIS} float64, {S} lanes: triangle_closest "
        f"({int((ref[1] >= 0).sum())} hits) bitwise equal to its float64 twin at every team, on "
        f"{EDGE_N} edge lanes and the flat tie case; by team {json.dumps(t_by_team)}, queued "
        f"{t_q:.4f}, float32 {t_f32:.4f}, twin {t_twin:.2f} ms, bound {json.dumps(t_bound)}; "
        f"the flat any hit ({int(m_occ.sum())} blocked) bitwise at every team, by team "
        f"{json.dumps(flat_any)}; worst abs error {worst}")
    return worst, ms, bounds, extra, counter_launches


def run_f64_route_frames(dev, mesh, mesh_cam, smi: str):
    """Phase 3g, frames: float64 through the composed pool on the bvh and flat
    routes. Config 4 at 1 spp (1080p, ``method="auto"``: bvh) and the sphere
    field at 1 spp (1080p, 16,384 slots) in float64, timed, their rays within
    ``F64_RAYS_RTOL`` of the float32 frames' (config 4: ``METHOD_EXPECT``; the
    field's float32 frame is rendered here), launching only the float64
    kernels of their routes; ``mesh_scene(2000)`` at 32x32 (``FLAT_POOL``)
    in float64 on the card against the CPU twins: equal rays and
    iterations, images within the imgutil budget. Every launch counter is
    zeroed before a frame and read after it. Returns the launches of the
    three float64 frames."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.pool import ray_count, render_pool

    f64 = torch.float64
    frames, launches = {}, {}
    field = sphere_field(dev)
    W, H = CLUSTER_FRAME["width"], CLUSTER_FRAME["height"]
    for name, scene, camera, run, dtype, want in (
        ("config4", mesh, mesh_cam, dict(CONFIG4, spp=1), f64,
         {"bvh_closest_f64", "bvh_anyhit_f64", "sphere_closest_f64", "any_hit_f64"}),
        ("field", field, scenes.many_spheres_camera(W, H, dev), dict(CLUSTER_FRAME, spp=1), f64,
         {"sphere_closest_clustered_f64", "any_hit_clustered_f64", "triangle_closest_f64"}),
        ("field_f32", field, scenes.many_spheres_camera(W, H, dev), dict(CLUSTER_FRAME, spp=1),
         None, {"sphere_closest_clustered", "any_hit_clustered", "triangle_closest"}),
    ):
        shade.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, counters, iters = render_pool(scene, camera, dtype=dtype, **run)
        checksum = float(img.double().sum().item())     # forces completion
        wall = time.perf_counter() - t0
        got = dict(shade.LAUNCHES)
        if set(got) != want or not np.isfinite(checksum) or img.dtype != (dtype or torch.float32):
            raise AssertionError(f"{name} 1-spp frame: {img.dtype}, launches {got}, checksum "
                                 f"{checksum}")
        rays = ray_count(counters)
        frames[name] = {"total_rays": rays, "iters": iters, "image_checksum": checksum,
                        "wall_s": wall, "mrays_per_s": rays / wall / 1e6,
                        "launches_per_iter": {k: v / iters for k, v in sorted(got.items())}}
        launches[name] = got
    for name, f32_rays in (("config4", METHOD_EXPECT[0]),
                           ("field", frames["field_f32"]["total_rays"])):
        frames[name]["rays_rel_diff_vs_f32"] = (frames[name]["total_rays"] - f32_rays) / f32_rays
        if abs(frames[name]["rays_rel_diff_vs_f32"]) > F64_RAYS_RTOL:
            raise AssertionError(f"{name} float64 frame: {frames[name]['total_rays']} rays against "
                                 f"{f32_rays} in float32")
    log("[f64-route-frames] " + json.dumps({
        "workloads": f"1920x1080 1spp MIS: config 4 (mesh_scene, {mesh.num_tris} tris, depth "
                     f"{CONFIG4['max_bounces']}, {CONFIG4['num_slots']} slots, bvh) and "
                     f"many_spheres(n_per_side={FIELD_N}) (depth {CLUSTER_FRAME['max_bounces']}, "
                     f"{CLUSTER_FRAME['num_slots']} slots), composed pool",
        **frames, "card": smi}))

    W, H = FLAT_POOL["width"], FLAT_POOL["height"]
    shade.LAUNCHES.clear()
    img, counters, iters = render_pool(scenes.mesh_scene(FLAT_TRIS, device=dev),
                                       scenes.mesh_scene_camera(W, H, dev), dtype=f64,
                                       **FLAT_POOL)
    img = img.cpu().numpy()
    got = dict(shade.LAUNCHES)
    t0 = time.perf_counter()
    img_cpu, counters_cpu, iters_cpu = render_pool(
        scenes.mesh_scene(FLAT_TRIS, device="cpu"), scenes.mesh_scene_camera(W, H, "cpu"),
        dtype=f64, **FLAT_POOL)
    cpu_s = time.perf_counter() - t0
    rays, rays_cpu = ray_count(counters), ray_count(counters_cpu)
    if (rays, iters) != (rays_cpu, iters_cpu) or img.dtype != np.float64:
        raise AssertionError(f"flat pool f64: GPU {rays} rays {iters} iters, CPU {rays_cpu} "
                             f"rays {iters_cpu} iters ({img.dtype})")
    assert_images_match(img, img_cpu.numpy())
    if got.get("triangle_closest_f64", 0) != iters or set(got) != {
            "triangle_closest_f64", "sphere_closest_f64", "any_hit_clustered_f64"}:
        raise AssertionError(f"flat pool f64 launches {got} for {iters} iterations")
    launches["flat"] = got
    log(f"[f64-flat-pool] mesh_scene({FLAT_TRIS}) {W}x{H} {FLAT_POOL['spp']}spp MIS depth "
        f"{FLAT_POOL['max_bounces']} float64: rays {rays}, iters {iters} on the card and the CPU "
        f"twins (CPU {cpu_s:.1f} s); max pixel diff {np.abs(img - img_cpu.numpy()).max():.4g}; "
        f"launches {got}")
    return launches


def check_f64_traversal_kernels(dev, mesh, lanes):
    """Phase 3h, kernels: the float64 instances of the binned round pair and
    the resident pair against their float64 twins on the card, bitwise, at
    every team size 1-32, on phase 3b's 65,536 config-4 lanes widened to
    float64 (exact): the binned drivers on the kernels against the same
    drivers on the round twins and the brute-force twin on every lane, the
    round kernels at every team on every round's sorted wave of one call of
    each driver, on edge waves and the tie case (:func:`binned_edge_cases`);
    the resident pair at every team, the closest hit with its entries
    cached where they fit and recomputed, on the lanes, edge lanes, the
    padded tables (past the float64 fit) and the tie case
    (:func:`hold_resident_kernels`, :func:`resident_edge_cases`). Each
    timed at the host's team and at every team (the round pair on the first
    round's wave by events and summed over a driver call's waves queued),
    the float32 instance on the float32 lanes beside it, the twin on the
    call that gives the reference; bounds at the FP64 peak. The drivers'
    rounds and ray-rounds in both dtypes."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.ops import binned, intersect
    from pathtrace_tpu_torch.render import cast_floats

    f64, i32, inf = torch.float64, torch.int32, float("inf")
    sc = cast_floats(mesh, f64)
    tb, tr = intersect.build_tables(sc, "binned"), intersect.build_tables(sc, "resident")
    tb32, tr32 = intersect.build_tables(mesh, "binned"), intersect.build_tables(mesh, "resident")
    o, d, lo, so, sd, st = (lanes[k].to(f64) for k in ("o", "d", "lo", "so", "sd", "st"))
    S = o.shape[0]
    hi = torch.full((S,), inf, dtype=f64, device=dev)
    hi_t = torch.minimum(hi, intersect.sphere_closest_reference(tb.sph, o, d, lo, hi)[0])
    l32 = tuple(lanes[k] for k in ("o", "d", "lo", "hi_t", "so", "sd", "st"))
    ref_t, t_twin = timed_once(lambda: intersect.triangle_closest_reference(tr, o, d, lo, hi_t))
    ref_occ, a_twin = timed_once(lambda: intersect.bvh_anyhit_reference(tr, so, sd, lo, st))
    worst, ms, bounds, extra = {}, {}, {}, {}

    def outs(n, dtype):
        return (torch.empty(n, dtype=dtype, device=dev), torch.empty(n, dtype=i32, device=dev),
                torch.empty((n, 3), dtype=dtype, device=dev), torch.empty(n, dtype=i32, device=dev))

    # The binned drivers, float64 and float32: every round's wave captured,
    # the float64 results against the round twins' drivers and brute force.
    stats = {k: {} for k in ("closest", "anyhit", "closest_f32", "anyhit_f32")}
    got_c, waves_c = capture_rounds(binned.triangle_closest_binned, tb, o, d, lo, hi_t,
                                    stats=stats["closest"])
    _bitwise("binned closest driver f64 vs brute force", ref_t, got_c)
    _bitwise("binned closest driver f64 vs its round twin",
             binned.triangle_closest_binned(tb, o, d, lo, hi_t, round_twin=True), got_c)
    got_a, waves_a = capture_rounds(binned.triangle_anyhit_binned, tb, so, sd, lo, st,
                                    stats=stats["anyhit"])
    _bitwise("binned any-hit driver f64 vs brute force", ref_occ, got_a)
    _bitwise("binned any-hit driver f64 vs its round twin",
             binned.triangle_anyhit_binned(tb, so, sd, lo, st, round_twin=True), got_a)
    _, w32c = capture_rounds(binned.triangle_closest_binned, tb32, *l32[:4],
                             stats=stats["closest_f32"])
    _, w32a = capture_rounds(binned.triangle_anyhit_binned, tb32, l32[4], l32[5], l32[2], l32[6],
                             stats=stats["anyhit_f32"])
    for k, waves in (("closest", waves_c), ("anyhit", waves_a)):
        sizes = [w[4].shape[0] for w in waves]
        if (len(sizes), sum(sizes)) != (stats[k]["rounds"], stats[k]["ray_rounds"]):
            raise AssertionError(f"binned {k} f64: captured {len(sizes)} waves of {sum(sizes)} "
                                 f"rays, the driver counted {stats[k]}")
    rc, ra = waves_c[0], waves_a[0]
    refs_c, refs_a = hold_binned_rounds("driver call f64", tb, waves_c, waves_a)
    ref_rc, ref_ra = refs_c[0], refs_a[0]
    worst["binned_round_closest_f64"] = _bitwise("binned_round_closest f64", ref_rc,
                                                 binned.round_closest(tb, *rc))
    worst["binned_round_anyhit_f64"] = _bitwise("binned_round_anyhit f64", ref_ra,
                                                binned.round_anyhit(tb, *ra))
    binned_edge_cases(dev, tb, rc, ra, ref_rc[0], binned.round_closest_reference(tb, *ra)[0])

    # The resident pair: through the wrappers (the host's team and mode),
    # then raw at every team and mode on the lanes, edge lanes, padded
    # tables and the tie case.
    worst["resident_closest_f64"] = _bitwise("resident_closest f64", ref_t,
                                             intersect.resident_closest(tr, o, d, lo, hi_t))
    worst["resident_anyhit_f64"] = _bitwise("resident_anyhit f64", ref_occ,
                                            intersect.resident_anyhit(tr, so, sd, lo, st))
    r_lanes = (o, d, lo, hi_t, ref_t), (so, sd, lo, st, ref_occ)
    r_model, r_a_model = hold_resident_kernels("config-4 lanes f64", tr, *r_lanes)
    resident_edge_cases(dev, tr, *r_lanes)

    # Times: the round pair at every team on the first round's wave and
    # summed over the driver call's waves; the float32 instance beside it,
    # at the float32 host team.
    outs_c = [outs(w[4].shape[0], f64) for w in waves_c]
    occs_a = [torch.empty(w[4].shape[0], dtype=torch.bool, device=dev) for w in waves_a]
    outs32 = [outs(w[4].shape[0], torch.float32) for w in w32c]
    occs32 = [torch.empty(w[4].shape[0], dtype=torch.bool, device=dev) for w in w32a]
    rounds = {"binned_round_closest_f64": (
                  lambda j, team: binding.launch_binned_round_closest(
                      tb, *waves_c[j], *outs_c[j], team=team),
                  lambda j, team: binding.launch_binned_round_closest(
                      tb32, *w32c[j], *outs32[j], team=team), len(waves_c), len(w32c)),
              "binned_round_anyhit_f64": (
                  lambda j, team: binding.launch_binned_round_anyhit(
                      tb, *waves_a[j], occs_a[j], team=team),
                  lambda j, team: binding.launch_binned_round_anyhit(
                      tb32, *w32a[j], occs32[j], team=team), len(waves_a), len(w32a))}
    twin = {"binned_round_closest_f64": timed_once(
                lambda: binned.round_closest_reference(tb, *rc))[1],
            "binned_round_anyhit_f64": timed_once(
                lambda: binned.round_anyhit_reference(tb, *ra))[1]}
    for k, (launch, launch32, n64, n32) in rounds.items():
        team = binding._binned_team(tb, None, k.removesuffix("_f64"))
        which = "closest" if "closest" in k else "anyhit"
        by_team = {t: cuda_ms(lambda: launch(0, t)) for t in binding.TEAMS}
        call_by_team = {t: queued_ms(lambda: [launch(j, t) for j in range(n64)])
                        for t in binding.TEAMS}
        ms[k] = (by_team[team], twin[k])
        extra[k] = {"team": team, "ms_by_team": by_team, "call_ms_by_team": call_by_team,
                    "queued_ms": queued_ms(lambda: launch(0, team)),
                    "ms_f32": cuda_ms(lambda: launch32(0, None)),
                    "call_ms_f32": queued_ms(lambda: [launch32(j, None) for j in range(n32)]),
                    "rounds": stats[which]["rounds"], "ray_rounds": stats[which]["ray_rounds"],
                    "rounds_f32": stats[which + "_f32"]["rounds"],
                    "ray_rounds_f32": stats[which + "_f32"]["ray_rounds"],
                    "wave_sizes": [w[4].shape[0] for w in (waves_c if which == "closest"
                                                           else waves_a)]}

    # The resident pair at every team (the closest hit cached where its
    # entries fit in float64, and recomputed), the float32 instance beside.
    out, out32 = outs(S, f64), outs(S, torch.float32)
    occ = torch.empty(S, dtype=torch.bool, device=dev)
    n_boxes = tr.leaf.shape[0]
    r_by_team = {"resident_closest_f64": {}, "recomputed": {}, "resident_anyhit_f64": {}}
    for t in binding.TEAMS:
        if binding.resident_cached(n_boxes, t, tr.leaf.element_size()):
            r_by_team["resident_closest_f64"][t] = cuda_ms(lambda: binding.launch_resident_closest(
                tr, o, d, lo, hi_t, *out, team=t, cached=True))
        r_by_team["recomputed"][t] = cuda_ms(lambda: binding.launch_resident_closest(
            tr, o, d, lo, hi_t, *out, team=t, cached=False))
        r_by_team["resident_anyhit_f64"][t] = cuda_ms(lambda: binding.launch_resident_anyhit(
            tr, so, sd, lo, st, occ, team=t))
    r_launch = {"resident_closest_f64": (
                    lambda: binding.launch_resident_closest(tr, o, d, lo, hi_t, *out),
                    lambda: binding.launch_resident_closest(tr32, *l32[:4], *out32), t_twin),
                "resident_anyhit_f64": (
                    lambda: binding.launch_resident_anyhit(tr, so, sd, lo, st, occ),
                    lambda: binding.launch_resident_anyhit(tr32, l32[4], l32[5], l32[2], l32[6],
                                                           occ), a_twin)}
    for (k, (launch, launch32, tw)), model in zip(r_launch.items(), (r_model, r_a_model)):
        ms[k] = (cuda_ms(launch), tw)
        extra[k] = {"team": binding.RESIDENT_TEAM[k.removesuffix("_f64")],
                    "ms_by_team": r_by_team[k],
                    "queued_ms": queued_ms(launch), "ms_f32": cuda_ms(launch32),
                    "per_ray": {"clusters": model[-2].double().mean().item(),
                                "tests": model[-1].double().mean().item()}}
    extra["resident_closest_f64"]["ms_by_team_recomputed"] = r_by_team["recomputed"]
    extra["resident_closest_f64"]["cached"] = binding.resident_cached(
        n_boxes, binding.RESIDENT_TEAM["resident_closest"], tr.leaf.element_size())

    need_c = closest_tests(tr.leaf, intersect.LEAF, o, d, lo, hi_t, ref_t[0])
    need_a = anyhit_tests(tr.leaf, intersect.LEAF, so, sd, lo, st, ref_occ)
    extra["resident_closest_f64"]["per_ray"]["bound_tests"] = need_c / S
    extra["resident_anyhit_f64"]["per_ray"]["bound_tests"] = need_a / S
    cluster_bytes = CLUSTER_ROWS * tb.tri.shape[1] * tb.tri.element_size()
    bounds = {
        "binned_round_closest_f64": bound(
            nbytes(*rc, *outs_c[0]) + cluster_bytes * torch.unique(rc[4]).numel(),
            rc[4].shape[0] * CLUSTER_ROWS * TRI_OPS, PEAK_FP64),
        "binned_round_anyhit_f64": bound(
            nbytes(*ra, occs_a[0]) + cluster_bytes * torch.unique(ra[4]).numel(),
            TRI_OPS * (int((~ref_ra).sum()) * CLUSTER_ROWS + int(ref_ra.sum())), PEAK_FP64),
        "resident_closest_f64": bound(nbytes(o, d, lo, hi_t, tr.tri, tr.leaf, *out),
                                      TRI_OPS * need_c, PEAK_FP64),
        "resident_anyhit_f64": bound(nbytes(so, sd, lo, st, tr.tri, tr.leaf, occ),
                                     TRI_OPS * need_a, PEAK_FP64),
    }
    log(f"[f64-traversals] config 4 float64, {S} lanes ({int((ref_t[1] >= 0).sum())} hits, "
        f"{int(ref_occ.sum())} blocked): binned {tb.leaf.shape[0]} clusters, resident "
        f"{n_boxes} boxes. Bitwise equal to their float64 twins at teams {list(binding.TEAMS)}: "
        f"binned_round_closest_f64 on all {len(waves_c)} waves of a closest driver call, "
        f"binned_round_anyhit_f64 on all {len(waves_a)} of an any-hit call, edge waves and the "
        f"tie; both float64 drivers equal their round twins' and brute force on every lane; "
        f"resident_closest_f64 (entries cached where they fit, and recomputed) and "
        f"resident_anyhit_f64 equal brute force at every team on every lane, edge lanes, the "
        f"padded tables and the tie case. Driver rounds / ray-rounds f64 vs f32: "
        f"{json.dumps(stats)}; twins {t_twin:.1f}, {a_twin:.1f} ms")
    log("[f64-traversals] ms and bounds: " + json.dumps(
        {k: {"ms": ms[k][0], "plain_ms": ms[k][1], **bounds[k], **extra[k]} for k in ms}))
    return worst, ms, bounds, extra


def run_f64_traversal_frames(dev, mesh, mesh_cam, smi: str):
    """Phase 3h, frames: config 4 at 1920x1080, 1 spp, in float64 through
    the composed pool under ``method="binned"`` and ``"resident"``, once
    each, timed: launching only the float64 kernels of their routes, rays
    within ``F64_RAYS_RTOL`` of the float32 frames of phase 5d
    (``METHOD_EXPECT``), the two frames' rays, iterations and images equal
    (every route gives the brute-force hit). Every launch counter is zeroed
    before a frame and read after it. Returns the launches by method."""
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.pool import ray_count, render_pool

    frames, launches, images = {}, {}, {}
    for m in F64_METHODS:
        want = {f"{k}_f64" for k in METHOD_KERNELS[m]} | {"sphere_closest_f64", "any_hit_f64"}
        shade.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, counters, iters = render_pool(mesh, mesh_cam, dtype=torch.float64, method=m,
                                           **dict(CONFIG4, spp=1))
        checksum = float(img.sum().item())     # forces completion
        wall = time.perf_counter() - t0
        got = dict(shade.LAUNCHES)
        if set(got) != want or not np.isfinite(checksum) or img.dtype != torch.float64:
            raise AssertionError(f"config 4 float64 under {m}: {img.dtype}, launches {got}, "
                                 f"checksum {checksum}")
        rays = ray_count(counters)
        rel = (rays - METHOD_EXPECT[0]) / METHOD_EXPECT[0]
        if abs(rel) > F64_RAYS_RTOL:
            raise AssertionError(f"config 4 float64 under {m}: {rays} rays against "
                                 f"{METHOD_EXPECT[0]} in float32")
        frames[m] = {"total_rays": rays, "iters": iters, "image_checksum": checksum,
                     "wall_s": wall, "mrays_per_s": rays / wall / 1e6,
                     "rays_rel_diff_vs_f32": rel, "iters_f32": METHOD_EXPECT[1],
                     "launches_per_iter": {k: v / iters for k, v in sorted(got.items())}}
        launches[m], images[m] = got, img
    a, b = F64_METHODS
    if ((frames[a]["total_rays"], frames[a]["iters"]) != (frames[b]["total_rays"],
                                                          frames[b]["iters"])
            or not torch.equal(images[a], images[b])):
        raise AssertionError(f"config 4 float64: {a} and {b} frames differ: {frames}")
    log("[f64-traversal-frames] " + json.dumps({
        "workload": f"config 4 (mesh_scene, {mesh.num_tris} tris) {CONFIG4['width']}x"
                    f"{CONFIG4['height']} 1spp MIS depth {CONFIG4['max_bounces']}, "
                    f"{CONFIG4['num_slots']} slots, float64, composed pool; {a} and {b} images "
                    f"bitwise equal",
        **frames, "card": smi}))
    return launches


def golden_rmse(img, spp: int) -> dict:
    """``img`` (H*W, 3) mean radiance against the golden image: the
    full-resolution RMSE, each channel's mean bias, and the noise floor
    ``GOLDEN_SIGMA * sqrt(1/spp + 1/8192)``."""
    golden = np.load(GOLDEN)["image"].reshape(-1, 3)
    diff = np.asarray(img, np.float64) - golden
    return {"rmse": float(np.sqrt((diff ** 2).mean())),
            "mean_bias_rgb": diff.mean(axis=0).tolist(),
            "floor": GOLDEN_SIGMA * float(np.sqrt(1.0 / spp + 1.0 / GOLDEN_SPP))}


def run_f64_frames(dev, smi: str):
    """Phase 8: float64 through the main paths on the card. The Cornell
    128x128 pool frame (phase 4's) and the 64x64 wave Cornell frame against
    the same renders on the CPU twins (equal rays and iterations, images
    within the imgutil budget); many_spheres at 1920x1080, 4 spp, 32
    bounces, 16,384 slots, timed, then the same frame in float32; the
    Cornell box at 400x400, 256 spp, 64 bounces, 160,000 slots against the
    golden (full-resolution RMSE within 1.15x the noise floor, each
    channel's mean bias within 1e-3); and ``render --dtype f64`` and ``bench
    --small --dtype f64`` through the CLI. Every launch counter is zeroed
    before a frame and read after it: the pool frames must launch only the
    float64 ``fused_bounce`` (its raygen instance) and ``shadow_any_hit``, the wave frame only the
    float64 ``combined_closest_small`` and ``any_hit``; the Cornell pool
    frame one float64 draw an iteration and the wave frame its keys' and
    float64 draws (``rng.LAUNCHES``). Returns the launches of the timed
    1080p frame with the Cornell pool frame's draws, and of the wave frame
    with its draws."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.pool import busy_count, ray_count, render_pool
    from pathtrace_tpu_torch.render import RenderConfig, render
    from pathtrace_tpu_torch.utils import rng

    f64 = torch.float64
    pool_set = {"fused_bounce_raygen_f64", "shadow_any_hit_f64"}

    W, H = CORNELL["width"], CORNELL["height"]
    shade.LAUNCHES.clear()
    rng.LAUNCHES.clear()
    img, counters, iters = render_pool(scenes.cornell_box(dev), scenes.cornell_camera(W, H, dev),
                                       dtype=f64, **CORNELL)
    launches = dict(shade.LAUNCHES)
    pool_draws = dict(rng.LAUNCHES)
    img = img.cpu().numpy()
    t0 = time.perf_counter()
    img_cpu, counters_cpu, iters_cpu = render_pool(
        scenes.cornell_box("cpu"), scenes.cornell_camera(W, H, "cpu"), dtype=f64, **CORNELL)
    cpu_s = time.perf_counter() - t0
    rays, rays_cpu = ray_count(counters), ray_count(counters_cpu)
    if img.dtype != np.float64 or not np.isfinite(img).all():
        raise AssertionError(f"f64 cornell image {img.dtype} not finite")
    if (rays, iters) != (rays_cpu, iters_cpu):
        raise AssertionError(f"f64 cornell: GPU {rays} rays {iters} iters, CPU {rays_cpu} "
                             f"rays {iters_cpu} iters")
    if set(launches) != pool_set or launches["fused_bounce_raygen_f64"] != iters or \
            pool_draws != {"rng_pool_uniforms_f64": iters}:
        raise AssertionError(f"f64 cornell launched {launches}, draws {pool_draws} for {iters} "
                             f"iterations")
    assert_images_match(img, img_cpu.numpy())
    log(f"[f64-cornell] {W}x{H} 1spp MIS depth {CORNELL['max_bounces']} float64 pool: rays "
        f"{rays}, iters {iters} on the card and the CPU twins (CPU {cpu_s:.1f} s); max pixel "
        f"diff {np.abs(img - img_cpu.numpy()).max():.4g}; launches {launches}")

    W, H = F64_WAVE["width"], F64_WAVE["height"]
    cfg = RenderConfig(dtype=f64, **F64_WAVE)
    shade.LAUNCHES.clear()
    rng.LAUNCHES.clear()
    gpu = render(scenes.cornell_box(dev), scenes.cornell_camera(W, H, dev), cfg)
    wave_img = gpu.image.cpu().numpy()
    wave_launches = dict(shade.LAUNCHES)
    wave_draws = dict(rng.LAUNCHES)
    t0 = time.perf_counter()
    cpu = render(scenes.cornell_box("cpu"), scenes.cornell_camera(W, H, "cpu"), cfg)
    cpu_s = time.perf_counter() - t0
    if gpu.image_sum.dtype != f64 or gpu.ray_queries != cpu.ray_queries:
        raise AssertionError(f"f64 wave: {gpu.image_sum.dtype}, rays GPU {gpu.ray_queries} vs "
                             f"CPU {cpu.ray_queries}")
    if set(wave_launches) != {"combined_closest_small_f64", "any_hit_f64"}:
        raise AssertionError(f"f64 wave launched {wave_launches}")
    check_wave_draws("f64 wave", cfg, wave_launches["combined_closest_small_f64"], wave_draws,
                     "_f64")
    assert_images_match(wave_img, cpu.image.numpy())
    log(f"[f64-wave] cornell {W}x{H} {F64_WAVE['spp']}spp MIS float64 wave engine: rays "
        f"{gpu.ray_queries} on both (CPU {cpu_s:.1f} s); max pixel diff "
        f"{np.abs(wave_img - cpu.image.numpy()).max():.4g}; launches {wave_launches}")

    W, H = F64_FRAME["width"], F64_FRAME["height"]
    scene, camera = scenes.many_spheres(device=dev), scenes.many_spheres_camera(W, H, dev)
    frames, frame_launches = {}, {}
    for dtype in (f64, torch.float32):
        tag = "f64" if dtype == f64 else "f32"
        shade.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, counters, iters = render_pool(scene, camera, dtype=dtype, **F64_FRAME)
        checksum = float(img.double().sum().item())       # forces completion
        wall = time.perf_counter() - t0
        launches = dict(shade.LAUNCHES)
        want = pool_set if dtype == f64 else set(POOL_KERNELS)
        if set(launches) != want or not np.isfinite(checksum) or img.dtype != dtype:
            raise AssertionError(f"1080p {tag}: {img.dtype}, launches {launches}, checksum "
                                 f"{checksum}")
        rays = ray_count(counters)
        frames[tag] = {"total_rays": rays, "iters": iters, "image_checksum": checksum,
                       "wall_s": wall, "mrays_per_s": rays / wall / 1e6,
                       "occupancy": busy_count(counters) / (iters * F64_FRAME["num_slots"])}
        frame_launches[tag] = launches
    result = {"workload": f"many_spheres {W}x{H} {F64_FRAME['spp']}spp MIS depth "
                          f"{F64_FRAME['max_bounces']}, pool {F64_FRAME['num_slots']} slots",
              "f64": frames["f64"], "f32": frames["f32"],
              "wall_ratio_f64_over_f32": frames["f64"]["wall_s"] / frames["f32"]["wall_s"],
              "checksum_rel_diff_f64_vs_f32": (frames["f64"]["image_checksum"]
                                               - frames["f32"]["image_checksum"])
              / frames["f32"]["image_checksum"],
              "launches_f64": frame_launches["f64"], "card": smi}
    log("[f64-frame] " + json.dumps(result))

    W, H, spp = F64_GOLDEN["width"], F64_GOLDEN["height"], F64_GOLDEN["spp"]
    shade.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, counters, iters = render_pool(scenes.cornell_box(dev), scenes.cornell_camera(W, H, dev),
                                       dtype=f64, **F64_GOLDEN)
    mean = (img / spp).cpu().numpy()
    wall = time.perf_counter() - t0
    launches = dict(shade.LAUNCHES)
    gold = golden_rmse(mean, spp)
    bound_rmse = F64_RMSE_OVER_FLOOR * gold["floor"]
    gold.update(workload=f"cornell {W}x{H} {spp}spp MIS depth {F64_GOLDEN['max_bounces']} "
                         f"float64 pool, {F64_GOLDEN['num_slots']} slots",
                rmse_bound=bound_rmse, rays=ray_count(counters), iters=iters, wall_s=wall,
                launches=launches, card=smi)
    log("[f64-golden] " + json.dumps(gold))
    if set(launches) != pool_set or not np.isfinite(mean).all():
        raise AssertionError(f"f64 golden frame launched {launches}")
    if gold["rmse"] > bound_rmse or max(abs(b) for b in gold["mean_bias_rgb"]) > F64_MEAN_BIAS:
        raise AssertionError(f"f64 golden frame: RMSE {gold['rmse']} (bound {bound_rmse}), "
                             f"bias {gold['mean_bias_rgb']} (bound {F64_MEAN_BIAS})")

    with tempfile.TemporaryDirectory() as tmp:
        npy = os.path.join(tmp, "img.npy")
        render_args = ["render", "--scene", "cornell", "--engine", "pool", "--width", "64",
                       "--height", "64", "--spp", "2", "--dtype", "f64", "--device", "cuda",
                       "--out", os.path.join(tmp, "o.png"), "--npy", npy]
        # Both commands in one process (one start-up): render prints nothing
        # to stdout, so its only line is the bench's.
        entry = ("import sys; from pathtrace_tpu_torch import cli; "
                 f"sys.exit(cli.main({render_args!r}) or cli.main("
                 "['bench', '--small', '--dtype', 'f64']))")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", entry], capture_output=True, text=True,
                           timeout=300)
        lines = r.stdout.splitlines()
        if (r.returncode != 0 or np.load(npy).dtype != np.float64 or len(lines) != 1
                or json.loads(lines[0])["extra"].get("dtype") != "f64"):
            raise AssertionError(f"CLI render / bench --small --dtype f64 exited "
                                 f"{r.returncode}: {r.stdout[-2000:]} {r.stderr[-2000:]}")
    log(f"[f64-cli] render --dtype f64 --device cuda wrote a float64 image; bench --small "
        f"--dtype f64: {lines[0]} ({time.perf_counter() - t0:.1f} s)")
    return {**frame_launches["f64"], **pool_draws}, {**wave_launches, **wave_draws}


# The modes of fused_bounce (phase 3i): each opt-in instance, by launch
# counter name, in both float types.
FUSED_MODES = ("raygen", "shadow", "raygen_shadow")
MODE_KERNELS = {f"fused_bounce_{m}{sfx}": ("pathtrace_tpu_torch/csrc/fused_bounce.cu",
                                           "pathtrace_tpu/ops/pallas_shade.py:537")
                for sfx in ("", "_f64") for m in FUSED_MODES}
RAYGEN_SHARE = 0.4          # lanes of phase 3i's raygen checks that start a sample
# (name, dtype, render_pool arguments, profiled): split and raygen frames in
# turns; a profiled frame is run once more each way under torch.profiler for
# its device ops (the profiler takes ~0.3 ms an event, so not the 1080p one).
RAYGEN_FRAMES = (
    ("cornell", torch.float32, CORNELL, True),
    ("many_spheres", torch.float32, dict(width=1920, height=1080, spp=1, integrator="mis",
                                         max_bounces=32, num_slots=16384, seed=0), False),
    ("on_pbr", torch.float32, ON_PBR_POOL, False),
    ("cornell", torch.float64, CORNELL, False),
)
# Phase 3i's ragged lane counts, by lane set: S not a multiple of any
# split's block of lanes, so the last block holds threads past S beside
# threads that shade, at every split.
RAGGED_S = {"many_spheres": SLICE_S - 1, "edge": EDGE_S - 3}


def split_glue(camera):
    """``shade.fused_bounce`` as the pool's glue called it before the fused
    branch made its rays in the kernel: the started lanes' primary rays by
    ``camera.generate_rays`` and the five merges, then the default instance
    on the merged state. Patched in for ``shade.fused_bounce`` (by
    :func:`split_pool`), it makes ``render_pool`` the split path that the
    raygen mode replaces."""
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.utils import rng

    kernel = shade.fused_bounce

    def fused_bounce(tables, busy, bounce, ray_o, ray_d, eta, pdf_prev, prefix, u, *,
                     raygen, **kw):
        started, px, py, _ = raygen
        jitter = torch.stack([u[rng.SLOT_JITTER_X], u[rng.SLOT_JITTER_Y]], dim=1)
        cam_o, cam_d = camera.generate_rays(px.long(), py.long(), jitter)
        return kernel(tables, busy, bounce, torch.where(started, cam_o, ray_o),
                      torch.where(started, cam_d, ray_d), torch.where(started, 1.0, eta),
                      torch.where(started, 1.0, pdf_prev), torch.where(started, 1.0, prefix),
                      u, **kw)
    return fused_bounce


@contextlib.contextmanager
def split_pool(camera, on=True):
    """Within the block, ``render_pool``'s fused branch runs the split path
    (:func:`split_glue` of ``camera``, which must be the camera the pool
    renders, in its dtype); ``on=False`` leaves the pool as it is."""
    from pathtrace_tpu_torch.ops import shade

    kernel = shade.fused_bounce
    if on:
        shade.fused_bounce = split_glue(camera)
    try:
        yield
    finally:
        shade.fused_bounce = kernel


def raygen_lanes(camera, batch, seed=1):
    """Phase 3i's raygen inputs from a merged lane batch: ~``RAYGEN_SHARE``
    of the lanes start a sample on a pixel spread over the image, at bounce 0
    with that pixel's uniforms (its jitter in slots 7-8), while their carried
    ray state stays the batch's. Returns ``(pre, raygen, merged)``: the
    kernel's inputs before the refill, its ``raygen`` tuple, and the same
    lanes merged by ``Camera.generate_rays`` and the pool's five merges (the
    split path's inputs)."""
    from pathtrace_tpu_torch.pool import camera_row
    from pathtrace_tpu_torch.utils import rng

    dev = batch[0].device
    S = batch[0].shape[0]
    busy, bounce, o, d, eta, pdf, pfx, u = batch
    lane, _, _, u0, _, _ = camera_lanes(camera, S, seed, dev)
    W, H = camera.width, camera.height
    pixel = (lane * 7919) % (W * H)
    g = torch.Generator().manual_seed(seed)
    started = (torch.rand(S, generator=g) < RAYGEN_SHARE).to(dev)
    busy = busy | started
    bounce = torch.where(started, 0, bounce)
    u = torch.where(started, u0, u).contiguous()
    px, py = pixel % W, (H - 1) - pixel // W
    raygen = (started, px.to(torch.int32), py.to(torch.int32), camera_row(camera))
    jitter = torch.stack([u[rng.SLOT_JITTER_X], u[rng.SLOT_JITTER_Y]], dim=1)
    cam_o, cam_d = camera.generate_rays(px, py, jitter)
    merged = [busy, bounce, torch.where(started, cam_o, o).contiguous(),
              torch.where(started, cam_d, d).contiguous(), torch.where(started, 1.0, eta),
              torch.where(started, 1.0, pdf), torch.where(started, 1.0, pfx).contiguous(), u]
    return [busy, bounce, o, d, eta, pdf, pfx, u], raygen, merged


def hold_mode_kernels(name, tables, pre, raygen, merged, kw):
    """Every mode of ``fused_bounce`` (the default and the three opt-in
    instances) against its twin, bit for bit (NaNs equal), through the
    wrapper and at every split; the raygen twin against the split path's
    twin (the same mode on the merged lanes), and the fused-shadow kernels
    against the split pair's kernels (``fused_bounce`` + ``shadow_any_hit`` +
    the pool's mask: equal values, a zero's sign aside, where nothing is
    added). Returns ``({mode: twin result}, {mode: worst abs error})``."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.ops import shade

    flags = shade.kernel_flags(kw["integrator"], kw["has_tri_lights"], kw["has_sph_lights"],
                               kw["has_oren_nayar"], kw["has_pbr"])
    launch = dict(num_tris=kw["num_tris"], num_lights=kw["num_lights"],
                  max_bounces=kw["max_bounces"], eps=shade.EPS, **flags)
    refs, errs, kernel = {}, {}, {}
    for mode in ("default",) + FUSED_MODES:
        rg = raygen if "raygen" in mode else None
        fs = "shadow" in mode
        batch = pre if rg else merged
        ref = shade.fused_bounce_reference(tables, *batch, raygen=rg, fuse_shadow=fs, **kw)
        got = shade.fused_bounce(tables, *batch, raygen=rg, fuse_shadow=fs, **kw)
        err = _bitwise(f"fused_bounce {mode} {name}", tuple(ref), tuple(got), nan_equal=True)
        out = shade.BounceResult(*(torch.empty_like(x) for x in ref))
        for split in binding.SPLITS:
            binding.launch_fused_bounce(tables, *batch, out, raygen=rg, fuse_shadow=fs,
                                        split=split, **launch)
            err = max(err, _bitwise(f"fused_bounce {mode} {name} split {split}", tuple(ref),
                                    tuple(out), nan_equal=True))
        refs[mode], errs[mode], kernel[mode] = ref, err, got
    for mode, split_mode in (("raygen", "default"), ("raygen_shadow", "shadow")):
        _bitwise(f"{mode} twin against the split path's, {name}", tuple(refs[split_mode]),
                 tuple(refs[mode]), nan_equal=True)
    split_res = kernel["default"]
    occ = shade.shadow_any_hit(tables, split_res.next_o, split_res.shadow_d,
                               split_res.shadow_tmax)
    want = split_res._replace(
        rad_delta=split_res.rad_delta + torch.where(split_res.live & ~occ, split_res.nee_gain,
                                                    0.0),
        nee_gain=torch.zeros_like(split_res.nee_gain))
    got = kernel["shadow"]
    for field, a, b in zip(shade.BounceResult._fields, want, got):
        same = (a == b) | (a.isnan() & b.isnan()) if a.is_floating_point() else a == b
        if not same.all():
            raise AssertionError(f"fused shadow {name}: {field} differs from the split pair's "
                                 f"on {int((~same).reshape(-1, same.shape[-1]).any(0).sum())} "
                                 f"lanes")
    if int((split_res.live & occ).sum()) == 0 and kw["integrator"] != "brdf_only":
        raise AssertionError(f"fused shadow {name}: no live lane blocked")
    log(f"[modes] {name}: fused_bounce default, raygen ({int(raygen[0].sum())} lanes started), "
        f"shadow and raygen_shadow bitwise equal to their twins through the wrapper and at "
        f"splits {list(binding.SPLITS)}; the raygen twins equal the split path's; the fused "
        f"shadow's rad_delta equals the split pair's ({int((split_res.live & occ).sum())} live "
        f"lanes blocked), nee_gain zero; worst abs error {errs}")
    return refs, errs


def mode_times(tables, pre, raygen, merged, kw, camera, turn_splits=(None,)):
    """CUDA-event times of phase 3i on one lane set: each mode's instance
    at every split beside the default's; then, in turns (old, new, new,
    old), the fused shadow against the split pair it replaces
    (``fused_bounce`` + ``shadow_any_hit`` + the pool's mask and add) and the
    raygen mode against the split path's glue (``generate_rays`` and the
    five merges) + ``fused_bounce``, by events (host launches included) and
    queued behind a spin kernel (device only), at each split of
    ``turn_splits`` (None: the host's; every kernel of a pair at that split).
    Returns ``(by_split, turns)``; ``turns`` is keyed by ``what_timer`` at
    the host's split, by ``what_timer_split`` at the others."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.utils import rng

    flags = shade.kernel_flags(kw["integrator"], kw["has_tri_lights"], kw["has_sph_lights"],
                               kw["has_oren_nayar"], kw["has_pbr"])
    launch = dict(num_tris=kw["num_tris"], num_lights=kw["num_lights"],
                  max_bounces=kw["max_bounces"], eps=shade.EPS, **flags)
    out = shade.fused_bounce_reference(tables, *merged, **kw)
    out = shade.BounceResult(*(torch.empty_like(x) for x in out))
    occ = torch.empty_like(out.live)
    by_split = {}
    for mode in ("default",) + FUSED_MODES:
        rg = raygen if "raygen" in mode else None
        batch = pre if rg else merged
        by_split[mode] = {split: cuda_ms(lambda: binding.launch_fused_bounce(
            tables, *batch, out, raygen=rg, fuse_shadow="shadow" in mode, split=split,
            **launch)) for split in binding.SPLITS}
    busy, bounce, o, d, eta, pdf, pfx, u = pre
    started, px, py, _ = raygen

    def split_pair(split):
        binding.launch_fused_bounce(tables, *merged, out, split=split, **launch)
        binding.launch_shadow_any_hit(tables, out.next_o, out.shadow_d, out.shadow_tmax, occ,
                                      eps=shade.EPS, split=split)
        return out.rad_delta + torch.where(out.live & ~occ, out.nee_gain, 0.0)

    def split_raygen(split):
        jitter = torch.stack([u[rng.SLOT_JITTER_X], u[rng.SLOT_JITTER_Y]], dim=1)
        cam_o, cam_d = camera.generate_rays(px, py, jitter)
        batch = [busy, bounce, torch.where(started, cam_o, o), torch.where(started, cam_d, d),
                 torch.where(started, 1.0, eta), torch.where(started, 1.0, pdf),
                 torch.where(started, 1.0, pfx), u]
        binding.launch_fused_bounce(tables, *batch, out, split=split, **launch)

    turns = {}
    for split in turn_splits:
        for what, old, new in (
            ("shadow", split_pair, lambda split: binding.launch_fused_bounce(
                tables, *merged, out, fuse_shadow=True, split=split, **launch)),
            ("raygen", split_raygen, lambda split: binding.launch_fused_bounce(
                tables, *pre, out, raygen=raygen, split=split, **launch)),
        ):
            for timer in (cuda_ms, queued_ms):
                ms = [timer(lambda: fn(split)) for fn in (old, new, new, old)]
                key = f"{what}_{timer.__name__}" + ("" if split is None else f"_{split}")
                turns[key] = {"old": [ms[0], ms[3]], "new": [ms[1], ms[2]]}
    return by_split, turns


def run_raygen_frames(dev, smi: str):
    """Phase 3i, frames: the pool (whose fused branch runs the raygen mode)
    against the split path it replaced (:func:`split_pool`), in turns
    (split, raygen, raygen, split), on Cornell 128x128 1 spp, many_spheres
    1920x1080 1 spp (32 bounces, 16,384 slots) and the ON/PBR scene at
    ``ON_PBR_POOL`` in float32 and Cornell in float64 (``RAYGEN_FRAMES``):
    equal rays and iterations and a bitwise-equal image; walls, and the
    device ops an iteration of a profiled run of each way where the frame is
    marked for it. Returns each frame's launches, by ``(name, dtype,
    split)``: the split frames' are the only launches of the default
    instances, which no pool runs."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.pool import ray_count, render_pool
    from pathtrace_tpu_torch.render import cast_floats

    launches = {}
    for name, dtype, run, profiled in RAYGEN_FRAMES:
        W, H = run["width"], run["height"]
        scene, camera = {
            "cornell": lambda: (scenes.cornell_box(dev), scenes.cornell_camera(W, H, dev)),
            "many_spheres": lambda: (scenes.many_spheres(device=dev),
                                     scenes.many_spheres_camera(W, H, dev)),
            "on_pbr": lambda: (on_pbr_scene(dev), scenes.default_spheres_camera(W, H, dev)),
        }[name]()
        scene, camera = cast_floats(scene, dtype), cast_floats(camera, dtype)
        sfx = "_f64" if dtype == torch.float64 else ""
        walls, outs = {True: [], False: []}, {}
        for split in (True, False, False, True):
            shade.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with split_pool(camera, split):
                img, counters, iters = render_pool(scene, camera, **run)
            checksum = float(img.double().sum().item())     # forces completion
            walls[split].append(time.perf_counter() - t0)
            got = (img, ray_count(counters), iters, checksum, dict(shade.LAUNCHES))
            if split not in outs:
                outs[split] = got
            elif not torch.equal(img, outs[split][0]) or got[1:3] != outs[split][1:3]:
                raise AssertionError(f"{name} {dtype}: a second frame differs (split {split})")
        (img, rays, iters, checksum, split_l), (rimg, rrays, riters, _, raygen_l) = \
            outs[True], outs[False]
        if (rrays, riters) != (rays, iters) or not torch.equal(rimg, img):
            raise AssertionError(f"{name} {dtype}: raygen frame {rrays} rays, {riters} "
                                 f"iterations; split {rays}, {iters} (or the images differ)")
        if not torch.isfinite(img).all():
            raise AssertionError(f"{name} {dtype}: image not finite")
        on_pbr = bool(scene.has_oren_nayar or scene.has_pbr)
        for raygen, got in ((False, split_l), (True, raygen_l)):
            want = shade.launch_name(raygen, False, on_pbr, dtype)
            if got.get(want, 0) != iters or got.get(f"shadow_any_hit{sfx}", 0) <= 0 \
                    or len(got) != 2:
                raise AssertionError(f"{name} {dtype}: launches {got} for {iters} iterations")
        work = {True: None, False: None}
        for split in (True, False) if profiled else ():
            with split_pool(camera, split):
                dev_ms, dev_ops, kernel_ms = device_work(
                    lambda: render_pool(scene, camera, **run))
            work[split] = {"device_ms": dev_ms, "device_ops_per_iter": dev_ops / iters,
                           "kernel_device_ms_per_iter": {k: v / iters
                                                         for k, v in sorted(kernel_ms.items())}}
        launches[(name, dtype, True)], launches[(name, dtype, False)] = split_l, raygen_l
        log("[modes-frames] " + json.dumps({
            "workload": f"{name} {W}x{H} {run['spp']}spp MIS depth {run['max_bounces']} "
                        f"{run['num_slots']} slots {str(dtype).removeprefix('torch.')}",
            "total_rays": rays, "iters": iters, "checksum": checksum,
            "wall_s_split": walls[True], "wall_s_raygen": walls[False],
            "split": work[True], "raygen": work[False], "card": smi}))
    log("[modes-frames] every raygen frame gave its split frame's rays, iterations and image "
        "bit for bit")
    return launches


def check_mode_kernels(dev, smi: str):
    """Phase 3i: the modes of ``fused_bounce``. Every mode's instance (the
    default, raygen, fused shadow, both) in float32 and float64 against its
    twin, bitwise, through the wrapper and at every split, on S = 16,384
    real lane states of Cornell, many_spheres and the ON/PBR scene and on
    the edge lanes, ~40% of them started for raygen (:func:`raygen_lanes`),
    and on ragged cuts of the many_spheres and edge lanes (``RAGGED_S``);
    the raygen twin against the split path's; the fused shadow against the
    split pair's kernels; times on many_spheres' lanes (:func:`mode_times`)
    and the ON/PBR raygen instance's on its lanes; then the raygen frames
    (:func:`run_raygen_frames`). Returns the record's entries of the six
    instances of ``MODE_KERNELS`` and of ``fused_bounce_raygen_on_pbr`` (the
    launches of the pool's raygen instances are set from the main path's
    frames by the caller), and the split frames' launches of the default
    instances."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.render import cast_floats

    def cut(xs, n):
        return [x[..., :n].contiguous() for x in xs]

    t0 = time.perf_counter()
    worst, record = {k: 0.0 for k in MODE_KERNELS}, {}
    for dtype in (torch.float32, torch.float64):
        sfx = "_f64" if dtype == torch.float64 else ""
        peak = PEAK_FP64 if sfx else PEAK_FP32
        for name in ("cornell", "many_spheres", "on_pbr", "edge"):
            if name == "edge":
                scene, tables, merged, _ = edge_lanes(dev, dtype=dtype)
                camera = scenes.cornell_camera(64, 64, dev)
            else:
                scene, camera = {
                    "cornell": (scenes.cornell_box(dev), scenes.cornell_camera(128, 128, dev)),
                    "many_spheres": (scenes.many_spheres(device=dev),
                                     scenes.many_spheres_camera(1920, 1080, dev)),
                    "on_pbr": (on_pbr_scene(dev), scenes.default_spheres_camera(1920, 1080, dev)),
                }[name]
                scene = cast_floats(scene, dtype)
                tables = shade.build_tables(scene)
            camera = cast_floats(camera, dtype)
            if name != "edge":
                merged = lane_states(scene, camera, tables, SLICE_S)
            pre, raygen, merged = raygen_lanes(camera, merged)
            kw = bounce_kwargs(scene, "mis", 16)
            refs, errs = hold_mode_kernels(f"{name} {dtype}", tables, pre, raygen, merged, kw)
            if name in RAGGED_S:
                n = RAGGED_S[name]
                _, rerrs = hold_mode_kernels(
                    f"{name} {dtype} ragged S={n}", tables, cut(pre, n),
                    (*cut(raygen[:3], n), raygen[3]), cut(merged, n), kw)
                errs = {m: max(errs[m], rerrs[m]) for m in errs}
            for m in FUSED_MODES:
                worst[f"fused_bounce_{m}{sfx}"] = max(worst[f"fused_bounce_{m}{sfx}"], errs[m])
            if name == "on_pbr" and not sfx:
                # The ON/PBR pool's instance: its time at every split.
                split, _ = binding._shape(tables, None, "fused_bounce")
                flags = shade.kernel_flags(kw["integrator"], kw["has_tri_lights"],
                                           kw["has_sph_lights"], kw["has_oren_nayar"],
                                           kw["has_pbr"])
                out = shade.BounceResult(*(torch.empty_like(x) for x in refs["raygen"]))
                by_split = {t: cuda_ms(lambda: binding.launch_fused_bounce(
                    tables, *pre, out, raygen=raygen, split=t, num_tris=kw["num_tris"],
                    num_lights=kw["num_lights"], max_bounces=kw["max_bounces"], eps=shade.EPS,
                    **flags)) for t in binding.SPLITS}
                twin = cuda_ms(lambda: shade.fused_bounce_reference(
                    tables, *pre, raygen=raygen, **kw), runs=3, calls=1)
                rows = scene.tri_v0.shape[0] * TRI_OPS + scene.sph_center.shape[0] * SPH_OPS
                record["fused_bounce_raygen_on_pbr"] = {
                    "ms": by_split[split], "plain_ms": twin,
                    **bound(nbytes(*pre, *raygen, *tables, *refs["raygen"]),
                            int(pre[0].sum()) * rows, peak),
                    "split": split, "ms_by_split": by_split, "max_abs_err": errs["raygen"]}
                log(f"[modes-times] on_pbr raygen instance S={SLICE_S}: ms by split "
                    f"{json.dumps(by_split)}, twin {twin:.4f} ms; card {smi}")
            if name != "many_spheres":
                continue
            by_split, turns = mode_times(tables, pre, raygen, merged, kw, camera)
            n_tri, n_sph = scene.tri_v0.shape[0], scene.sph_center.shape[0]
            row_ops = n_tri * TRI_OPS + n_sph * SPH_OPS
            closest = int(pre[0].sum()) * row_ops
            split_ref = refs["default"]
            occ = shade.shadow_any_hit_reference(tables, split_ref.next_o, split_ref.shadow_d,
                                                 split_ref.shadow_tmax)
            query = split_ref.shadow_tmax >= shade.EPS
            sweep = int((query & ~occ).sum()) * row_ops + int((query & occ).sum()) * SPH_OPS
            shade.LAUNCHES.clear()
            for m in FUSED_MODES:
                rg = raygen if "raygen" in m else None
                batch = pre if rg else merged
                split, _ = binding._shape(tables, None, "fused_bounce_shadow" if "shadow" in m
                                          else "fused_bounce")
                twin = cuda_ms(lambda: shade.fused_bounce_reference(
                    tables, *batch, raygen=rg, fuse_shadow="shadow" in m, **kw), runs=3, calls=1)
                shade.fused_bounce(tables, *batch, raygen=rg, fuse_shadow="shadow" in m, **kw)
                n_bytes = nbytes(*batch, *tables, *refs[m]) + (nbytes(*raygen) if rg else 0)
                k = f"fused_bounce_{m}{sfx}"
                record[k] = {
                    "ms": by_split[m][split], "plain_ms": twin,
                    **bound(n_bytes, closest + (sweep if "shadow" in m else 0), peak),
                    "split": split, "ms_by_split": by_split[m],
                    "default_ms_by_split": by_split["default"],
                    **({"turns_ms": turns[f"{m}_cuda_ms"], "turns_queued_ms":
                        turns[f"{m}_queued_ms"]} if f"{m}_cuda_ms" in turns else {}),
                }
            wrapper_launches = dict(shade.LAUNCHES)
            for m in FUSED_MODES:
                record[f"fused_bounce_{m}{sfx}"]["launches_phase_3i"] = \
                    wrapper_launches[f"fused_bounce_{m}{sfx}"]
            log(f"[modes-times] many_spheres {dtype} S={SLICE_S}: ms by split "
                f"{json.dumps(by_split)}; in turns (old, new, new, old) "
                f"{json.dumps(turns)}; host splits "
                f"{ {m: record[f'fused_bounce_{m}{sfx}']['split'] for m in FUSED_MODES} }; "
                f"card {smi}")
    log(f"[modes] kernels checked and timed in {time.perf_counter() - t0:.1f} s")
    frame_launches = run_raygen_frames(dev, smi)
    for k, entry in record.items():
        # No pool runs the fused shadow (the JAX pool has no switch for it):
        # its launches are the wrapper's call of this phase.
        if "shadow" in k:
            entry["launches"] = entry["launches_phase_3i"]
        if k in worst:
            entry["max_abs_err"] = worst[k]
    split_launches = {
        "fused_bounce": frame_launches[("many_spheres", torch.float32, True)]["fused_bounce"],
        "fused_bounce_on_pbr": frame_launches[("on_pbr", torch.float32, True)][
            "fused_bounce_on_pbr"],
        "fused_bounce_f64": frame_launches[("cornell", torch.float64, True)][
            "fused_bounce_f64"],
    }
    return record, split_launches


# ---- phase 9: multi-process rendering (parallel/) on the one card ----
CONFIG5 = dict(width=640, height=360, spp=16, integrator="mis", max_bounces=8, seed=0)
CONFIG5_TRIS = 70000        # mesh_scene(70000), the scene of phase 3b
CONFIG5_CAMERAS = 120       # sweep_cameras(120, 640, 360)
CONFIG5_FRAMES = (0, 1)     # one rank's block of two frames: one pool, its slots move between them
CONFIG5_SLOTS = 32768
MP_KERNELS = ("bvh_closest", "bvh_anyhit", "sphere_closest", "any_hit")   # 9a must launch them
SHARDED_FRAMES = dict(width=32, height=32, spp=2, integrator="mis", max_bounces=16, seed=0)
RANK_TIMEOUT_S = 240.0      # a rank still running after this fails the phase (its peers killed)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_ranks(argv_of, n: int, timeout: float = RANK_TIMEOUT_S) -> list:
    """Run ``n`` processes, ``argv_of(rank, coordinator)`` each, joined at a
    free localhost port, and return their outputs (stdout and stderr). When
    one exits non-zero or the time runs out, every sibling is killed and the
    call raises."""
    coordinator = f"127.0.0.1:{free_port()}"
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(n)]
        procs = [subprocess.Popen(argv_of(r, coordinator), cwd=root, stdout=logs[r],
                                  stderr=subprocess.STDOUT, text=True) for r in range(n)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        out = []
        for f in logs:
            f.seek(0)
            out.append(f.read())
            f.close()
    for r, (p, log_text) in enumerate(zip(procs, out)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {n} exited {p.returncode}:\n{log_text[-3000:]}")
    return out


def rank_argv(spec: dict):
    """``argv_of`` for :func:`launch_ranks`: one :func:`rank_main` a rank."""
    def argv_of(rank, coordinator):
        return [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.rank_main())",
                json.dumps({**spec, "coordinator": coordinator, "rank": rank})]
    return argv_of


def shifted_cornell_cameras(width, height, dev, n=3):
    """``n`` Cornell cameras, the origin moved 0.02 along x a frame."""
    from pathtrace_tpu_torch.models import scenes

    cam = scenes.cornell_camera(width, height, dev)
    return [dataclasses.replace(cam, origin=cam.origin + torch.tensor(
        [0.02 * i, 0.0, 0.0], device=dev)) for i in range(n)]


def rank_job_config5(spec, dev) -> dict:
    """Phase 9a's rank: the config-5 frames through ``frames_pool_sharded``."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.parallel.sharding import frames_pool_sharded, make_mesh
    from pathtrace_tpu_torch.pool import ray_count
    from pathtrace_tpu_torch.render import RenderConfig

    cfg = RenderConfig(**spec["frame"])
    scene = scenes.mesh_scene(spec["n_tris"], device=dev)
    sweep = scenes.sweep_cameras(spec["n_cams"], cfg.width, cfg.height, device=dev)
    cams = [sweep[i] for i in spec["frames"]]
    mesh = make_mesh()
    frames_pool_sharded(scene, cams[:1], dataclasses.replace(cfg, spp=1), mesh,
                        num_slots=spec["num_slots"])                        # warm-up
    shade.LAUNCHES.clear()
    t0 = time.perf_counter()
    frames, counters, iters = frames_pool_sharded(scene, cams, cfg, mesh,
                                                  num_slots=spec["num_slots"])
    wall = time.perf_counter() - t0        # the gather copies every frame to the host
    return dict(frames=frames.cpu().numpy(), iters=iters.numpy(), wall=wall,
                rays=np.asarray([ray_count(c) for c in counters]),
                launches=json.dumps(dict(shade.LAUNCHES)))


def rank_job_cornell(spec, dev) -> dict:
    """Phase 9b's rank: ``render_pool_sharded`` on the Cornell frame at
    ``dp=2, sp=1`` and ``dp=1, sp=2``, and ``frames_sharded`` and
    ``frames_pool_sharded`` on three shifted Cornell
    frames at ``dp=2``."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.parallel.sharding import (frames_pool_sharded, frames_sharded,
                                                       make_mesh, render_pool_sharded)
    from pathtrace_tpu_torch.render import RenderConfig

    frame = spec["frame"]
    scene = scenes.cornell_box(dev)
    cam = scenes.cornell_camera(frame["width"], frame["height"], dev)
    out = {}
    for dp, sp in ((2, 1), (1, 2)):
        img, counters, iters = render_pool_sharded(scene, cam, mesh=make_mesh(dp, sp),
                                                   **dict(frame, spp=frame["spp"] * sp))
        out.update({f"image_{dp}x{sp}": img.cpu().numpy(),
                    f"counters_{dp}x{sp}": counters.numpy(), f"iters_{dp}x{sp}": iters.numpy()})
    cfg = RenderConfig(**spec["wave"])
    cams, mesh = shifted_cornell_cameras(cfg.width, cfg.height, dev), make_mesh(2, 1)
    out["frames"] = frames_sharded(scene, cams, cfg, mesh).cpu().numpy()
    frames, counters, iters = frames_pool_sharded(scene, cams, cfg, mesh)
    out.update(pool_frames=frames.cpu().numpy(), pool_counters=counters.numpy(),
               pool_iters=iters.numpy())
    return out


RANK_JOBS = {"config5": rank_job_config5, "cornell": rank_job_cornell}


def rank_main() -> int:
    """One rank of a phase-9 run (``launch_ranks``): ``sys.argv[1]`` is the
    JSON spec (job, device, coordinator, ranks, rank, output file). Rank 0
    saves the job's arrays to the output ``.npz``."""
    spec = json.loads(sys.argv[1])
    from pathtrace_tpu_torch.parallel import distributed

    distributed.initialize(spec["coordinator"], spec["n"], spec["rank"], device=spec["device"],
                           timeout_s=RANK_TIMEOUT_S)
    try:
        dev = (torch.device("cpu") if spec["device"] == "cpu"
               else torch.device("cuda", torch.cuda.current_device()))
        out = RANK_JOBS[spec["job"]](spec, dev)
        if distributed.process_index() == 0:
            np.savez(spec["out"], **out)
    finally:
        distributed.shutdown()
    print(f"rank {spec['rank']} of {spec['n']}: {spec['job']} done", flush=True)
    return 0


def run_config5_ranks(out: str, device: str):
    """Phase 9a's launch: one rank; its arrays in ``out``."""
    spec = dict(job="config5", device=device, n=1, out=out, frame=CONFIG5, n_tris=CONFIG5_TRIS,
                n_cams=CONFIG5_CAMERAS, frames=list(CONFIG5_FRAMES), num_slots=CONFIG5_SLOTS)
    return launch_ranks(rank_argv(spec), 1)


def run_cornell_ranks(out: str, device: str):
    """Phase 9b's launch: two ranks; rank 0's arrays in ``out``."""
    spec = dict(job="cornell", device=device, n=2, out=out, frame=CORNELL, wave=SHARDED_FRAMES)
    return launch_ranks(rank_argv(spec), 2)


def run_cli_ranks(out_dir: str, device: str, extra=()):
    """Phase 9c's launch: ``animate`` through the CLI on two ranks."""
    def argv_of(rank, coordinator):
        return [sys.executable, "-m", "pathtrace_tpu_torch", "--coordinator", coordinator,
                "--num-processes", "2", "--process-id", str(rank), "animate", "--frames", "2",
                "--width", "32", "--height", "32", "--spp", "2", "--device", device,
                "--out-dir", out_dir, *extra]
    return launch_ranks(argv_of, 2)


def check_config5(dev, mesh, got, launch_s: float, smi: str) -> None:
    """Phase 9a's checks: the rank launched the mesh path's kernels, and each
    frame's rays and image equal this process's ``render_pool`` of the same
    camera, bit for bit. The rank renders its frames in one pool, whose
    iterations sit on the first frame: one frame's are ``render_pool``'s."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.pool import FLUSH_EVERY, ray_count, render_pool

    launches = json.loads(str(got["launches"]))
    if any(launches.get(k, 0) <= 0 for k in MP_KERNELS):
        raise AssertionError(f"9a launches {launches} miss one of {MP_KERNELS}")
    W, H, spp = CONFIG5["width"], CONFIG5["height"], CONFIG5["spp"]
    sweep = scenes.sweep_cameras(CONFIG5_CAMERAS, W, H, device=dev)
    ref_s, ref_iters = [], []
    for j, f in enumerate(CONFIG5_FRAMES):
        t0 = time.perf_counter()
        img, counters, iters = render_pool(mesh, sweep[f], num_slots=CONFIG5_SLOTS, **CONFIG5)
        ref = (img.reshape(H, W, 3) / spp).cpu().numpy()
        ref_s.append(time.perf_counter() - t0)
        ref_iters.append(iters)
        if ray_count(counters) != int(got["rays"][j]) or not np.array_equal(ref, got["frames"][j]):
            raise AssertionError(
                f"9a frame {f}: rays {got['rays'][j]} vs render_pool's {ray_count(counters)}, "
                f"max image diff {np.abs(ref - got['frames'][j]).max()}")
    block = got["iters"][:, 0].tolist()
    if (block[1:] != [0] * (len(block) - 1) or block[0] <= 0 or block[0] % FLUSH_EVERY
            or (len(block) == 1 and block != ref_iters)):
        raise AssertionError(f"9a iterations {block}, render_pool's by frame {ref_iters}")
    rays, wall = int(got["rays"].sum()), float(got["wall"])
    log("[multiprocess] 9a " + json.dumps({
        "workload": f"config 5: mesh_scene {mesh.num_tris} tris, sweep_cameras("
                    f"{CONFIG5_CAMERAS}, {W}, {H}) frames {list(CONFIG5_FRAMES)}, {spp}spp "
                    f"MIS depth {CONFIG5['max_bounces']}, {CONFIG5_SLOTS} slots, "
                    f"frames_pool_sharded on 1 rank on {dev}",
        "rays": rays, "iters": got["iters"].ravel().tolist(), "wall_s": wall,
        "mrays_per_s": rays / wall / 1e6, "launch_s": launch_s, "launches": launches,
        "in_process_render_pool_s": ref_s, "bitwise_vs_render_pool": True, "card": smi}))


def check_cornell(dev, got, launch_s: float) -> None:
    """Phase 9b's checks: ``dp=2`` bitwise and ``sp=2`` within 1e-5 (rays
    exact) against this process's ``render_pool``; the ``frames_sharded``
    frames within the image budget of ``render.render``."""
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.pool import ray_count, render_pool
    from pathtrace_tpu_torch.render import RenderConfig, render

    W, H = CORNELL["width"], CORNELL["height"]
    diffs = {}
    for dp, sp in ((2, 1), (1, 2)):
        img, counters, iters = render_pool(scenes.cornell_box(dev), scenes.cornell_camera(
            W, H, dev), **dict(CORNELL, spp=CORNELL["spp"] * sp))
        ref, rays, tag = img.cpu().numpy(), ray_count(counters), f"{dp}x{sp}"
        diffs[tag] = float(np.abs(got[f"image_{tag}"] - ref).max())
        if ray_count(got[f"counters_{tag}"]) != rays or not (
                np.array_equal(got[f"image_{tag}"], ref) if sp == 1 else
                np.allclose(got[f"image_{tag}"], ref, rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"9b dp={dp} sp={sp}: rays {ray_count(got[f'counters_{tag}'])}"
                                 f" vs {rays}, max diff {diffs[tag]}")
        diffs[tag + "_iters"] = (got[f"iters_{tag}"].ravel().tolist(), iters)
    cfg = RenderConfig(**SHARDED_FRAMES)
    frame_kw = {k: getattr(cfg, k) for k in ("width", "height", "spp", "integrator",
                                             "max_bounces", "seed")}
    its = []
    for i, cam in enumerate(shifted_cornell_cameras(cfg.width, cfg.height, dev)):
        assert_images_match(got["frames"][i],
                            render(scenes.cornell_box(dev), cam, cfg).image.cpu().numpy())
        img, counters, iters = render_pool(scenes.cornell_box(dev), cam, **frame_kw)
        ref = (img.reshape(cfg.height, cfg.width, 3) / cfg.spp).cpu().numpy()
        its.append(iters)
        if ray_count(got["pool_counters"][i]) != ray_count(counters) or not np.array_equal(
                got["pool_frames"][i], ref):
            raise AssertionError(f"9b frames_pool_sharded frame {i} differs from render_pool")
    # Each rank's iterations on its block's first frame (frames 0-1, frame
    # 2); the fused branch renders one pool a frame.
    if got["pool_iters"][:, 0].tolist() != [its[0] + its[1], 0, its[2]]:
        raise AssertionError(f"9b frames_pool_sharded iterations {got['pool_iters'].tolist()}, "
                             f"render_pool's by frame {its}")
    log(f"[multiprocess] 9b 2 ranks on {dev}, Cornell {W}x{H}, {CORNELL['spp']} spp at dp=2 "
        f"(bitwise), {2 * CORNELL['spp']} at sp=2: max diffs and (rank, one-process) "
        f"iterations {diffs}; 3 frames {cfg.width}x{cfg.height} at dp=2: frames_sharded "
        f"within budget, frames_pool_sharded bitwise; ranks {launch_s:.1f} s")


def check_cli_frames(frames_dir: str, launch_s: float) -> None:
    """Phase 9c's check: rank 0 wrote the two frames."""
    pngs = sorted(os.listdir(frames_dir))
    if pngs != ["frame_0000.png", "frame_0001.png"]:
        raise AssertionError(f"9c wrote {pngs}")
    for name in pngs:
        with open(os.path.join(frames_dir, name), "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"9c {name} is not a PNG")
    log(f"[multiprocess] 9c CLI animate on 2 ranks: {pngs} ({launch_s:.1f} s)")


def timed_call(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def run_multiprocess(dev, mesh, smi: str):
    """Phase 9: multi-process rendering (``parallel/``), every rank on
    ``cuda:0``. 9a: one NCCL rank renders config 5 through
    ``frames_pool_sharded``, each frame bitwise equal to this process's
    ``render_pool``; 9b: two gloo ranks share the card: ``render_pool_sharded``
    on phase 4's Cornell frame at ``dp=2`` (bitwise) and at 2 spp at ``sp=2``
    (rays exact, image within 1e-5), and on three 32x32 Cornell frames at
    ``dp=2`` ``frames_sharded`` against ``render.render`` and
    ``frames_pool_sharded`` against ``render_pool`` bitwise; 9c: ``animate``
    through the CLI on two ranks writes two PNGs. 9b's and 9c's ranks run while this
    process renders 9a's references (after 9a's rank has timed its frames)."""
    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        out_a, out_b = os.path.join(tmp, "config5.npz"), os.path.join(tmp, "cornell.npz")
        frames_dir = os.path.join(tmp, "frames")
        logs, launch_s = timed_call(run_config5_ranks, out_a, dev.type)
        log("[multiprocess] 9a rank log: " + logs[0].strip().replace("\n", " | ")[-600:])
        fut_b = pool.submit(timed_call, run_cornell_ranks, out_b, dev.type)
        fut_c = pool.submit(timed_call, run_cli_ranks, frames_dir, dev.type)
        check_config5(dev, mesh, np.load(out_a), launch_s, smi)
        (logs_b, launch_b), (logs_c, launch_c) = fut_b.result(), fut_c.result()
        check_cornell(dev, np.load(out_b), launch_b)
        check_cli_frames(frames_dir, launch_c)
    # The backend each launch chose before its group formed: NCCL for the
    # lone rank, gloo for two ranks sharing the card.
    backends = [re.findall(r"backend \w+ \(.*\)", t) for t in logs + logs_b + logs_c]
    log(f"[multiprocess] backends of 9a, 9b, 9c's ranks: {backends}")
    expect = (["backend nccl (one GPU a rank, 1 on 1 node(s))"]
              + ["backend gloo (2 ranks share 1 GPU(s) on 1 node(s))"] * 4
              if dev.type == "cuda" else ["backend gloo (CPU ranks)"] * 5)
    if backends != [[e] for e in expect]:
        raise AssertionError(f"phase 9 backends {backends}, expected {expect}")
    log(f"[multiprocess] phase 9 {time.perf_counter() - t_phase:.1f} s")


def _bits(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bits as integers of its width, contiguous."""
    return x.contiguous().view(torch.int64 if x.element_size() == 8 else torch.int32)


def check_rng_kernels(dev):
    """Phase 3j: the random-number draw's kernels (``csrc/rng.cu``) against
    their torch twin (``utils/rng.py``'s ``fold_in`` and
    ``per_slot_uniforms``, run on the card), bitwise, in float32 and float64:
    ``pool_uniforms``, ``pixel_sample_keys``, ``bounce_uniforms`` and
    ``light_sample_keys`` at every seed of :data:`RNG_SEEDS` and lane count
    of :data:`RNG_S`; one ``rng_pool_uniforms`` launch a pool iteration in a
    traced pool pass of each dtype, and the wave's draw launches
    (:func:`check_wave_draws`) in a traced wave pass of each; each draw timed against the torch
    draw it replaces, in turns (kernel, torch, torch, kernel; CUDA events,
    and queued behind a spin kernel) at the benchmark cells' lanes
    (:data:`RNG_CELLS`). Returns the draw's entries of the kernels' record,
    without their launches (the main path's frames count those)."""
    from pathtrace_tpu_torch import profiler
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.pool import render_pool
    from pathtrace_tpu_torch.render import RenderConfig, render
    from pathtrace_tpu_torch.utils import rng

    f32, f64 = torch.float32, torch.float64
    suffix = {f32: "", f64: "_f64"}

    def lanes(S, seed):
        g = torch.Generator(device=dev).manual_seed(seed + S)
        return (torch.randint(0, 2**21, (S,), generator=g, device=dev),
                torch.randint(0, 10**4, (S,), generator=g, device=dev),
                torch.randint(0, 64, (S,), generator=g, device=dev, dtype=torch.int32))

    errs = dict.fromkeys(RNG_KERNELS, 0.0)   # largest |kernel - twin| of each entry point

    def same(name, what, got, want):
        got, want = tuple(got), tuple(want)
        if any(a.shape != b.shape or a.dtype != b.dtype or not torch.equal(_bits(a), _bits(b))
               for a, b in zip(got, want)) or len(got) != len(want):
            raise AssertionError(f"rng {name} {what}: kernel and twin differ")
        for a, b in zip(got, want):
            errs[name] = max(errs[name], (a.double() - b.double()).abs().max().item())

    checked = 0
    for seed in RNG_SEEDS:
        key = rng.base_key(seed, dev)
        for S in RNG_S:
            pixel, sample, bounce = lanes(S, seed)
            twin_keys = rng.fold_in(rng.fold_in(key, pixel), sample)
            keys = rng.pixel_sample_keys(key, pixel, sample)
            same("rng_fold", f"pixel_sample_keys seed {seed} S {S}", keys, twin_keys)
            b, j = S % 64, 1 + S % 3
            same("rng_fold", f"light_sample_keys seed {seed} S {S}",
                 rng.light_sample_keys(keys, j),
                 rng.fold_in(twin_keys, torch.full_like(pixel, rng.NEE_FOLD_BASE + j)))
            for dt in (f32, f64):
                what = f"seed {seed} S {S} {dt}"
                same("rng_pool_uniforms" + suffix[dt], what,
                     (rng.pool_uniforms(key, pixel, sample, bounce, dt),),
                     (rng.per_slot_uniforms(twin_keys, bounce.long(), dt),))
                same("rng_bounce_uniforms" + suffix[dt], what, (rng.bounce_uniforms(keys, b, dt),),
                     (rng.per_slot_uniforms(twin_keys, torch.full_like(pixel, b), dt).T,))
                checked += 1
            del pixel, sample, bounce, twin_keys, keys
    torch.cuda.synchronize()
    log(f"[rng] pool_uniforms, pixel_sample_keys, bounce_uniforms, light_sample_keys: bitwise "
        f"against the twin on the card at seeds {RNG_SEEDS}, S {RNG_S}, float32 and float64 "
        f"({checked} draws of each)")

    # Launches, as a pass record counts them: a traced pool pass of each dtype
    # and a traced wave pass.
    W, H = RNG_POOL["width"], RNG_POOL["height"]
    for dt in (f32, f64):
        with profiler.tracing():
            img, _, iters = render_pool(scenes.cornell_box(dev), scenes.cornell_camera(W, H, dev),
                                        dtype=dt, **RNG_POOL)
        rec = profiler.passes()[-1]
        draws = {k: v for k, v in rec.launches.items() if k in RNG_KERNELS}
        name = "rng_pool_uniforms" + suffix[dt]
        if draws != {name: iters} or rec.counts["pool.iter"] != iters or \
                rec.launches["fused_bounce_raygen" + suffix[dt]] != iters:
            raise AssertionError(f"rng pool pass {dt}: launches {dict(rec.launches)} for "
                                 f"{iters} iterations")
        log(f"[rng] pool pass {W}x{H} {RNG_POOL['spp']}spp {dt}: {iters} iterations, "
            f"launches {dict(rec.launches)}")
    W, H = RNG_WAVE["width"], RNG_WAVE["height"]
    for dt in (f32, f64):
        cfg = RenderConfig(dtype=dt, **RNG_WAVE)
        with profiler.tracing():
            render(scenes.cornell_box(dev), scenes.cornell_camera(W, H, dev), cfg)
        rec = profiler.passes()[-1]
        closest = rec.launches["combined_closest_small" + suffix[dt]]
        if rec.counts["wave.bounce"] != closest - cfg.spp:     # check_wave_draws' bounces
            raise AssertionError(f"rng wave pass {dt}: {rec.counts['wave.bounce']} bounces, "
                                 f"{closest} closest-hit launches for {cfg.spp} waves")
        check_wave_draws(f"rng wave pass {dt}", cfg, closest,
                         {k: v for k, v in rec.launches.items() if k in RNG_KERNELS}, suffix[dt])
        log(f"[rng] wave pass {W}x{H} {cfg.spp}spp {dt}, {cfg.num_light_samples} light samples: "
            f"{rec.counts['wave.bounce']} bounces, launches {dict(rec.launches)}")

    # Times, in turns, at the cells' lanes; bounds at INT32 issue or HBM.
    def turns(fast, slow):
        ev = [cuda_ms(fast), cuda_ms(slow, runs=10, calls=5), cuda_ms(slow, runs=10, calls=5),
              cuda_ms(fast)]
        qu = [queued_ms(fast), queued_ms(slow, runs=5), queued_ms(slow, runs=5), queued_ms(fast)]
        return ev, qu

    key = rng.base_key(RNG_SEEDS[1], dev)
    out = {}
    for cell, S in RNG_CELLS.items():
        pixel, sample, bounce = lanes(S, 0)
        keys = rng.pixel_sample_keys(key, pixel, sample)
        wave = cell.endswith(".wave")
        for dt in (f32, f64):
            item = torch.empty((), dtype=dt).element_size()
            if wave:
                cases = {
                    "rng_bounce_uniforms" + suffix[dt]: (
                        lambda: rng.bounce_uniforms(keys, 5, dt),
                        lambda: rng.per_slot_uniforms(keys, torch.full_like(keys[0], 5), dt).T,
                        16 * S + 9 * item * S, 10 * THREEFRY_OPS * S)}
                if dt == f32:
                    cases["rng_fold"] = (
                        lambda: rng.pixel_sample_keys(key, pixel, sample),
                        lambda: rng.fold_in(rng.fold_in(key, pixel), sample),
                        32 * S, 2 * THREEFRY_OPS * S)
            else:
                cases = {"rng_pool_uniforms" + suffix[dt]: (
                    lambda: rng.pool_uniforms(key, pixel, sample, bounce, dt),
                    lambda: rng.per_slot_uniforms(rng.fold_in(rng.fold_in(key, pixel), sample),
                                                  bounce.to(torch.int64), dt),
                    20 * S + 9 * item * S, 12 * THREEFRY_OPS * S)}
            for name, (fast, slow, n_bytes, n_ops) in cases.items():
                ev, qu = turns(fast, slow)
                bnd = bound(n_bytes, n_ops, PEAK_INT32)
                e = out.setdefault(name, {"ms_by_cell": {}, "plain_ms_by_cell": {},
                                          "queued_ms_by_cell": {}, "plain_queued_ms_by_cell": {},
                                          "bound_ms_by_cell": {}, "turns": {}})
                e["ms_by_cell"][cell] = min(ev[0], ev[3])
                e["plain_ms_by_cell"][cell] = min(ev[1], ev[2])
                e["queued_ms_by_cell"][cell] = min(qu[0], qu[3])
                e["plain_queued_ms_by_cell"][cell] = min(qu[1], qu[2])
                e["bound_ms_by_cell"][cell] = bnd["bound_ms"]
                e["turns"][cell] = {"events_ms": ev, "queued_ms": qu}
                if cell.startswith("rtiow_1080p."):   # the entry's own lanes: RTIOW's
                    e.update(bnd, lanes=S, cell=cell)
                log(f"[rng] {name} {cell} S={S}: kernel {ev[0]:.4f}, {ev[3]:.4f} ms, torch "
                    f"{ev[1]:.3f}, {ev[2]:.3f} ms (events); queued kernel {qu[0]:.4f}, "
                    f"{qu[3]:.4f}, torch {qu[1]:.3f}, {qu[2]:.3f}; bound {bnd['bound_ms']:.4f} "
                    f"ms ({bnd['bound_by']})")
        del pixel, sample, bounce, keys
    for name, e in out.items():
        cell = e["cell"]
        e.update(max_abs_err=errs[name], ms=e["ms_by_cell"][cell],
                 plain_ms=e["plain_ms_by_cell"][cell], queued_ms=e["queued_ms_by_cell"][cell])
    log("[rng] " + json.dumps(out))
    return out


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

    from pathtrace_tpu_torch.models import scenes

    start = time.perf_counter()

    def phase(name, fn, *args):
        """Run one phase and log the seconds since the build."""
        out = fn(*args)
        log(f"[time] phase {name} done at {time.perf_counter() - start:.1f} s")
        return out

    worst, ms, bnd = phase("3", check_kernels, dev)
    t0 = time.perf_counter()
    mesh = scenes.mesh_scene(device=dev)
    mesh_cam = scenes.mesh_scene_camera(CONFIG4["width"], CONFIG4["height"], dev)
    log(f"[mesh] mesh_scene: {mesh.num_tris} triangles built in "
        f"{time.perf_counter() - t0:.2f} s")
    mesh_worst, mesh_ms, mesh_bnd, lanes, mesh_extra, counter_launches = phase(
        "3b", check_mesh_kernels, dev, mesh, mesh_cam)
    trav_worst, trav_ms, trav_bnd, trav_extra = phase(
        "3d", check_traversal_kernels, dev, mesh, lanes)
    wave_worst, wave_ms, wave_bnd, wave_extra, flat = phase("3c", check_wave_kernels, dev)
    cl_worst, cl_ms, cl_bnd, cl_slice, cl_extra, field = phase(
        "3e", check_clustered_kernels, dev, flat)
    f64_worst, f64_ms, f64_bnd, f64_extra = phase("3f", check_f64_kernels, dev)

    def f64_routes():
        out = check_f64_route_kernels(dev, mesh, lanes, flat, field)
        return out, run_f64_route_frames(dev, mesh, mesh_cam, smi)

    (r64_worst, r64_ms, r64_bnd, r64_extra, r64_counters), r64_launches = phase("3g", f64_routes)

    def f64_traversals():
        out = check_f64_traversal_kernels(dev, mesh, lanes)
        return out, run_f64_traversal_frames(dev, mesh, mesh_cam, smi)

    (t64_worst, t64_ms, t64_bnd, t64_extra), t64_launches = phase("3h", f64_traversals)
    modes, split_launches = phase("3i", check_mode_kernels, dev, smi)
    draws = phase("3j", check_rng_kernels, dev)
    del lanes, flat, field
    phase("4", run_cornell, dev)
    phase("4b", run_mesh_frame, dev)
    launches = phase("5", run_bench, dev, smi)
    mesh_launches = phase("5b", run_config4, mesh, mesh_cam, smi)
    method_launches = phase("5d", run_config4_methods, mesh, mesh_cam, smi)
    wave_launches = phase("5c", run_wave_cornell, dev, smi)
    flat_launches = phase("4c", run_wave_gpu_vs_cpu, dev)
    phase("4d", run_wave_methods, dev)
    phase("4e", run_cluster_frames, dev)
    cluster_launches, field_launches = phase("5e", run_cluster_bench, dev, smi)
    f64_pool_launches, f64_wave_launches = phase("8", run_f64_frames, dev, smi)
    phase("6", run_cli)
    phase("7", run_parity, dev, smi)
    phase("9", run_multiprocess, dev, mesh, smi)

    def entry(name, src, rep, n_launches, err, times, bnd, **extra):
        return {"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": n_launches, "max_abs_err": err, "ms": times[0],
                "plain_ms": times[1], "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
                "library_ms": None,   # no single PyTorch call computes a closest or any hit
                **extra}

    def split_entry(name, src, rep, n_launches, err, m, which, bnd):
        """A pool kernel at the host's split, with its time at every split."""
        split = m["split"][which]
        return entry(name, src, rep, n_launches, err,
                     (m["by_split"][split][which], m["twin"][which]), bnd, split=split,
                     ms_by_split={t: v[which] for t, v in m["by_split"].items()})

    mesh_worst["any_hit"] = max(mesh_worst["any_hit"], wave_worst["any_hit"])
    cases = {"combined_closest_small": ("cornell", wave_launches),
             "triangle_closest": (f"mesh_{FLAT_TRIS}", flat_launches)}
    method_of = {k: m for m, ks in METHOD_KERNELS.items() for k in ks}
    # The pool's raygen instances: launches of the main path's frames.
    modes["fused_bounce_raygen"]["launches"] = launches["fused_bounce_raygen"]
    modes["fused_bounce_raygen_on_pbr"]["launches"] = cluster_launches["fused_bounce_raygen_on_pbr"]
    modes["fused_bounce_raygen_f64"]["launches"] = f64_pool_launches["fused_bounce_raygen_f64"]
    # The draw's: launches of the main path's frames, rng_fold the float32 wave's.
    main_draws = {**f64_pool_launches, **f64_wave_launches, **launches, **wave_launches}
    record = {"kernels": [
        split_entry(k, src, rep, {**launches, **split_launches}[k], worst[k], ms["many_spheres"],
                    which, bnd[k])
        for which, (k, (src, rep)) in enumerate(KERNELS.items())
    ] + [
        entry(k, src, rep, mesh_launches[k], mesh_worst[k], mesh_ms[k], mesh_bnd[k],
              **mesh_extra.get(k, {}))
        for k, (src, rep) in MESH_KERNELS.items()
    ] + [
        entry(k, src, rep, counter_launches, mesh_worst[k], mesh_ms[k], mesh_bnd[k])
        for k, (src, rep) in COUNTER_KERNELS.items()
    ] + [
        entry(k, src, rep, cases[k][1][k], wave_worst[k], wave_ms[cases[k][0]][k],
              wave_bnd[cases[k][0]][k], **wave_extra[k],
              **({"launches_16384": field_launches[k], **cl_extra[k]} if k in cl_extra else {}))
        for k, (src, rep) in WAVE_KERNELS.items()
    ] + [
        entry(k, src, rep, method_launches[method_of[k]][k], trav_worst[k], trav_ms[k],
              trav_bnd[k], **trav_extra.get(k, {}))
        for k, (src, rep) in TRAVERSAL_KERNELS.items()
    ] + [
        entry(k, src, rep, cluster_launches[k], cl_worst[k], cl_ms[k], cl_bnd[k],
              ms_16384=cl_slice[k]["ms"], bound_ms_16384=cl_slice[k]["bound_ms"], **cl_extra[k])
        for k, (src, rep) in CLUSTER_KERNELS.items() if k in cl_slice
    ] + [
        split_entry("fused_bounce_on_pbr", *CLUSTER_KERNELS["fused_bounce_on_pbr"],
                    split_launches["fused_bounce_on_pbr"], cl_worst["fused_bounce_on_pbr"],
                    cl_ms["fused_bounce_on_pbr"], 0, cl_bnd["fused_bounce_on_pbr"])
    ] + [
        entry(k, src, rep, {**f64_pool_launches, **f64_wave_launches, **split_launches}[k],
              f64_worst[k],
              f64_ms[k], f64_bnd[k], **f64_extra[k])
        for k, (src, rep) in F64_KERNELS.items()
    ] + [
        entry(k, src, rep, r64_counters if k == "bvh_closest_counters_f64" else
              r64_launches[F64_FRAME_OF.get(k, "field")][k],
              r64_worst[k], r64_ms[k], r64_bnd[k], **r64_extra[k],
              **({"launches_16384": r64_launches["field"][k]} if k == "triangle_closest_f64"
                 else {}))
        for k, (src, rep) in F64_ROUTE_KERNELS.items()
    ] + [
        entry(k, src, rep, t64_launches[method_of[k.removesuffix("_f64")]][k], t64_worst[k],
              t64_ms[k], t64_bnd[k], **t64_extra[k])
        for k, (src, rep) in F64_TRAVERSAL_KERNELS.items()
    ] + [
        entry(k, src, rep, modes[k]["launches"], modes[k]["max_abs_err"],
              (modes[k]["ms"], modes[k]["plain_ms"]), modes[k],
              **{x: v for x, v in modes[k].items() if x not in (
                  "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})
        for k, (src, rep) in {**MODE_KERNELS,
                              "fused_bounce_raygen_on_pbr": MODE_KERNELS["fused_bounce_raygen"]
                              }.items()
    ] + [
        entry(k, src, rep, main_draws[k], draws[k]["max_abs_err"],
              (draws[k]["ms"], draws[k]["plain_ms"]), draws[k],
              **{x: v for x, v in draws[k].items() if x not in (
                  "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})
        for k, (src, rep) in RNG_KERNELS.items()
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
