"""Time the pool's two kernels of one checkout of the repository on the GPU.

    python3 tools/time_pool_kernels.py ROOT

Imports ``chip_smoke`` and ``pathtrace_tpu_torch`` from the checkout at
ROOT, builds its kernels, and on the lane states of ``chip_smoke.py``'s
phase 3 (S = 16,384 lanes of Cornell and many_spheres, and of the ON/PBR
scene) times raw launches of ``fused_bounce`` and ``shadow_any_hit`` with
CUDA events (``chip_smoke.cuda_ms``: median of 20 runs of 10 launches), at
the host's split and, where the checkout's binding takes one, at every
split. Prints one JSON line: the card, ROOT, and the milliseconds per
scene. To compare two versions on one card, run it in turns in one command
(old, new, new, old), each checkout in its own process.
"""

from __future__ import annotations

import json
import os
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from pathtrace_tpu_torch.kernels import binding, build
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade

    if not torch.cuda.is_available():
        print("time_pool_kernels: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    build.build()
    splits = getattr(binding, "SPLITS", None)
    result = {"card": cs.nvidia_smi_line(), "root": root, "ms": {}}
    for name, scene, camera in (
        ("cornell", scenes.cornell_box(dev), scenes.cornell_camera(128, 128, dev)),
        ("many_spheres", scenes.many_spheres(device=dev),
         scenes.many_spheres_camera(1920, 1080, dev)),
        ("on_pbr", cs.on_pbr_scene(dev), scenes.default_spheres_camera(1920, 1080, dev)),
    ):
        tables = shade.build_tables(scene)
        batch = cs.lane_states(scene, camera, tables, cs.SLICE_S)
        kw = cs.bounce_kwargs(scene, "mis", 16)
        ref = shade.fused_bounce_reference(tables, *batch, **kw)
        so, sd, st = ref.next_o, ref.shadow_d, ref.shadow_tmax
        out = shade.BounceResult(*(torch.empty_like(x) for x in ref))
        occ = torch.empty(st.shape, dtype=torch.bool, device=dev)
        launch = dict(num_tris=kw["num_tris"], num_lights=kw["num_lights"],
                      max_bounces=kw["max_bounces"], eps=shade.EPS,
                      **shade.kernel_flags("mis", scene.has_tri_lights, scene.has_sph_lights,
                                           scene.has_oren_nayar, scene.has_pbr))
        times = {}
        for split in (None,) + tuple(splits or ()):
            extra = {} if split is None else {"split": split}
            times["host" if split is None else str(split)] = (
                cs.cuda_ms(lambda: binding.launch_fused_bounce(tables, *batch, out, **launch,
                                                               **extra)),
                cs.cuda_ms(lambda: binding.launch_shadow_any_hit(tables, so, sd, st, occ,
                                                                 eps=shade.EPS, **extra)))
        result["ms"][name] = times
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
