"""Frames over ranks on the persistent path pool,
``pathtrace_tpu_torch.parallel.sharding.frames_pool_sharded``: a pass renders
every frame of the configuration's ``cameras`` once, ``spp_per_pass``
samples a pixel at ``num_slots`` slots, the frames in contiguous blocks of
``ceil(F / ranks)`` over a ``dp = ranks`` mesh (one rank: every frame),
gathered on every rank.

That entry point takes no sample offset, so every pass renders samples
``[0, spp)`` of each frame: the framebuffer is the last pass's and
``samples()`` is ``(0, spp)``. It returns each frame's mean radiance; the
framebuffer is that mean times ``spp``, which gives back the sums exactly
where ``spp`` is a power of two (a division and a product by it are exact).
The side passes render samples ``[0, trace_spp)``, whatever sample they are
given."""

from __future__ import annotations

import importlib

from pathtrace_tpu_torch import pool
from pathtrace_tpu_torch.parallel import sharding

# The module (the package's ``render`` attribute is the function).
render = importlib.import_module("pathtrace_tpu_torch.render")


class Engine:
    def __init__(self, system, traffic: dict, seed: int):
        self.sys = system
        self.spp = int(traffic["spp_per_pass"])
        self.side_spp = int(traffic.get("trace_spp", self.spp))
        self.slots = int(traffic["num_slots"])
        self.seed = seed
        self.mesh = sharding.make_mesh()     # dp = every rank, sp = 1
        self.frames = None

    def _render(self, spp: int):
        s = self.sys
        cfg = render.RenderConfig(width=s.width, height=s.height, spp=spp,
                                  integrator=s.integrator, max_bounces=s.max_bounces,
                                  seed=self.seed, method=s.method)
        frames, counters, iters = sharding.frames_pool_sharded(
            s.scene, s.cameras, cfg, mesh=self.mesh, num_slots=self.slots)
        stats = {"iters": int(iters.sum()), "rays": pool.ray_count(counters),
                 "busy": pool.busy_count(counters),
                 "slots": min(self.slots, s.width * s.height)}
        return frames, stats

    def warm(self):
        """Every frame at one sample a pixel: each kernel and tensor of a pass
        at its own shapes, and every collective of one."""
        return self._render(1)[1]

    def window_pass(self):
        self.frames, stats = self._render(self.spp)
        return stats

    def side_pass(self, first: int):
        return self._render(self.side_spp)[1]

    def framebuffer(self):
        return (self.frames * self.spp).reshape(-1, 3)

    def samples(self):
        return 0, self.spp
