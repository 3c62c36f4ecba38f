"""The persistent path pool, ``pathtrace_tpu_torch.pool.render_pool``:
progressive passes of ``spp_per_pass`` samples at ``num_slots`` slots, each
pass's radiance sum added into the window's framebuffer. The side passes
(traced and replayed) take ``trace_spp`` samples, ``spp_per_pass`` where
the mix does not say."""

from __future__ import annotations

from pathtrace_tpu_torch import pool


class Engine:
    def __init__(self, system, traffic: dict, seed: int):
        self.sys = system
        self.spp = int(traffic["spp_per_pass"])
        self.side_spp = int(traffic.get("trace_spp", self.spp))
        self.slots = int(traffic["num_slots"])
        self.seed = seed
        self.first = self.next = self.spp     # the warm-up renders sample 0
        self.acc = None

    def _render(self, first: int, spp: int | None = None):
        s = self.sys
        image, counters, iters = pool.render_pool(
            s.scene, s.camera, width=s.width, height=s.height, spp=spp or self.spp,
            integrator=s.integrator, max_bounces=s.max_bounces, num_slots=self.slots,
            seed=self.seed, sample_offset=first,
            method=None if s.method == "auto" else s.method)
        stats = {"iters": int(iters), "rays": pool.ray_count(counters),
                 "busy": pool.busy_count(counters),
                 "slots": min(self.slots, s.width * s.height)}
        return image, stats

    def warm(self):
        """One sample a pixel at the cell's slot count: every kernel and
        tensor of a pass at its own shapes (nothing compiles per shape)."""
        return self._render(0, spp=1)[1]

    def window_pass(self):
        image, stats = self._render(self.next)
        self.acc = image if self.acc is None else self.acc + image
        self.next += self.spp
        return stats

    def side_pass(self, first: int):
        return self._render(first, self.side_spp)[1]

    def framebuffer(self):
        return self.acc

    def samples(self):
        return self.first, self.next
