"""The wavefront engine, ``pathtrace_tpu_torch.render.render``: progressive
passes of ``spp_per_pass`` samples (``samples_per_batch`` a wave), each
continuing the window's ``RenderState``, which holds the framebuffer."""

from __future__ import annotations

import importlib

import torch

# The module (the package's ``render`` attribute is the function).
render = importlib.import_module("pathtrace_tpu_torch.render")


class Engine:
    def __init__(self, system, traffic: dict, seed: int):
        self.sys = system
        self.spp = self.side_spp = int(traffic["spp_per_pass"])
        self.batch = int(traffic.get("samples_per_batch", 1))
        self.seed = seed
        self.first = self.spp
        self.state = None

    def _render(self, state):
        s = self.sys
        cfg = render.RenderConfig(
            width=s.width, height=s.height, spp=state.num_samples + self.spp,
            integrator=s.integrator, max_bounces=s.max_bounces, seed=self.seed,
            samples_per_batch=self.batch, method=s.method)
        out = render.render(s.scene, s.camera, cfg, state)
        return out, {"rays": out.ray_queries - state.ray_queries}

    def _empty(self, first: int):
        s = self.sys
        return render.RenderState(
            torch.zeros((s.height, s.width, 3), dtype=s.camera.origin.dtype,
                        device=s.scene.device), first)

    def warm(self):
        return self._render(self._empty(0))[1]

    def window_pass(self):
        self.state, stats = self._render(self._empty(self.first) if self.state is None
                                         else self.state)
        return stats

    def side_pass(self, first: int):
        return self._render(self._empty(first))[1]

    def framebuffer(self):
        return self.state.image_sum.reshape(-1, 3)

    def samples(self):
        return self.first, self.state.num_samples
