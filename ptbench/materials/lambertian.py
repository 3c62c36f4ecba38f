"""Cosine-weighted Lambertian diffuse."""

from __future__ import annotations

import math

import torch

from ptbench import refmath as rm


def eval(m, i, o, n, eta):
    return m["albedo"] / math.pi, torch.clamp_min(rm.dot(o, n), 0.0) / math.pi


def sample(m, i, n, eta, r1, r2, coin):
    o = rm.cosine_hemisphere(n, r1, r2)
    bsdf, pdf = eval(m, i, o, n, eta)
    return o, bsdf, pdf, torch.clamp_min(rm.dot(o, n), 0.0)
