"""An area light's surface: no BSDF; a path ends on it."""

from __future__ import annotations

import torch


def eval(m, i, o, n, eta):
    return torch.zeros_like(n), torch.ones_like(n[:, 0])


def sample(m, i, n, eta, r1, r2, coin):
    return n, torch.zeros_like(n), torch.ones_like(n[:, 0]), torch.zeros_like(n[:, 0])
