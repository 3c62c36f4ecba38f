"""Image-comparison metrics: the RMSE-vs-reference parity harness.

Counterpart of ``pathtrace_tpu/metrics.py`` (numpy only). Accuracy is the
RMSE of pre-gamma radiance against a reference image at fixed spp: another
render, or a reference ``luminance.csv`` read by
:func:`pathtrace_tpu_torch.io.import_luminance_csv`.
"""

from __future__ import annotations

import numpy as np


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error over all pixels/channels of pre-gamma images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.sqrt(((a - b) ** 2).mean()))


def channel_mean_abs_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|mean(a) - mean(b)| per channel — averages away per-pixel MC noise, so
    it detects estimator bias far below the noise floor."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a.mean(axis=(0, 1)) - b.mean(axis=(0, 1)))


def luminance_rmse(a: np.ndarray, b: np.ndarray) -> float:
    """RMSE of Rec.709 luminance (the reference's export channel)."""
    w = np.asarray([0.2126, 0.7152, 0.0722])
    la = (np.asarray(a, np.float64) * w).sum(-1)
    lb = (np.asarray(b, np.float64) * w).sum(-1)
    return float(np.sqrt(((la - lb) ** 2).mean()))


def rmse_vs_reference_csv(image: np.ndarray, csv_path: str) -> dict:
    """Compare a rendered pre-gamma image against a reference luminance.csv.

    Returns ``{"rmse", "luminance_rmse", "channel_mean_abs_diff"}``.
    """
    from .io import import_luminance_csv

    ref = import_luminance_csv(csv_path)
    return {
        "rmse": rmse(image, ref),
        "luminance_rmse": luminance_rmse(image, ref),
        "channel_mean_abs_diff": channel_mean_abs_diff(image, ref).tolist(),
    }
