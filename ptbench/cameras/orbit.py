"""A camera orbit: ``frames`` pinhole cameras on a circle about the y axis
at height ``height``, each looking at ``target``. The arithmetic of the
renderer's ``models/scenes.py`` ``sweep_cameras`` (copied): frame ``f``
stands at ``(r sin a, height, r cos a)`` with ``a = 2 pi f / frames``, so
the same parameters give the same cameras (``BASELINE.json`` config 5's
sweep at its defaults)."""

from __future__ import annotations

import numpy as np


def build(frames: int, radius: float = 5.5, height: float = 1.6,
          target=(0.0, 0.2, 0.0), up=(0.0, 1.0, 0.0), fov: float = 40.0) -> list:
    cams = []
    for f in range(frames):
        a = 2.0 * np.pi * f / frames
        cams.append({"origin": [float(radius * np.sin(a)), float(height),
                                float(radius * np.cos(a))],
                     "target": [float(x) for x in target], "up": [float(x) for x in up],
                     "fov": float(fov)})
    return cams
