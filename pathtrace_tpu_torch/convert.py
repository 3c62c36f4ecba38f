"""Carry a scene and camera over from the JAX package as numpy arrays.

The JAX package's ``Scene``/``Camera`` fields, each passed through
``np.asarray``, become the port's tensors unchanged, so both packages can
start from identical inputs. Nothing here imports JAX: the caller does the
``np.asarray``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .models.camera import Camera
from .models.scene import Scene


def _fields(cls, arrays: Mapping[str, np.ndarray], static: Mapping, device):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = (set(arrays) | set(static)) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    out = {k: torch.from_numpy(np.array(v, copy=True)).to(device) for k, v in arrays.items()}
    out.update(static)
    return cls(**out)


def split_fields(obj) -> tuple[dict, dict]:
    """``(arrays, static)`` of a dataclass instance such as the JAX package's
    ``Scene``/``Camera``: ints and flags go to ``static``, every other field
    through ``np.asarray`` to ``arrays``."""
    arrays, static = {}, {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, (bool, int)):
            static[f.name] = v
        else:
            arrays[f.name] = np.asarray(v)
    return arrays, static


def scene_from_arrays(arrays: Mapping[str, np.ndarray], static: Mapping,
                      device="cuda") -> Scene:
    """``arrays``: every tensor field of :class:`Scene` by name;
    ``static``: its ints and flags (``num_tris``, ``has_mirror``, ...)."""
    return _fields(Scene, arrays, static, device)


def camera_from_arrays(arrays: Mapping[str, np.ndarray], static: Mapping,
                       device="cuda") -> Camera:
    """``arrays``: ``origin``, ``lower_left_corner``, ``horizontal``,
    ``vertical``; ``static``: ``width`` and ``height``."""
    return _fields(Camera, arrays, static, device)
