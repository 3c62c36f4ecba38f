"""ctypes bridge to the repository's native C++ parity oracle
(``csrc/oracle.cpp``).

Counterpart of ``pathtrace_tpu/oracle.py``. The oracle is the independent
implementation of the reference estimator (scalar, recursive, float64,
OpenMP-parallel over pixels) that both packages are held against
statistically. Its source is shared: it is read in place from the
repository's ``csrc/``, never copied, so the two packages cannot drift to two
oracles.

The library is built at first use with the JAX bridge's flags
(``g++ -O3 -march=native -shared -fPIC -fopenmp``) into
``pathtrace_tpu_torch/_build/``, under a name that carries a hash of the
source and the flags. The compiler writes a temporary file that
``os.replace`` then moves into place, so a process that loads the library
while another builds it sees a whole file. Nothing here runs at import time.

The scene's tables are cut to their real rows (``num_tris``,
``num_spheres``, ``num_lights``) and handed over as float64/int32 numpy
copies, from any device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import numpy as np

from .models.camera import Camera
from .models.scene import Scene

PACKAGE = Path(__file__).resolve().parent
SOURCE = PACKAGE.parent / "csrc" / "oracle.cpp"
BUILD_DIR = PACKAGE / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")

INTEGRATOR_CODES = {"brdf_only": 0, "nee": 1, "mis": 2}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liboracle_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the oracle unless it is built; returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "liboracle.so")
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", lib], check=True)
        os.replace(lib, out)   # atomic: a concurrent build sees a whole file
    return out


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# From the triangles to the camera, as both entry points take them.
_SCENE_ARGTYPES = [_PTR] * 4 + [_INT] + [_PTR] * 3 + [_INT] + [_PTR] * 6 + [_INT] + [
    _PTR, _INT, _PTR]
_TAIL_ARGTYPES = [_INT, _INT, ctypes.c_ulonglong, _PTR]   # spp, integrator, seed, out


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.pt_render.argtypes = _SCENE_ARGTYPES + [_INT, _INT] + _TAIL_ARGTYPES
    lib.pt_render_window.argtypes = _SCENE_ARGTYPES + [_INT] * 6 + _TAIL_ARGTYPES
    lib.pt_render.restype = lib.pt_render_window.restype = None
    return lib


def _f64(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np.float64)


def _i32(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np.int32)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _scene_args(scene: Scene, camera: Camera) -> tuple[list, list]:
    """The ``pt_render`` arguments from the triangles to the camera, and the
    numpy arrays behind their pointers (kept alive by the caller)."""
    nt, ns, nl = max(scene.num_tris, 0), max(scene.num_spheres, 0), max(scene.num_lights, 0)
    tris = [_f64(scene.tri_v0)[:nt], _f64(scene.tri_e1)[:nt], _f64(scene.tri_e2)[:nt],
            _i32(scene.tri_mat)[:nt]]
    sphs = [_f64(scene.sph_center)[:ns], _f64(scene.sph_radius)[:ns], _i32(scene.sph_mat)[:ns]]
    mats = [_i32(scene.mat_kind), _f64(scene.mat_color), _f64(scene.mat_emission),
            _f64(scene.mat_roughness), _f64(scene.mat_metallic), _f64(scene.mat_ior)]
    lights = _i32(scene.light_prims)[:nl]
    cam = np.concatenate([_f64(camera.origin), _f64(camera.lower_left_corner),
                          _f64(camera.horizontal), _f64(camera.vertical)])
    arrays = [*tris, *sphs, *mats, lights, cam]

    args = [*map(_ptr, tris), scene.num_tris, *map(_ptr, sphs), scene.num_spheres,
            *map(_ptr, mats), int(mats[0].shape[0]), _ptr(lights), scene.num_lights, _ptr(cam)]
    return args, arrays


def render_oracle(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    spp: int,
    integrator: str = "mis",
    seed: int = 0,
) -> np.ndarray:
    """Render with the native oracle; returns ``(H, W, 3)`` float64 mean
    pre-gamma radiance."""
    args, _keep = _scene_args(scene, camera)
    out = np.zeros((height, width, 3), dtype=np.float64)
    _lib().pt_render(*args, width, height, spp, INTEGRATOR_CODES[integrator], seed, _ptr(out))
    return out


def render_oracle_window(
    scene: Scene,
    camera: Camera,
    full_width: int,
    full_height: int,
    x0: int,
    y0: int,
    win_w: int,
    win_h: int,
    spp: int,
    integrator: str = "mis",
    seed: int = 0,
) -> np.ndarray:
    """Oracle render of the ``win_w x win_h`` rectangle at ``(x0, y0)`` of a
    ``full_width x full_height`` frame, bitwise equal to the same region of
    the full render (per-pixel seeds and the u/v mapping use the frame's
    coordinates). Returns ``(win_h, win_w, 3)``."""
    args, _keep = _scene_args(scene, camera)
    out = np.zeros((win_h, win_w, 3), dtype=np.float64)
    _lib().pt_render_window(*args, full_width, full_height, x0, y0, win_w, win_h, spp,
                            INTEGRATOR_CODES[integrator], seed, _ptr(out))
    return out
