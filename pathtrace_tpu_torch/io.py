"""Host-side export: luminance CSV (the parity interface), NPY, and PNG.

Counterpart of ``pathtrace_tpu/io.py`` in numpy alone (importing the JAX
package's module would import JAX through its package ``__init__``); the
files written are byte for byte the JAX package's.
``export_luminance_csv`` writes the reference renderer's luminance export:
header ``x,y,r,g,b,luminance`` then one row per pixel in row-major y-then-x
order with 6 decimal places of pre-gamma radiance.
"""

from __future__ import annotations

import struct as _struct
import zlib

import numpy as np


def _numpy(a) -> np.ndarray:
    """A numpy array of ``a`` (a numpy array or a tensor on any device)."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def export_luminance_csv(image: np.ndarray, path: str) -> None:
    """``image``: (H, W, 3) pre-gamma mean radiance."""
    img = _numpy(image).astype(np.float64)
    h, w, _ = img.shape
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    with open(path, "w") as f:
        f.write("x,y,r,g,b,luminance\n")
        for y in range(h):
            for x in range(w):
                r, g, b = img[y, x]
                f.write(f"{x},{y},{r:.6f},{g:.6f},{b:.6f},{lum[y, x]:.6f}\n")


def import_luminance_csv(path: str) -> np.ndarray:
    """Read a reference-format luminance CSV back into an (H, W, 3) array."""
    data = np.genfromtxt(path, delimiter=",", skip_header=1)
    xs = data[:, 0].astype(int)
    ys = data[:, 1].astype(int)
    h, w = ys.max() + 1, xs.max() + 1
    img = np.zeros((h, w, 3))
    img[ys, xs] = data[:, 2:5]
    return img


def save_npy(image: np.ndarray, path: str) -> None:
    np.save(path, _numpy(image))


def write_png(rgb_u8: np.ndarray, path: str) -> None:
    """Minimal dependency-free PNG writer for (H, W, 3) uint8 images."""
    img = np.asarray(rgb_u8, dtype=np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            _struct.pack(">I", len(payload))
            + tag
            + payload
            + _struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = _struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)
