"""ctypes binding of the CUDA kernels (built by :mod:`.build` at first use).

Each ``launch_*`` takes contiguous CUDA tensors, already checked by the
wrappers in ``ops/shade.py`` and ``ops/intersect.py``, passes their raw pointers and PyTorch's current
stream, and raises if the launch was refused. The kernels allocate nothing
and do not synchronise.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """Load (building first if needed) the kernel library, once per process."""
    global _lib
    if _lib is None:
        path, _ = build.build()
        lib = ctypes.CDLL(str(path))
        lib.pt_fused_bounce.argtypes = [_P] * 8 + [_P, _I, _P, _I, _P, _I] + [_P] * 11 + \
            [_I] * 8 + [_F, _P]
        lib.pt_fused_bounce.restype = _I
        lib.pt_shadow_any_hit.argtypes = [_P, _I, _P, _I, _P, _P, _P, _P, _I, _F, _P]
        lib.pt_shadow_any_hit.restype = _I
        lib.pt_sphere_closest.argtypes = [_P, _I] + [_P] * 8 + [_I, _P]
        lib.pt_sphere_closest.restype = _I
        lib.pt_any_hit.argtypes = [_P, _I, _P, _I] + [_P] * 5 + [_I, _P]
        lib.pt_any_hit.restype = _I
        lib.pt_bvh_closest.argtypes = [_P] * 3 + [_I] + [_P] * 8 + [_I, _P]
        lib.pt_bvh_closest.restype = _I
        lib.pt_bvh_anyhit.argtypes = [_P] * 3 + [_I] + [_P] * 5 + [_I, _P]
        lib.pt_bvh_anyhit.restype = _I
        _lib = lib
    return _lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {code}")


def launch_fused_bounce(tables, busy, bounce, ray_o, ray_d, eta, pdf_prev, prefix, u, out, *,
                        num_tris, num_lights, max_bounces, eps,
                        use_mis, use_nee, has_tri_l, has_sph_l) -> None:
    """``out`` is a ``BounceResult`` of preallocated outputs; the flags are
    ``ops.shade.kernel_flags``."""
    lib = library()
    with torch.cuda.device(busy.device):   # launch on the inputs' card
        code = lib.pt_fused_bounce(
            busy.data_ptr(), bounce.data_ptr(), ray_o.data_ptr(), ray_d.data_ptr(),
            eta.data_ptr(), pdf_prev.data_ptr(), prefix.data_ptr(), u.data_ptr(),
            tables.sph.data_ptr(), tables.sph.shape[0],
            tables.tri.data_ptr(), tables.tri.shape[0],
            tables.lgt.data_ptr(), tables.lgt.shape[0],
            out.rad_delta.data_ptr(), out.next_o.data_ptr(), out.next_d.data_ptr(),
            out.next_eta.data_ptr(), out.next_pdf.data_ptr(), out.next_prefix.data_ptr(),
            out.live.data_ptr(), out.shade.data_ptr(), out.nee_gain.data_ptr(),
            out.shadow_d.data_ptr(), out.shadow_tmax.data_ptr(),
            busy.shape[0], num_tris, num_lights, max_bounces,
            int(use_mis), int(use_nee), int(has_tri_l), int(has_sph_l), eps,
            _stream(busy.device),
        )
    _raise_on(code, "fused_bounce")


def launch_shadow_any_hit(tables, o, d, t_max, occ, *, eps) -> None:
    lib = library()
    with torch.cuda.device(t_max.device):
        code = lib.pt_shadow_any_hit(
            tables.sph.data_ptr(), tables.sph.shape[0],
            tables.tri.data_ptr(), tables.tri.shape[0],
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), occ.data_ptr(),
            t_max.shape[0], eps, _stream(t_max.device),
        )
    _raise_on(code, "shadow_any_hit")


def launch_sphere_closest(sph, o, d, t_min, t_max, t, idx, n, m) -> None:
    lib = library()
    with torch.cuda.device(t_min.device):
        code = lib.pt_sphere_closest(
            sph.data_ptr(), sph.shape[0], o.data_ptr(), d.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), t.data_ptr(), idx.data_ptr(),
            n.data_ptr(), m.data_ptr(), t_min.shape[0], _stream(t_min.device),
        )
    _raise_on(code, "sphere_closest")


def launch_any_hit(sph, tri, o, d, t_min, t_max, occ) -> None:
    lib = library()
    with torch.cuda.device(t_min.device):
        code = lib.pt_any_hit(
            sph.data_ptr(), sph.shape[0], tri.data_ptr(), tri.shape[0],
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            occ.data_ptr(), t_min.shape[0], _stream(t_min.device),
        )
    _raise_on(code, "any_hit")


def launch_bvh_closest(tables, o, d, t_min, t_max, t, idx, n, m) -> None:
    """``tables`` is an ``ops.intersect.Tables``."""
    lib = library()
    with torch.cuda.device(t_min.device):
        code = lib.pt_bvh_closest(
            tables.tri.data_ptr(), tables.leaf.data_ptr(), tables.group.data_ptr(),
            tables.n_groups, o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
            t_max.data_ptr(), t.data_ptr(), idx.data_ptr(), n.data_ptr(), m.data_ptr(),
            t_min.shape[0], _stream(t_min.device),
        )
    _raise_on(code, "bvh_closest")


def launch_bvh_anyhit(tables, o, d, t_min, t_max, occ) -> None:
    lib = library()
    with torch.cuda.device(t_min.device):
        code = lib.pt_bvh_anyhit(
            tables.tri.data_ptr(), tables.leaf.data_ptr(), tables.group.data_ptr(),
            tables.n_groups, o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
            t_max.data_ptr(), occ.data_ptr(), t_min.shape[0], _stream(t_min.device),
        )
    _raise_on(code, "bvh_anyhit")
