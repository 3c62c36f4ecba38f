"""Share of its roofline that ``any_hit`` in its one-tile mode (the small
route's shadow rays) reaches over the traced passes. Work: every sphere and
triangle row for an unoccluded query, one test for an occluded one; bytes:
the rays, ranges, result and tables. Its clustered mode is not counted."""

from ptbench import roofline
from ptbench import yardstick as ys

LAUNCHER = ("pathtrace_tpu_torch.ops.intersect", "any_hit")
PATTERN = r"(?<!\w)any_hit_kernel\b"


def work(args, kwargs, occ):
    sph, tri, o, d, t_min, t_max = args[:6]
    if any(b is not None and b.shape[0] for b in (kwargs.get("sph_box"),
                                                 kwargs.get("tri_box"))):
        return None
    query = t_max >= t_min
    rows = tri.shape[0] * ys.TRI_OPS + roofline.sphere_rows(sph) * ys.SPH_OPS
    ops = int((query & ~occ).sum()) * rows + int((query & occ).sum()) * ys.SPH_OPS
    return ys.nbytes(o, d, t_min, t_max, occ, sph, tri), ops


def read(rec):
    return roofline.share(rec, "any_hit_roofline", PATTERN)
