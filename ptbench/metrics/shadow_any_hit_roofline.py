"""Share of its roofline that ``shadow_any_hit`` (the fused pool's NEE
occlusion kernel) reaches over the traced passes. Work: every row for an
unoccluded shadow query, one test for an occluded one; bytes: the rays,
ranges, result and tables."""

from ptbench import roofline
from ptbench import yardstick as ys

LAUNCHER = ("pathtrace_tpu_torch.ops.shade", "shadow_any_hit")
PATTERN = r"(?<!\w)shadow_any_hit_kernel\b"


def work(args, kwargs, occ):
    tables, o, d, t_max = args[:4]
    query = t_max >= kwargs.get("eps", 1e-3)
    rows = (roofline.triangle_rows(tables.tri) * ys.TRI_OPS
            + roofline.sphere_rows(tables.sph) * ys.SPH_OPS)
    ops = int((query & ~occ).sum()) * rows + int((query & occ).sum()) * ys.SPH_OPS
    return ys.nbytes(o, d, t_max, occ, *tables), ops


def read(rec):
    return roofline.share(rec, "shadow_any_hit_roofline", PATTERN)
