"""Share of its roofline that ``combined_closest_small`` (the small route's
closest hit, the wave engine's on small scenes) reaches over the traced
passes. Work: every triangle and sphere row for each ray (the route has no
boxes); bytes: the rays, ranges, outputs and tables."""

from ptbench import roofline
from ptbench import yardstick as ys

LAUNCHER = ("pathtrace_tpu_torch.ops.intersect", "combined_closest_small")
PATTERN = r"(?<!\w)combined_closest_small_kernel\b"


def work(args, kwargs, result):
    tables, o, d, t_min, t_max = args[:5]
    rows = tables.tri_rows * ys.TRI_OPS + roofline.sphere_rows(tables.sph) * ys.SPH_OPS
    return (ys.nbytes(o, d, t_min, t_max, tables.tri, tables.sph, *result),
            int((t_max >= t_min).sum()) * rows)


def read(rec):
    return roofline.share(rec, "combined_closest_small_roofline", PATTERN)
