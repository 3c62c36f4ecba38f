"""Share of its roofline that ``bvh_anyhit`` (the mesh route's triangle
occlusion) reaches over the traced passes. Work: every row of every entered
BVH leaf for an unoccluded ray, one test for an occluded one; bytes: the
rays, ranges, result and the triangle, leaf and group tables."""

from ptbench import roofline
from ptbench import yardstick as ys

LAUNCHER = ("pathtrace_tpu_torch.ops.intersect", "bvh_anyhit")
PATTERN = r"(?<!\w)bvh_anyhit_kernel\b"


def work(args, kwargs, occ):
    tables, o, d, t_min, t_max = args[:5]
    rows = tables.tri.shape[0] // tables.leaf.shape[0]
    free = ~occ
    need = ys.entered_rows(tables.leaf, rows, o[free], d[free], t_min[free], t_max[free])
    return (ys.nbytes(o, d, t_min, t_max, occ, tables.tri, tables.leaf, tables.group),
            (need + int(occ.sum())) * ys.TRI_OPS)


def read(rec):
    return roofline.share(rec, "bvh_anyhit_roofline", PATTERN)
