"""Share of its roofline that ``bvh_closest`` (the mesh route's closest
triangle hit) reaches over the traced passes. Work: every row of every BVH
leaf that ``[t_min, min(t_max, t)]`` enters, ``t`` the answer; bytes: the
rays, ranges, outputs and the triangle, leaf and group tables."""

import torch

from ptbench import roofline
from ptbench import yardstick as ys

LAUNCHER = ("pathtrace_tpu_torch.ops.intersect", "bvh_closest")
PATTERN = r"(?<!\w)bvh_closest_kernel\b"


def work(args, kwargs, result):
    if kwargs.get("counters"):
        return None
    tables, o, d, t_min, t_max = args[:5]
    rows = tables.tri.shape[0] // tables.leaf.shape[0]
    need = ys.entered_rows(tables.leaf, rows, o, d, t_min, torch.minimum(t_max, result[0]))
    return (ys.nbytes(o, d, t_min, t_max, tables.tri, tables.leaf, tables.group, *result),
            need * ys.TRI_OPS)


def read(rec):
    return roofline.share(rec, "bvh_closest_roofline", PATTERN)
