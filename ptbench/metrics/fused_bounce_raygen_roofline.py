"""Share of its roofline that ``fused_bounce``'s raygen instance (the fused
pool's vertex kernel) reaches over the traced passes. Work: the closest-hit
tests of the busy lanes over every triangle and sphere row (its shading is
not counted); bytes: its inputs, the scene tables and its outputs."""

from ptbench import roofline
from ptbench import yardstick as ys

LAUNCHER = ("pathtrace_tpu_torch.ops.shade", "fused_bounce")
PATTERN = r"(?<!\w)fused_bounce_kernel\b"


def work(args, kwargs, result):
    if kwargs.get("raygen") is None or kwargs.get("fuse_shadow"):
        return None
    tables, busy = args[0], args[1]
    rows = kwargs["num_tris"] * ys.TRI_OPS + roofline.sphere_rows(tables.sph) * ys.SPH_OPS
    return (ys.nbytes(*args[1:], *kwargs["raygen"], *tables, *result),
            int(busy.sum()) * rows)


def read(rec):
    return roofline.share(rec, "fused_bounce_raygen_roofline", PATTERN)
