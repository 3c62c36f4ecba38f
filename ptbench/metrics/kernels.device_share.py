"""Device time of the program's hand-written kernels over all device time of
the traced passes, from the profiler's device trace.

The kernels are named here, as ``pathtrace_tpu_torch/csrc/*.cu`` defines
them, so that what the metric counts changes only with this file: a kernel
renamed, split or added in the program counts as glue until it is listed.
"""

KERNELS = (
    "any_hit_kernel",
    "binned_round_anyhit_kernel",
    "binned_round_closest_kernel",
    "bvh_anyhit_kernel",
    "bvh_closest_kernel",
    "combined_closest_small_kernel",
    "fused_bounce_kernel",
    "resident_anyhit_kernel",
    "resident_closest_kernel",
    "shadow_any_hit_kernel",
    "sphere_closest_kernel",
    "triangle_closest_kernel",
)


def read(rec):
    t = rec["trace"]
    if t is None or not t.device:
        return None
    mine, _ = t.kernel_seconds(r"(?<!\w)(" + "|".join(KERNELS) + r")\b")
    return 100.0 * mine / t.device_s
