"""Temporal stage: 64 bytes a pixel over 3.35 TB/s for each launch of
the reprojecting blend's kernel in the traced window, over their device
time, in percent."""

from benchmark import counts

KERNEL = "temporal_kernel"


def read(run):
    if run.trace is None:
        return None
    k = run.trace.kernels(KERNEL)
    t = sum(e - s for _, s, e in k) * 1e-6
    if not k or t <= 0:
        return None
    return 100.0 * len(k) * counts.temporal_least_s(run.height, run.width) / t
