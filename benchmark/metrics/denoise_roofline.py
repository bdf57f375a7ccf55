"""Denoise stage: the least time of each denoise launch in the traced
window (56 bytes a pixel over 3.35 TB/s, or its float32 operations over
67 TFLOP/s, whichever is longer), over their device time, in percent."""

from benchmark import counts

KERNEL = "denoise"


def read(run):
    if run.trace is None or not run.radius:
        return None
    k = run.trace.kernels(KERNEL)
    t = sum(e - s for _, s, e in k) * 1e-6
    if not k or t <= 0:
        return None
    least = counts.denoise_least_s(run.height, run.width, run.radius)
    return 100.0 * len(k) * least / t
