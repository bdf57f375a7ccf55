"""Trace stage: the least time of the picked traced frames over the
trace kernel's time on them, in percent.  The least time counts the
operations (over 33.5 T lane operations a second) and bytes (over
3.35 TB/s) that the benchmark's reference traced for those frames, at
the same cameras and frame numbers (``benchmark/counts.py``)."""

from benchmark import counts

KERNEL = "trace_kernel"


def read(run):
    if run.trace is None or not run.picks:
        return None
    frames = run.trace.frames(KERNEL)
    t = 0.0
    rays = steps = 0
    for p in run.picks:
        if p.position >= len(frames):
            return None
        t += sum((e - s) * 1e-6 for n, s, e in frames[p.position]
                 if KERNEL in n)
        rays, steps = rays + p.rays, steps + p.steps
    pixels = run.height * run.width * len(run.picks)
    least = counts.trace_least_s(rays, steps, pixels, len(run.picks))
    return 100.0 * least / t if t > 0 else None
