"""Trace stage: the trace kernel's device milliseconds a frame in the
traced window (profiler)."""

KERNEL = "trace_kernel"


def read(run):
    if run.trace is None:
        return None
    k = run.trace.kernels(KERNEL)
    return sum(e - s for _, s, e in k) / len(k) * 1e-3 if k else None
