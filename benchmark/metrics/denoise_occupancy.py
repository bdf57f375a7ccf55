"""Denoise stage: the share of an SM's 64 warps (NVIDIA H100) that the
denoise kernel's launches keep resident, over the run (warm-up, window
and traced stretch), from the program's counters
(``voxtracer_torch.engine.pipeline.counters``):
``denoise.resident_warps`` (each launch adds the warps its plan keeps
resident on one SM, by the CUDA occupancy query at the plan's shared
bytes) over ``launches.denoise``, over 64.  A program without the
counter, or with no denoise launch, gives None."""

WARPS_PER_SM = 64


def read(run):
    try:
        from voxtracer_torch.engine.pipeline import counters
    except ImportError:
        return None
    counts = counters()
    launches = counts.get("launches.denoise", 0)
    if "denoise.resident_warps" not in counts or not launches:
        return None
    return 100.0 * counts["denoise.resident_warps"] / launches / WARPS_PER_SM
