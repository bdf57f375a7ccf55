"""The 95th percentile (nearest rank), over every frame delivered in the
window, of the milliseconds from the start of the frame's ``render()``
call to the moment the host can read its image (one frame of lookahead
included)."""

import math


def percentile(values, q: float) -> float:
    """Nearest-rank percentile ``q`` (0-100) of ``values``."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


def read(run):
    rec = run.record
    lat = [(rec["ready"][j] - rec["calls"][j]) * 1e3 for j in run.delivered()]
    return percentile(lat, 95) if lat else None
