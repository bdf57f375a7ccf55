"""Reading the profiler's trace: the device's own activities, the union
of their intervals (busy time), kernels by frame, and the host span the
harness was in during each idle gap.  Copies of the port's
``app/profile.py`` ``union_us`` and ``device_activities``; the
per-frame split generalises its ``frame_activities``."""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

RANGE = "traced window"


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    ``[lo, hi]``."""
    total, reach = 0.0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            total += end - start
            reach = end
    return total


def idle_gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    gaps, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach and start <= hi:
            gaps.append((reach, min(start, hi)))
        reach = max(reach, end)
    if reach < hi:
        gaps.append((reach, hi))
    return gaps


class Trace:
    """What one profiled range holds: the window (microseconds on the
    profiler's clock), the device activities as ``(name, start, end)``
    sorted by start, and the harness spans as ``(name, start, end)``."""

    def __init__(self, window, activities, spans):
        self.lo, self.hi = window
        self.activities = sorted(activities, key=lambda a: a[1])
        self.spans = sorted(spans, key=lambda s: s[1])

    @classmethod
    def from_profiler(cls, prof, span_names):
        from torch.autograd import DeviceType

        events = prof.function_events
        window = next(e for e in events if e.name == RANGE
                      and e.device_type == DeviceType.CPU).time_range
        acts, spans = [], []
        for e in events:
            r = e.time_range
            if e.device_type == DeviceType.CUDA:
                if (getattr(e, "is_user_annotation", False) or e.name == RANGE
                        or e.name in span_names
                        or e.name.startswith("Activity Buffer")):
                    continue
                acts.append((e.name, r.start, r.end))
            elif e.name in span_names:
                spans.append((e.name, r.start, r.end))
        return cls((window.start, window.end), acts, spans)

    def window_us(self) -> float:
        return self.hi - self.lo

    def busy_us(self) -> float:
        return union_us(((s, e) for _, s, e in self.activities),
                        self.lo, self.hi)

    def kernels(self, part: str):
        """The activities whose name holds ``part``."""
        return [a for a in self.activities if part in a[0]]

    def frames(self, first: str = "trace_kernel") -> List[list]:
        """The activities split into frames: each frame's from its
        launch of the kernel named ``*first*`` up to the next frame's
        (the last frame's up to the window's end)."""
        out: List[list] = []
        for a in self.activities:
            if first in a[0]:
                out.append([])
            if out:
                out[-1].append(a)
        return out

    def ops_per_frame(self, first: str = "trace_kernel") -> float:
        """Device activities a frame: those from the first frame's
        launch of ``*first*`` up to the last frame's, over the frames
        between."""
        at = [i for i, a in enumerate(self.activities) if first in a[0]]
        if len(at) < 2:
            return None
        return (at[-1] - at[0]) / (len(at) - 1)

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        """``(name, seconds)`` of the activities with the most device
        time, summed by name."""
        per = collections.defaultdict(float)
        for name, s, e in self.activities:
            per[name] += (e - s) * 1e-6
        return sorted(per.items(), key=lambda kv: -kv[1])[:n]

    def idle_by_span(self, n: int = 10) -> List[Tuple[str, float]]:
        """Idle device seconds by the harness span the host was in at
        the start of each gap ("none": between spans)."""
        per: Dict[str, float] = collections.defaultdict(float)
        gaps = idle_gaps(((s, e) for _, s, e in self.activities),
                         self.lo, self.hi)
        for gs, ge in gaps:
            name = "none"
            for sname, ss, se in self.spans:
                if ss <= gs < se:
                    name = sname
                    break
                if ss > gs:
                    break
            per[name] += (ge - gs) * 1e-6
        return sorted(per.items(), key=lambda kv: -kv[1])[:n]
