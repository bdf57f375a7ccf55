"""Frame timing instrumentation.

Counterpart of :mod:`voxtracer.utils.timing`: ``Stopwatch`` for
per-frame dt, ``FpsCounter`` (0.25 s refresh window) for an fps readout
and, where the caller hands it each frame's traced rays, the exact ray
rate of the same window, and ``StageTimer`` for per-stage wall times.
PyTorch returns before the device finishes, so a device stage is closed by
``torch.cuda.synchronize`` on the device its result lies on; a stage on
the CPU needs no closing.
"""

from __future__ import annotations

import collections
import time
from typing import Dict

import torch


class Stopwatch:
    def __init__(self):
        self._prev = time.perf_counter()

    def tick(self) -> float:
        """Seconds since the previous tick."""
        now = time.perf_counter()
        dt = now - self._prev
        self._prev = now
        return dt


class FpsCounter:
    """Sliding frame counter refreshed every ``window`` seconds.

    ``rays_per_s`` is the sum of the rays handed to :meth:`tick` (the
    trace kernel's per-phase ray counters of each frame) over the same
    window's seconds: the exact ray rate, where the JAX package's
    viewers print ``H * W * fps``."""

    def __init__(self, window: float = 0.25):
        self.window = window
        self.fps = 0.0
        self.rays_per_s = 0.0
        self._frames = 0
        self._rays = 0
        self._t0 = time.perf_counter()

    def tick(self, rays: int = 0) -> float:
        self._frames += 1
        self._rays += int(rays)
        now = time.perf_counter()
        elapsed = now - self._t0
        if elapsed >= self.window:
            self.fps = self._frames / elapsed
            self.rays_per_s = self._rays / elapsed
            self._frames = 0
            self._rays = 0
            self._t0 = now
        return self.fps


class StageTimer:
    """Accumulates wall time per named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)

    def measure(self, name: str, fn, *args, sync=None, **kwargs):
        """``fn(*args, **kwargs)`` timed under ``name``.  ``sync`` maps
        the result to a tensor of it; where that tensor lies on a CUDA
        device, the stage ends when that device has finished."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync is not None:
            device = sync(out).device
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def report(self) -> Dict[str, float]:
        return {
            name: self.totals[name] / max(1, self.counts[name])
            for name in self.totals
        }
