"""The one traffic generator: which camera each frame of a run sees.

A traffic mix (``traffic`` of ``benchmark/workloads/<cell>.json``)
names a camera path (``benchmark/paths/<name>.py``) and its parameters,
the path time a moving frame advances (``frame_dt``), and optionally a
segment rule: runs of moving frames and runs of held frames in turn,
each ``min``..``max`` frames long (uniform), the first of either kind
with equal odds.  The seed draws the path's start time in
``[0, period)``, the first kind and the segment lengths.  Frames advance
the path by frame index, never by wall time, so a faster program does
the same work a frame.
"""

from __future__ import annotations

import importlib
from typing import Tuple

import numpy as np


def load_path(spec: dict, world_min, world_max):
    """The path ``spec["name"]`` with the rest of ``spec`` as its
    parameters."""
    params = {k: v for k, v in spec.items() if k != "name"}
    module = importlib.import_module(f"benchmark.paths.{spec['name']}")
    return module.make(np.asarray(world_min, np.float32),
                       np.asarray(world_max, np.float32), **params)


class Traffic:
    """Frame ``i`` (0, 1, ...) of a run: :meth:`camera` gives its
    ``(position, direction)``, :meth:`moving` whether it moved."""

    def __init__(self, spec: dict, world_min, world_max, seed: int):
        self.path = load_path(spec["path"], world_min, world_max)
        rng = np.random.default_rng(seed)
        period = float(spec["path"].get("period", 1.0))
        self.t0 = float(rng.uniform(0.0, period))
        self.dt = float(spec.get("frame_dt", 0.0))
        seg = spec.get("segments")
        self._rng = rng
        self._seg = seg
        # per frame: the path time it shows and whether it moved
        self._times = [self.t0]
        self._moving = [True]
        if seg is not None:
            # the kind before the first segment (True: moving), so the
            # first segment is of the other kind
            self._kind = bool(rng.integers(0, 2))
            self._left = 0

    def _extend(self, n: int):
        while len(self._times) < n:
            t = self._times[-1]
            if self._seg is None:
                move = True
            else:
                if self._left == 0:
                    self._left = int(self._rng.integers(
                        self._seg["min"], self._seg["max"] + 1))
                    self._kind = not self._kind
                move = self._kind
                self._left -= 1
            self._times.append(t + self.dt if move else t)
            self._moving.append(move)

    def time(self, i: int) -> float:
        self._extend(i + 1)
        return self._times[i]

    def camera(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.path(self.time(i))

    def moving(self, i: int) -> bool:
        """True if frame ``i`` shows another pose than frame ``i - 1``."""
        self._extend(i + 1)
        return self._moving[i]
