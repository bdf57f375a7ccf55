"""The one traffic generator: which camera each frame of a run sees.

A traffic mix (``traffic`` of ``benchmark/workloads/<cell>.json``)
names a camera path (``benchmark/paths/<name>.py``) and its parameters,
the path time a moving frame advances (``frame_dt``), and optionally a
segment rule: runs of moving frames and runs of held frames in turn,
each ``min``..``max`` frames long (uniform), the first of either kind
with equal odds; or ``hold``: the camera never leaves the path's start
(every frame after the first is held).  The seed draws the path's start
time in ``[0, period)``, the first kind and the segment lengths.
Optionally ``sun`` steps the sun's yaw frame by frame: frame ``i`` at
``yaw + yaw_step * i``, the rest of the lighting at the program's
defaults; a traffic without it leaves the lighting alone.  Frames
advance the path and the sun by frame index, never by wall time, so a
faster program does the same work a frame.
"""

from __future__ import annotations

import importlib
from typing import Optional, Tuple

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
    ``(position, direction)``, :meth:`moving` whether it moved,
    :meth:`sun_yaw` its sun."""

    def __init__(self, spec: dict, world_min, world_max, seed: int):
        self.path = load_path(spec["path"], world_min, world_max)
        rng = np.random.default_rng(seed)
        period = float(spec["path"].get("period", 1.0))
        self.t0 = float(rng.uniform(0.0, period))
        seg = spec.get("segments")
        self._hold = bool(spec.get("hold", False))
        if self._hold and seg is not None:
            raise ValueError("a held camera has no segments")
        # the path time a moving frame advances: none for a held camera
        self.dt = 0.0 if self._hold else float(spec.get("frame_dt", 0.0))
        sun = spec.get("sun")
        self._sun = None if sun is None else (float(sun["yaw"]),
                                              float(sun["yaw_step"]))
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
            if self._hold:
                move = False
            elif self._seg is None:
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

    def sun_yaw(self, i: int) -> Optional[float]:
        """The sun's yaw at frame ``i`` where the traffic steps the sun,
        in float64; None where it leaves the program's sun alone."""
        if self._sun is None:
            return None
        yaw, step = self._sun
        return yaw + step * i
