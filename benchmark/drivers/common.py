"""What every driver shares: the harness's spans, the snapshots that
the correctness check compares, and the pinned host buffers."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

now = time.perf_counter


def spans(traced: bool):
    """The harness's span around a call into the program:
    ``record_function`` under the profiler, nothing otherwise."""
    if traced:
        return torch.autograd.profiler.record_function
    return lambda name: contextlib.nullcontext()


def state_copy(renderer) -> Dict:
    """The renderer's state as it stands: its tensors are replaced, not
    written, by the frames after it (``render()`` returns new planes,
    a sequence's state is a clone), so holding them costs nothing."""
    return dict(renderer.state)


class Snapshot:
    """One unit of work kept for the check: the state before it (None
    for the warm-up's unit, which starts from a fresh state), its
    cameras, suns and first frame number, the state after it and the u8
    images that reached the host."""

    def __init__(self, kind: str, state_before: Dict, cams: List,
                 first_frame: int, prev_pose, suns: Optional[List] = None):
        self.kind = kind
        self.state_before = state_before
        self.prev_pose = prev_pose  # the pose of the frame before it
        self.cams = cams  # [(position, direction)] a frame
        # the sun's yaw a frame (None: the program's default sun); None
        # for the whole unit where every frame is at the default sun
        self.suns = suns
        self.first_frame = first_frame
        self.state_after: Optional[Dict] = None
        self.images: List[np.ndarray] = []


class Arm:
    """Snapshots wanted at fractions of the window: each ``(fraction,
    kind)`` is armed once that share of the window has passed, and taken
    at the next unit of work of its kind."""

    def __init__(self, wanted):
        self.wanted = sorted(wanted)

    def due(self, frac: float, kind_ok) -> Optional[str]:
        for j, (f, kind) in enumerate(self.wanted):
            if f <= frac and kind_ok(kind):
                del self.wanted[j]
                return kind
        return None


def pinned(shape, dtype=torch.uint8) -> torch.Tensor:
    """Page-locked host memory where there is a card (a copy into
    pageable memory would wait for the device), plain memory without."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.cuda.is_available())


class Event:
    """A CUDA event where there is a card; without one, the work is
    done when it returns and there is nothing to wait for."""

    def __init__(self):
        self.event = torch.cuda.Event() if torch.cuda.is_available() else None

    def record(self):
        if self.event is not None:
            self.event.record()

    def synchronize(self):
        if self.event is not None:
            self.event.synchronize()
