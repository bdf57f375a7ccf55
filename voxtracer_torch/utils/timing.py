"""Frame timing instrumentation, and the program's spans and counts.

Counterpart of :mod:`voxtracer.utils.timing`: ``FpsCounter`` (0.25 s
refresh window) for an fps readout and, where the caller hands it each
frame's traced rays, the exact ray rate of the same window, and
``StageTimer`` for per-stage wall times.  PyTorch returns before the
device finishes, so a device stage is closed by
``torch.cuda.synchronize`` on the device its result lies on; a stage on
the CPU needs no closing.

The port adds two instruments of its own layers:

* :func:`span` marks a stretch of host work by name (``vt.render``,
  ``vt.stage.trace``, ``vt.fetch.wait``, ...).  It records only while a
  profiler records (``torch.autograd.profiler.profile``,
  ``torch.profiler.profile``): then it is a record-function range, which
  lands in the profiler's trace beside the device's activities and on
  their clock; a root span's ``args`` (e.g. the frame number) are the
  range's keyword inputs, kept where the profiler records shapes.
  Spans nest by time.  Otherwise it returns one shared no-op after a
  single check: nothing is built.  The range is the profiler's fast
  one (about a microsecond on the host; ``record_function`` costs ten).
* :data:`COUNTS` holds monotone counts, always on, one int add a site:
  the CUDA graphs captured and replayed, the kernel library's loads,
  the places the host blocked on the device, the frames enqueued by
  the frame driver's one native call, the lookahead fetch's host copies
  and those of them on its own copy stream, the warps each denoise
  launch keeps resident on an SM, and the scene builds with their host
  microseconds and table bytes.  ``engine.pipeline.counters``
  snapshots them with the frame kernels' launches.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

COUNTS: Dict[str, int] = {
    "graph.captures": 0,  # ``SequenceRunner.capture``: a graph captured
    "graph.replays": 0,  # ``SequenceRunner.run``: frames replayed
    "kernel.builds": 0,  # ``ops/_build.load``: the library built or loaded
    "host.waits": 0,  # the host blocked on the device (fetch, rows)
    "frames.direct": 0,  # ``engine/direct.py``: a frame by one native call
    # ``utils/fetch.py`` ``LookaheadFetch.push`` of a frame on a card:
    "fetch.copies": 0,  # a host copy started
    "fetch.stream_copies": 0,  # one enqueued on the fetch's copy stream
    # a denoise launch counted in ``launches.denoise``: the warps its plan
    # keeps resident on one SM (``ops/denoise.py`` ``resident_warps``)
    "denoise.resident_warps": 0,
    # one counted in ``launches.denoise`` whose range quotient takes one
    # correction (``ops/denoise.py`` ``reciprocal_launch``)
    "denoise.reciprocal_launches": 0,
    # ``engine/scene.py``: the scene build (set-up only)
    "scene.builds": 0,  # a ``SceneTables``
    "scene.device_builds": 0,  # one whose tables were built on a CUDA device
    "scene.load_us": 0,  # ``load_scene``: voxels and grid, host us
    "scene.tables_us": 0,  # the tables' build (host or device), us
    "scene.upload_us": 0,  # the tables' copies to the device, host us
    "scene.table_bytes": 0,  # the four tables' bytes
    "scene.per_node": 0,  # builds whose ``brick_idx`` has 2 planes
}

_OFF = contextlib.nullcontext()


def span(name: str, args: Optional[Dict[str, int]] = None):
    """A context that marks its block as ``name`` while a profiler
    records, and the one shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if args is None:
        return _RecordFunctionFast(name)
    return _RecordFunctionFast(name, (), args)


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
