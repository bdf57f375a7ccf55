"""Progressive accumulation to a converged still: one
``Renderer.render_burst(camera, n)`` call after another at one pose
(on the card, ``n`` replays of the still frame's CUDA graph), each
call's last image copied to a pinned host buffer, the accumulation
carried from call to call.  Two buffers in turn: the host waits for a
call's copy only after it has enqueued the next call.  A call's ``n``
frames reach the host with its image."""

from __future__ import annotations

import numpy as np

from .common import Arm, Event, Snapshot, now, pinned, spans, state_copy

SPANS = ("replay", "copy_out")


class Driver:
    def __init__(self, renderer, traffic, workload):
        from voxtracer_torch.engine.camera import Camera

        if traffic.sun_yaw(0) is not None:
            raise ValueError("a traffic that steps the sun needs the view "
                             "driver")
        self.r = renderer
        self.n = int(workload["traffic"]["burst"])
        pos, d = traffic.camera(0)
        self.cam = Camera(position=pos, direction=d)
        self.pose = (pos, d)
        h, w = self.r.height, self.r.width
        self.host = [pinned((h, w, 3)), pinned((h, w, 3))]
        self.events = [Event(), Event()]

    def warm(self):
        """One call: it captures the still frame's graph; the warm-up's
        unit for the check, from a fresh state."""
        snap = Snapshot("warm", None, [self.pose], self.r.frame_number + 1,
                        None)
        self.host[0].copy_(self.r.render_burst(self.cam, self.n))
        self.events[0].record()
        self.events[0].synchronize()
        snap.images.append(np.array(self.host[0].numpy()))
        snap.state_after = state_copy(self.r)
        self.warm_unit = snap

    def _call(self, span, turn):
        with span("replay"):
            image = self.r.render_burst(self.cam, self.n)
        with span("copy_out"):
            self.host[turn].copy_(image, non_blocking=True)
            self.events[turn].record()

    def run(self, seconds: float, wanted=(), traced: bool = False):
        span = spans(traced)
        arm = Arm(wanted)
        calls, ready, snaps = [], [], []
        pending = None  # (turn, snapshot or None)
        turn = 0
        t_start = now()
        t_end = t_start + seconds
        while True:
            t = now()
            if t >= t_end:
                break
            snap = None
            if arm.due((t - t_start) / seconds, lambda kind: True):
                snap = Snapshot("burst", state_copy(self.r), [self.pose],
                                self.r.frame_number + 1, self.pose)
            calls.append(now())
            self._call(span, turn)
            if snap is not None:
                snap.state_after = state_copy(self.r)
                snaps.append(snap)
            if pending is not None:
                self._land(span, pending, ready)
            pending = (turn, snap)
            turn ^= 1
        if pending is not None:
            self._land(span, pending, ready)
        return {"t_start": t_start, "t_end": t_end, "calls": calls,
                "ready": ready, "frames_per_unit": self.n,
                "snapshots": snaps}

    def _land(self, span, pending, ready):
        turn, snap = pending
        with span("copy_out"):
            self.events[turn].synchronize()
        ready.append(now())
        if snap is not None:
            snap.images.append(np.array(self.host[turn].numpy()))

    def traced(self, units: int, picks):
        """``units`` calls under the profiler's spans; for each call
        position in ``picks``, the state before its first frame."""
        span = spans(True)
        kept = []
        for j in range(units):
            if j in picks:
                kept.append((j * self.n, Snapshot(
                    "pick", state_copy(self.r), [self.pose],
                    self.r.frame_number + 1, self.pose)))
            self._call(span, j % 2)
            with span("copy_out"):
                self.events[j % 2].synchronize()
        return kept
