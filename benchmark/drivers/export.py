"""Video export: ``Renderer.render_sequence`` over the camera path in
batches (on the card one CUDA-graph replay a frame), each batch's u8
frames copied into pinned host memory before the next batch starts, as
an exporter that writes them out does (the image files themselves are
left out of the window).  A batch's frames reach the host with its
copy."""

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
        self.traffic = traffic
        self.Camera = Camera
        self.batch = int(workload["traffic"]["batch"])
        h, w = self.r.height, self.r.width
        self.host = pinned((self.batch, h, w, 3))
        # a checked batch's frames go to buffers of their own: kept
        # without a copy inside the window
        n_checks = int(workload["check"].get("batches", 0))
        self.kept = [pinned((self.batch, h, w, 3)) for _ in range(n_checks)]
        self.event = Event()
        self.i = 0

    def _cams(self):
        poses = [self.traffic.camera(self.i + j) for j in range(self.batch)]
        return poses, [self.Camera(position=p, direction=d) for p, d in poses]

    def _batch(self, span, dest):
        poses, cams = self._cams()
        with span("replay"):
            frames = self.r.render_sequence(cams)
        with span("copy_out"):
            dest.copy_(frames, non_blocking=True)
            self.event.record()
            self.event.synchronize()
        self.i += self.batch
        return poses

    def warm(self):
        """One batch: the run's first frame captures the still frame's
        graph, the rest the reprojecting frame's; the warm-up's unit for
        the check, from a fresh state."""
        snap = Snapshot("warm", None, [], self.r.frame_number + 1, None)
        snap.cams = self._batch(spans(False), self.host)
        snap.state_after = state_copy(self.r)
        snap.images = list(np.array(self.host.numpy()))
        self.warm_unit = snap

    def run(self, seconds: float, wanted=(), traced: bool = False):
        span = spans(traced)
        arm = Arm(wanted)
        calls, ready, snaps = [], [], []
        t_start = now()
        t_end = t_start + seconds
        while True:
            t = now()
            if t >= t_end:
                break
            dest, snap = self.host, None
            if len(snaps) < len(self.kept) and arm.due(
                    (t - t_start) / seconds, lambda kind: True):
                dest = self.kept[len(snaps)]
                snap = Snapshot("batch", state_copy(self.r), [],
                                self.r.frame_number + 1,
                                self.traffic.camera(self.i - 1))
            calls.append(now())
            poses = self._batch(span, dest)
            ready.append(now())
            if snap is not None:
                snap.cams = poses
                snap.state_after = state_copy(self.r)
                snap.images = list(dest.numpy())
                snaps.append(snap)
        return {"t_start": t_start, "t_end": t_end, "calls": calls,
                "ready": ready, "frames_per_unit": self.batch,
                "snapshots": snaps}

    def traced(self, units: int, picks):
        span = spans(True)
        kept = []
        for j in range(units):
            if j in picks:
                pos, d = self.traffic.camera(self.i)
                kept.append((j * self.batch, Snapshot(
                    "pick", state_copy(self.r), [(pos, d)],
                    self.r.frame_number + 1, self.traffic.camera(self.i - 1))))
            self._batch(span, self.host)
        return kept
