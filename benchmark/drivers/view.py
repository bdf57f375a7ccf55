"""The interactive viewer's loop: one client, closed: the next frame
starts when the previous ``Renderer.render()`` returns, and each image
is pushed through ``LookaheadFetch`` as the web viewer does, so the host
reads frame N while the card renders frame N + 1.

A frame's image reaches host memory when the ``push()`` of the next
frame returns; its latency runs from the start of its ``render()``.
A snapshot is two consecutive frames of one kind (``moving``: both
moved, each reprojects the other's history; ``held``: both at the pose
of the frame before them, still blends), so the check sees the state
that a frame carries into the next.

Where the traffic steps the sun, each frame's yaw is set before its
``render()`` by replacing ``Renderer.render_params``, as the port's
BASELINE config 5 and a viewer's sun slider do; a traffic without a sun
leaves ``render_params`` as it is."""

from __future__ import annotations

import dataclasses

import numpy as np

from .common import Arm, Snapshot, now, spans, state_copy

SPANS = ("render", "push")


class Driver:
    def __init__(self, renderer, traffic, workload):
        from voxtracer_torch.engine.camera import Camera
        from voxtracer_torch.utils.fetch import LookaheadFetch

        self.r = renderer
        self.traffic = traffic
        self.Camera = Camera
        self.fetch = LookaheadFetch()
        self.i = 0  # the traffic's next frame

    def camera(self, i):
        pos, d = self.traffic.camera(i)
        return self.Camera(position=pos, direction=d)

    def sun(self, i):
        """Set frame ``i``'s sun where the traffic steps it; returns its
        yaw (None: the program's own)."""
        yaw = self.traffic.sun_yaw(i)
        if yaw is not None:
            self.r.render_params = dataclasses.replace(self.r.render_params,
                                                       sun_yaw=yaw)
        return yaw

    def warm(self):
        """A still frame without history, a reprojecting frame (still,
        where the traffic holds its camera) and a still frame with
        history, each pushed (both pinned slots), at the suns of the
        traffic's frames 0-2: the warm-up's unit for the check, from a
        fresh state."""
        snap = Snapshot("warm", None, [], self.r.frame_number + 1, None, [])
        c0 = self.camera(0)
        pos, d = self.traffic.path(self.traffic.t0 + self.traffic.dt)
        c1 = self.Camera(position=pos, direction=d)
        for i, cam in enumerate((c0, c1, c1)):
            snap.cams.append((cam.position, cam.direction))
            snap.suns.append(self.sun(i))
            got = self.fetch.push(self.r.render(cam))
            if got is not None:
                snap.images.append(np.array(got[0]))
        snap.images.append(np.array(self.fetch.flush()[0]))
        snap.state_after = state_copy(self.r)
        self.warm_unit = snap
        self.prev_pose = (pos, d)

    def _kind_ok(self, i):
        tr = self.traffic
        a, b = tr.moving(i), tr.moving(i + 1)
        return lambda kind: (a and b) if kind == "moving" else not (a or b)

    def run(self, seconds: float, wanted=(), traced: bool = False):
        """Frames until ``seconds`` have passed; returns the record."""
        span = spans(traced)
        arm = Arm(wanted)
        calls, rets, pushes, ready = [], [], [], []
        snaps, taking = [], []  # taking: (snapshot, frames left)
        waiting = {}  # frame index in this run -> snapshot awaiting image
        t_start = now()
        t_end = t_start + seconds
        k = 0
        while True:
            t = now()
            if t >= t_end:
                break
            i = self.i
            if not taking:
                kind = arm.due((t - t_start) / seconds, self._kind_ok(i))
                if kind:
                    snap = Snapshot(kind, state_copy(self.r), [],
                                    self.r.frame_number + 1, self.prev_pose,
                                    [])
                    snaps.append(snap)
                    taking = [snap, 2]
            cam = self.camera(i)
            yaw = self.sun(i)
            self.prev_pose = (cam.position, cam.direction)
            calls.append(now())
            with span("render"):
                out = self.r.render(cam)
            rets.append(now())
            with span("push"):
                got = self.fetch.push(out)
            pushes.append(now())
            if got is not None:
                ready.append(pushes[-1])
                if k - 1 in waiting:
                    waiting.pop(k - 1).images.append(np.array(got[0]))
            if taking:
                snap = taking[0]
                snap.cams.append((cam.position, cam.direction))
                snap.suns.append(yaw)
                waiting[k] = snap
                taking[1] -= 1
                if taking[1] == 0:
                    snap.state_after = state_copy(self.r)
                    taking = []
            self.i += 1
            k += 1
        got = self.fetch.flush()
        if got is not None:
            ready.append(now())
            if k - 1 in waiting:
                waiting.pop(k - 1).images.append(np.array(got[0]))
        snaps = [s for s in snaps if s.state_after is not None]
        return {"t_start": t_start, "t_end": t_end, "calls": calls,
                "rets": rets, "pushes": pushes, "ready": ready,
                "frames_per_unit": 1, "snapshots": snaps}

    def traced(self, units: int, picks):
        """``units`` frames under the profiler's spans; ``picks`` are
        frame positions in this run whose state before, camera and frame
        number are kept (for the counts of their trace and epilogue)."""
        span = spans(True)
        kept = []
        for j in range(units):
            cam = self.camera(self.i)
            yaw = self.sun(self.i)
            if j in picks:
                kept.append((j, Snapshot("pick", state_copy(self.r),
                                         [(cam.position, cam.direction)],
                                         self.r.frame_number + 1,
                                         self.prev_pose, [yaw])))
            self.prev_pose = (cam.position, cam.direction)
            with span("render"):
                out = self.r.render(cam)
            with span("push"):
                self.fetch.push(out)
            self.i += 1
        with span("push"):
            self.fetch.flush()
        return kept
