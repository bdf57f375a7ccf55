"""Where a frame's device time goes: frames of a camera path under
``torch.profiler``.

    python -m voxtracer_torch.app.profile --scene monu9 --size 1920x1080 \\
        --path dolly --denoise-radius 2

Renders warm-up frames, then ``--frames`` frames inside one profiled
range that ends with a device synchronise.  From that one trace it
prints the range's wall time per frame, the device time per frame (the
union of the device activities inside the range: kernels, copies and
fills, never the host-side ops that launched them), their ratio (the
device busy share under the profiler) and the device time per activity
name.  Then the same number of further frames unprofiled, timed with
CUDA events, and the profiled device time over that frame time: an
estimate of the unprofiled busy share, as the two come from different
frames.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import sys
import time

import torch
from torch.autograd import DeviceType

from ..engine.pipeline import Renderer
from ..engine.scene import load_scene
from . import camera_paths

RANGE = "profiled frames"


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


def device_activities(events):
    """The device's own activities among profiler events: not the
    device-side copies of ``record_function`` ranges, nor the
    profiler's buffer bookkeeping."""
    return [
        e for e in events
        if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and e.name != RANGE
        and not e.name.startswith("Activity Buffer")
    ]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--scene", default="monu9")
    p.add_argument("--size", default="1920x1080", help="WIDTHxHEIGHT")
    p.add_argument("--path", default="dolly",
                   choices=sorted(camera_paths.PATHS))
    p.add_argument("--denoise-radius", type=int, default=2)
    p.add_argument("--fps-target", type=float, default=30.0)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    width, height = (int(v) for v in args.size.lower().split("x"))
    scene = load_scene(args.scene)
    path = camera_paths.PATHS[args.path](scene)
    cams = (path(i / args.fps_target) for i in itertools.count())
    r = Renderer(scene=scene, height=height, width=width, device=args.device,
                 denoise_radius=args.denoise_radius, lean=True)
    n = args.frames
    for _ in range(args.warmup):
        r.render(next(cams))
    _sync(r.device)

    activities = [torch.profiler.ProfilerActivity.CPU]
    if r.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(RANGE):
            for _ in range(n):
                r.render(next(cams))
            _sync(r.device)
    events = prof.events()
    span = next(e for e in events if e.name == RANGE
                and e.device_type == DeviceType.CPU).time_range
    dev = device_activities(events)
    busy_us = union_us(((e.time_range.start, e.time_range.end) for e in dev),
                       span.start, span.end)
    wall_ms = span.elapsed_us() / 1e3 / n
    busy_ms = busy_us / 1e3 / n
    label = (f"{args.scene} {width}x{height} {args.path} "
             f"r={args.denoise_radius}, {n} frames")
    print(f"{label} profiled: wall {wall_ms:.4f} ms/frame, device "
          f"{busy_ms:.4f} ms/frame, busy share {busy_ms / wall_ms:.4f}, "
          f"{len(dev) / n:.1f} device activities/frame")
    per_name = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        per_name[e.name][0] += e.time_range.elapsed_us()
        per_name[e.name][1] += 1
    for name, (us, count) in sorted(per_name.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us / 1e3 / n:9.4f} ms/frame {count / n:5.1f}/frame  "
              f"{name[:100]}")

    if r.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            r.render(next(cams))
        end.record()
        end.synchronize()
        frame_ms = start.elapsed_time(end) / n
    else:
        t0 = time.perf_counter()
        for _ in range(n):
            r.render(next(cams))
        frame_ms = (time.perf_counter() - t0) * 1e3 / n
    print(f"{label} unprofiled: {frame_ms:.4f} ms/frame; profiled device "
          f"time over it (estimate of the busy share) "
          f"{busy_ms / frame_ms:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
