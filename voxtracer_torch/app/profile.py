"""Where a frame's device time goes: frames of a camera path under
``torch.profiler``.

    python -m voxtracer_torch.app.profile [--scene menger] [--size 1280x720] \\
        [--denoise-radius 0] [--static] [--frames 4] [--top 20] [--keep DIR]

The reference's command line (``voxtracer.app.profile``) with its
defaults: menger at 1280x720, radius 0, 4 frames along the dolly path,
or at ``camera_paths.static``'s pose with ``--static``; ``--top N``
prints the N activities with the most device time, ``--keep DIR``
leaves the profiled range's trace in ``DIR/trace.json``.  The port adds
``--path`` (any camera path; ``--static`` is ``--path static``),
``--warmup``, ``--batch`` and ``--device`` (``cuda`` unless the caller
asks for the CPU).  Its warm-up renders ``--warmup`` frames (3, rounded
up to whole batches: a ``render_sequence`` warm-up captures the graphs)
where the reference renders 2.

With ``--batch N`` the frames go through ``Renderer.render_sequence``,
N a call (on the card: replays of its captured CUDA graphs), instead of
``Renderer.render``.  Renders warm-up frames, then ``--frames`` frames inside one profiled
range that ends with a device synchronise.  From that one trace it
prints the range's wall time per frame, the device time per frame (the
union of the device activities inside the range: kernels, copies and
fills, never the host-side ops that launched them), their ratio (the
device busy share under the profiler) and the device time per activity
name.  Then the same number of further frames unprofiled, timed with
CUDA events, and the profiled device time over that frame time: an
estimate of the unprofiled busy share, as the two come from different
frames.

:func:`profile_frames` is the counterpart of the JAX package's: frames
of a list of cameras under the same profiled range, returning the device
time per activity name (``app/ibench.py``'s ``wall`` row reads it).
"""

from __future__ import annotations

import argparse
import collections
import itertools
import os
import sys
import time
from typing import Callable, List, Tuple

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
    device-side copies of ``record_function`` ranges, nor anything named
    for the program's spans (``vt.*``, host ranges that have no device
    copy today), nor the profiler's buffer bookkeeping."""
    return [
        e for e in events
        if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and e.name != RANGE
        and not e.name.startswith(("vt.", "Activity Buffer"))
    ]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_range(advance: Callable[[], None], device, logdir=None):
    """``advance()`` inside one profiled range that ends with a device
    synchronise; with ``logdir``, the trace goes to
    ``logdir/trace.json``.  Returns the range's wall microseconds, the
    device activities inside it, and the union of their intervals in
    microseconds (the device's busy time)."""
    # torch.autograd.profiler, the Kineto profiler under torch.profiler:
    # torch.profiler imports torch._inductor (and with it Triton, where
    # it is installed) each time it starts
    with torch.autograd.profiler.profile(
            use_device="cuda" if device.type == "cuda" else None,
            use_kineto=True) as prof:
        with torch.autograd.profiler.record_function(RANGE):
            advance()
            _sync(device)
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    events = prof.function_events
    span = next(e for e in events if e.name == RANGE
                and e.device_type == DeviceType.CPU).time_range
    dev = device_activities(events)
    busy_us = union_us(((e.time_range.start, e.time_range.end) for e in dev),
                       span.start, span.end)
    return span.elapsed_us(), dev, busy_us


def frame_activities(advance: Callable[[], None], device, frames: int,
                     first: str = "trace_kernel", tries: int = 3):
    """Device activities and copies a frame of ``advance()``, which
    renders ``frames`` frames that each launch the kernel named
    ``*first*`` once: those from the first frame's launch of it up to the
    last frame's, over ``frames - 1``.  The work before the first frame
    and after the last (a sequence's rows and state in and out) falls
    outside that window, and so does whatever the profiler drops or adds
    at the ends of its range.  A range that lacks one of the frames'
    launches is profiled again, ``tries`` times at most."""
    seen = []
    for _ in range(tries):
        _, dev, _ = profile_range(advance, device)
        dev = sorted(dev, key=lambda e: e.time_range.start)
        at = [i for i, e in enumerate(dev) if first in e.name]
        if len(at) == frames:
            window = dev[at[0]:at[-1]]
            copies = sum("memcpy" in e.name.lower() for e in window)
            return len(window) / (frames - 1), copies / (frames - 1)
        seen.append(len(at))
    raise RuntimeError(f"{frames} frames launched *{first}* {seen} times "
                       "in the profiled ranges")


def activity_rows(dev) -> List[Tuple[str, float, int]]:
    """``(name, device ns, count)`` per activity name, by descending
    device time."""
    per_name = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        per_name[e.name][0] += e.time_range.elapsed_us() * 1e3
        per_name[e.name][1] += 1
    return sorted(((name, ns, count) for name, (ns, count) in
                   per_name.items()), key=lambda row: -row[1])


def profile_frames(renderer, cameras, logdir=None) -> List[Tuple[str, float]]:
    """Render ``cameras`` under one profiled range (after one frame at
    the first camera and one at the second, outside it, that build the
    kernels); returns ``[(activity name, device ns)]`` by descending
    device time.  With ``logdir`` the trace is kept there."""
    renderer.render(cameras[0])
    renderer.render(cameras[min(1, len(cameras) - 1)])
    _sync(renderer.device)

    def advance():
        for camera in cameras:
            renderer.render(camera)

    _, dev, _ = profile_range(advance, renderer.device, logdir)
    return [(name, ns) for name, ns, _ in activity_rows(dev)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--scene", default="menger")
    p.add_argument("--size", default="1280x720", help="WIDTHxHEIGHT")
    p.add_argument("--path", default="dolly",
                   choices=sorted(camera_paths.PATHS))
    p.add_argument("--static", action="store_true",
                   help="hold the camera still (--path static)")
    p.add_argument("--denoise-radius", type=int, default=0)
    p.add_argument("--fps-target", type=float, default=30.0)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--top", type=int, default=20,
                   help="activity rows printed, by device time")
    p.add_argument("--keep", metavar="DIR", default=None,
                   help="keep the profiled range's trace as DIR/trace.json")
    p.add_argument("--batch", type=int, default=1,
                   help="frames a render_sequence call; 1: render() a frame")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.batch < 1 or args.frames % args.batch:
        raise SystemExit(f"--frames {args.frames} is no multiple of --batch "
                         f"{args.batch}")

    width, height = (int(v) for v in args.size.lower().split("x"))
    if args.top < 0:
        raise SystemExit(f"--top {args.top} is negative")
    if args.static:
        args.path = "static"
    scene = load_scene(args.scene)
    path = camera_paths.PATHS[args.path](scene)
    cams = (path(i / args.fps_target) for i in itertools.count())
    r = Renderer(scene=scene, height=height, width=width, device=args.device,
                 denoise_radius=args.denoise_radius, lean=True)
    n = args.frames

    def advance(frames):
        if args.batch == 1:
            for _ in range(frames):
                r.render(next(cams))
        else:
            for _ in range(frames // args.batch):
                r.render_sequence([next(cams) for _ in range(args.batch)])

    # whole batches in the warm-up: the first sequence captures its graphs
    advance(-(-args.warmup // args.batch) * args.batch)
    _sync(r.device)

    wall_us, dev, busy_us = profile_range(lambda: advance(n), r.device,
                                          args.keep)
    wall_ms = wall_us / 1e3 / n
    busy_ms = busy_us / 1e3 / n
    label = (f"{args.scene} {width}x{height} {args.path} "
             f"r={args.denoise_radius}, {n} frames"
             + (f" in sequences of {args.batch}" if args.batch > 1 else ""))
    print(f"{label} profiled: wall {wall_ms:.4f} ms/frame, device "
          f"{busy_ms:.4f} ms/frame, busy share {busy_ms / wall_ms:.4f}, "
          f"{len(dev) / n:.1f} device activities/frame")
    for name, ns, count in activity_rows(dev)[:args.top]:
        print(f"  {ns / 1e6 / n:9.4f} ms/frame {count / n:5.1f}/frame  "
              f"{name[:100]}")

    if r.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        advance(n)
        end.record()
        end.synchronize()
        frame_ms = start.elapsed_time(end) / n
    else:
        t0 = time.perf_counter()
        advance(n)
        frame_ms = (time.perf_counter() - t0) * 1e3 / n
    print(f"{label} unprofiled: {frame_ms:.4f} ms/frame; profiled device "
          f"time over it (estimate of the busy share) "
          f"{busy_ms / frame_ms:.4f}")
    if args.keep:
        print(f"trace kept in {os.path.join(args.keep, 'trace.json')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
