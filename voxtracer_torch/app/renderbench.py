"""What a frame costs the host and the device, in two trees.

    python voxtracer_torch/app/renderbench.py --compare OTHER_TREE

renders configs 2, 3, 4 and 5 (menger 1280x720 still r=0, chr_knight
1280x720 orbit r=0, monu9 1920x1080 dolly r=2, castle 3840x2160 still
r=0) in four fresh processes, in turns: OTHER_TREE, this tree, this
tree, OTHER_TREE (a checkout of another commit that holds a
``voxtracer_torch`` package).  Each process prints one JSON line a
config:

* the per-frame loop: the host's microseconds per ``render()`` call
  (wall clock around a burst of calls that waits for nothing; the device
  is synchronised between bursts, and a burst's launches fit the launch
  queue) and the ms/frame of the same bursts from CUDA events, medians
  over the bursts;
* the same path through ``render_burst`` (still) or ``render_sequence``
  (moving): ms/frame from CUDA events, median over bursts of 12 after a
  warm one that captures the graphs;
* for each of the two, from one ``torch.profiler`` range of 12 further
  frames (``app/profile.py`` ``profile_range``): the device time a frame
  (the union of its activities), the busy share (device time over the
  range's wall time) and the device activities (kernels, copies, fills)
  a frame.

The loop renders the path's first 213 frames and profiles the next 12;
the sequence renders its first 60 (the last 12 profiled): on a moving
path the two see other positions, so compare each across trees.

Without ``--compare``, one process measures ``--tree`` (default: the
tree this file is in).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = (
    ("config 2", "menger", 1280, 720, "static", 0),
    ("config 3", "chr_knight", 1280, 720, "orbit", 0),
    ("config 4", "monu9", 1920, 1080, "dolly", 2),
    ("config 5", "castle", 3840, 2160, "static", 0),
)
WARMUP, BURSTS, FRAMES = 3, 7, 30
SEQ_BURSTS, SEQ_FRAMES = 3, 12


def _events():
    import torch

    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _profiled(advance, device, n):
    """Device ms a frame, busy share and device activities a frame of
    ``advance()`` (``n`` frames) under one profiled range."""
    from voxtracer_torch.app.profile import profile_range

    wall_us, dev, busy_us = profile_range(advance, device)
    return {"device_ms": busy_us / 1e3 / n, "busy_share": busy_us / wall_us,
            "activities": len(dev) / n}


def measure(tree: str, label: str):
    sys.path.insert(0, tree)
    import torch
    from voxtracer_torch.app import camera_paths
    from voxtracer_torch.engine.pipeline import Renderer
    from voxtracer_torch.engine.scene import load_scene

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for config, scene_name, w, h, path_name, radius in CONFIGS:
        scene = load_scene(scene_name)
        path = camera_paths.PATHS[path_name](scene)
        kw = dict(scene=scene, height=h, width=w, device="cuda",
                  denoise_radius=radius, lean=True)
        r = Renderer(**kw)
        n_loop = WARMUP + BURSTS * FRAMES
        cams = [path(i / 30.0) for i in range(
            max(n_loop + SEQ_FRAMES, (SEQ_BURSTS + 2) * SEQ_FRAMES))]
        for cam in cams[:WARMUP]:
            r.render(cam)
        torch.cuda.synchronize()
        host_us, frame_ms = [], []
        for b in range(BURSTS):
            burst = cams[WARMUP + b * FRAMES:WARMUP + (b + 1) * FRAMES]
            start, end = _events()
            start.record()
            t0 = time.perf_counter()
            for cam in burst:
                r.render(cam)
            host_us.append((time.perf_counter() - t0) / FRAMES * 1e6)
            end.record()
            end.synchronize()
            frame_ms.append(start.elapsed_time(end) / FRAMES)
        loop_prof = _profiled(
            lambda: [r.render(c) for c in cams[n_loop:n_loop + SEQ_FRAMES]],
            r.device, SEQ_FRAMES)

        # the same path through the export path, one host call a burst
        seq = Renderer(**kw)
        still = path_name == "static"

        def run_seq(i):
            part = cams[i * SEQ_FRAMES:(i + 1) * SEQ_FRAMES]
            if still:
                seq.render_burst(part[0], SEQ_FRAMES)
            else:
                seq.render_sequence(part)

        run_seq(0)  # captures the graphs
        torch.cuda.synchronize()
        seq_ms = []
        for b in range(1, SEQ_BURSTS + 1):
            start, end = _events()
            start.record()
            run_seq(b)
            end.record()
            end.synchronize()
            seq_ms.append(start.elapsed_time(end) / SEQ_FRAMES)
        seq_prof = _profiled(lambda: run_seq(SEQ_BURSTS + 1), seq.device,
                             SEQ_FRAMES)
        print(json.dumps({
            "tree": label, "config": config,
            "size": f"{w}x{h}", "path": path_name, "radius": radius,
            "host_us_per_render": statistics.median(host_us),
            "host_us_bursts": host_us,
            "ms_per_frame": statistics.median(frame_ms),
            "ms_bursts": frame_ms, "loop_profiled": loop_prof,
            "sequence_ms_per_frame": statistics.median(seq_ms),
            "sequence_ms_bursts": seq_ms, "sequence_profiled": seq_prof,
            "device": smi,
        }), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--tree", default=HERE)
    p.add_argument("--label", default="this")
    p.add_argument("--compare", metavar="OTHER_TREE")
    args = p.parse_args(argv)
    if not args.compare:
        measure(os.path.abspath(args.tree), args.label)
        return 0
    other = os.path.abspath(args.compare)
    for tree, label in ((other, "other"), (HERE, "this"), (HERE, "this"),
                        (other, "other")):
        subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree,
             "--label", label], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
