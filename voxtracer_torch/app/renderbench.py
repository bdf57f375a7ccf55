"""What one ``Renderer.render()`` call costs the host, in two trees.

    python voxtracer_torch/app/renderbench.py --compare OTHER_TREE

renders configs 2, 3 and 4 (menger 1280x720 still r=0, chr_knight
1280x720 orbit r=0, monu9 1920x1080 dolly r=2) with the per-frame loop
in four fresh processes, in turns: OTHER_TREE, this tree, this tree,
OTHER_TREE (a checkout of another commit that holds a ``voxtracer_torch``
package).  Each process prints one JSON line a config: the host's
microseconds per ``render()`` call (wall clock around a burst of calls
that waits for nothing; the device is synchronised between bursts, and
a burst's launches fit the launch queue) and the ms/frame of the same
bursts from CUDA events.  Medians over the bursts.  Without
``--compare``, one process measures ``--tree`` (default: the tree this
file is in).
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
)
WARMUP, BURSTS, FRAMES = 3, 7, 30


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
        r = Renderer(scene=scene, height=h, width=w, device="cuda",
                     denoise_radius=radius, lean=True)
        cams = [path(i / 30.0) for i in range(WARMUP + BURSTS * FRAMES)]
        for cam in cams[:WARMUP]:
            r.render(cam)
        torch.cuda.synchronize()
        host_us, frame_ms = [], []
        for b in range(BURSTS):
            burst = cams[WARMUP + b * FRAMES:WARMUP + (b + 1) * FRAMES]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for cam in burst:
                r.render(cam)
            host_us.append((time.perf_counter() - t0) / FRAMES * 1e6)
            end.record()
            end.synchronize()
            frame_ms.append(start.elapsed_time(end) / FRAMES)
        print(json.dumps({
            "tree": label, "config": config,
            "host_us_per_render": statistics.median(host_us),
            "host_us_bursts": host_us,
            "ms_per_frame": statistics.median(frame_ms),
            "ms_bursts": frame_ms, "device": smi,
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
