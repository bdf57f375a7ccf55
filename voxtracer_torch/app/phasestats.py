"""Per-phase ray counts of one traced sample.

Counterpart of :mod:`voxtracer.app.phasestats` for what the port's trace
counts: the rays entering each traversal phase [b0, s0, b1, s1, b2, s2]
(bounce and shadow phases of the 3 bounces, image pixels only), from
the trace's ``rays`` output (the CUDA kernel's per-phase counters on the
card, the plain version's on the CPU).  One sample with the white-noise
buffer of seed 7 at frame 1, as the reference renders it.  The exact
Mrays/s numerator of the BASELINE harness (``app/bench.py``).

The reference's serve, utilization and live-decay columns, ``--cfg`` and
``--floor`` measure the TPU kernel's lane queues and knobs and have no
counterpart; per-phase step counts would need new counters in the trace
kernel.

Run: python -m voxtracer_torch.app.phasestats --scene menger \\
         --size 1280x720 --pos 36,34,-5 --dir=-16,-14,25 [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..engine.camera import Camera
from ..engine.params import RenderParams, pack_trace_params
from ..engine.scene import SceneTables, load_scene
from ..ops import trace as trace_op
from ..ops.noise import white_noise_buffer
from . import camera_paths

PHASES = ["b0", "s0", "b1", "s1", "b2", "s2"]


def render_one_sample(scene, cam, h, w, device):
    """One traced sample (white noise, seed 7, frame 1) on ``device``:
    the trace's output dict."""
    noise = torch.from_numpy(white_noise_buffer(seed=7)).to(device)
    return trace_op.render_sample(
        SceneTables(scene, device),
        pack_trace_params(cam.rows(w, h), RenderParams()),
        noise, 1, h, w,
    )


def phase_stats(scene, cam, h, w, device):
    """One traced sample's per-phase rows: ``{"phase", "rays"}``."""
    rays = render_one_sample(scene, cam, h, w, device)["rays"].tolist()
    return [dict(phase=name, rays=float(n)) for name, n in zip(PHASES, rays)]


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--scene", default="menger")
    p.add_argument("--size", default="1280x720", help="WxH")
    p.add_argument("--pos", default=None, help="camera position x,y,z")
    p.add_argument("--dir", default=None, help="camera direction x,y,z")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    w, h = (int(v) for v in args.size.lower().split("x"))
    scene = load_scene(args.scene)
    if args.pos:
        cam = Camera(
            position=np.array([float(v) for v in args.pos.split(",")]),
            direction=np.array(
                [float(v) for v in (args.dir or "0,0,1").split(",")]
            ),
        )
    else:
        cam = camera_paths.static(scene)(0.0)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False")
    rows = phase_stats(scene, cam, h, w, device)
    print(f"# {args.scene} {w}x{h} on {device}")
    print(f"{'phase':>6} {'rays':>12} {'Mrays':>8}")
    for r in rows:
        print(f"{r['phase']:>6} {r['rays']:12.0f} {r['rays'] / 1e6:8.3f}")
    total = sum(r["rays"] for r in rows)
    print(f"{'total':>6} {total:12.0f} {total / 1e6:8.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
