"""Per-phase ray and step counts of one traced sample.

Counterpart of :mod:`voxtracer.app.phasestats` for what the port's trace
counts: the rays entering each traversal phase [b0, s0, b1, s1, b2, s2]
(bounce and shadow phases of the 3 bounces, image pixels only) and the
DDA steps they took (outer steps plus advancing micro-DDA steps), from
the trace's ``rays`` and ``steps`` outputs (the CUDA kernel's counters
on the card, the plain version's on the CPU; equal on b0, s0, b1).  One
sample with the white-noise buffer of seed 7 at frame 1, as the
reference renders it.  The exact Mrays/s numerator of the BASELINE
harness (``app/bench.py``).

``--decay`` adds the live-decay curve of each phase, the reference's
columns ``t75 t50 t25 t12 t03``: the share of a phase's warp trips on
which at least 24, 16, 8, 4 and 1 of a warp's 32 lanes were still
marching (``ops/trace.py`` ``warp_decay``, from each pixel's steps: the
kernel's steps-map instance on the card, the plain version on the CPU).
A warp's trips are its largest lane's steps, as ``slots`` counts them;
the reference's tiles refill lanes from ray queues, so its curve is
another statistic of another machine.

The reference's serve and utilization columns, ``--cfg``, ``--floor``
and ``--interpret`` measure the TPU kernel's lane queues, knobs and
interpreter and have no counterpart.

Run: python -m voxtracer_torch.app.phasestats --scene menger \\
         --size 1280x720 --pos 36,34,-5 --dir=-16,-14,25 [--decay]
         [--device cuda]
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


def render_one_sample(scene, cam, h, w, device, decay=False):
    """One traced sample (white noise, seed 7, frame 1) on ``device``:
    the trace's output dict (with ``steps_map`` where ``decay``)."""
    noise = torch.from_numpy(white_noise_buffer(seed=7)).to(device)
    render = trace_op.render_sample_steps if decay else trace_op.render_sample
    return render(
        SceneTables(scene, device),
        pack_trace_params(cam.rows(w, h), RenderParams()),
        noise, 1, h, w,
    )


def phase_stats(scene, cam, h, w, device, decay=False):
    """One traced sample's per-phase rows: ``{"phase", "rays", "steps"}``,
    with ``decay`` also ``trips`` and the decay columns
    (``ops/trace.py`` ``warp_decay``)."""
    out = render_one_sample(scene, cam, h, w, device, decay)
    rows = [dict(phase=name, rays=float(n), steps=float(k))
            for name, n, k in zip(PHASES, out["rays"].tolist(),
                                  out["steps"].tolist())]
    if decay:
        for row, curve in zip(rows, trace_op.warp_decay(out["steps_map"])):
            row.update(curve)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--scene", default="menger")
    p.add_argument("--size", default="1280x720", help="WxH")
    p.add_argument("--pos", default=None, help="camera position x,y,z")
    p.add_argument("--dir", default=None, help="camera direction x,y,z")
    p.add_argument("--decay", action="store_true",
                   help="also print each phase's live-decay curve")
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
    rows = phase_stats(scene, cam, h, w, device, args.decay)
    qcols = trace_op.DECAY_COLUMNS if args.decay else ()
    print(f"# {args.scene} {w}x{h} on {device}")
    print(f"{'phase':>6} {'rays':>12} {'Mrays':>8} {'steps':>12} "
          f"{'steps/ray':>9}"
          + (f" {'trips':>10}" if qcols else "")
          + "".join(f" {c:>6}" for c in qcols))
    for r in rows + [dict(phase="total", rays=sum(r["rays"] for r in rows),
                          steps=sum(r["steps"] for r in rows))]:
        per_ray = r["steps"] / r["rays"] if r["rays"] else 0.0
        print(f"{r['phase']:>6} {r['rays']:12.0f} {r['rays'] / 1e6:8.3f} "
              f"{r['steps']:12.0f} {per_ray:9.2f}"
              + (f" {r['trips']:10d}" if qcols and "trips" in r else "")
              + "".join(f" {r[c]:6.1%}" for c in qcols if c in r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
