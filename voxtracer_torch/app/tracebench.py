"""The trace kernel alone: its time, per-phase rays and DDA steps, SIMT
efficiency and share of its bound, at the frame sizes of the port's
configs — menger 1280x720 with the bench camera, monu9 1920x1080 on the
dolly path at t=0, castle 3840x2160 with the static camera — for one
blue-noise sample at frame 1.  One JSON line per scene.

Time: CUDA events around ``REPS`` calls after one warm call (the host
clock on the CPU, where the plain version runs).  SIMT efficiency:
steps / (32 x slots), from the kernel's counters (``csrc/trace.cu``).

Bound (``bound_ms``): the larger of the bytes one sample must move over
3.35 TB/s — the G-buffer written once (44 bytes a pixel; 68 with the
steps-map instance's 6 int32 steps a pixel) and the 24 noise slices it
reads once — and the operations it needs over the card's issue rate,
33.5 T lane operations a second
(132 SMs x 4 schedulers x 32 lanes x 1.98 GHz).  The operations are
counted from the function's definition (``csrc/trace.cu``, the plain
version in ``ops/trace.py``), not from any kernel's instructions: each
arithmetic, logic, compare, select, conversion, load or store of one
lane is one, and so is each division, square root and transcendental (a
lower bound on their instructions).  They are summed over this sample's
counted work, per kind (``OPS_PER_*``); where the counters cannot tell
two kinds apart, the cheaper one is counted.  The scene tables' bytes
are left out: which of them a sample reads depends on its rays, and a
frame may read a small part of them (the scale probe's shell, 4% of
whose pixels hit), so only a bound without them is a lower bound
whatever the rays read.  At the shipped scenes their 0.04-1.21 MB are
under 3% of the G-buffer's bytes at the sizes above.

Run (on the card): python -m voxtracer_torch.app.tracebench
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..engine.camera import Camera
from ..engine.params import RenderParams, pack_trace_params
from ..engine.scene import SceneTables, load_scene
from ..ops import trace as trace_op
from ..ops.noise import blue_noise_buffer
from . import camera_paths
from .bench import _stage_ms, device_label

BENCH_POS = (36.0, 34.0, -5.0)  # bench.py's frame-filling menger view
BENCH_DIR = (-16.0, -14.0, 25.0)
SIZES = {"menger": (1280, 720), "monu9": (1920, 1080), "castle": (3840, 2160)}
REPS = 20

# The card's peaks (H100 SXM, NVIDIA's data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 33.5e12  # 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz

# Operations of one sample, per kind of counted work:
# - a DDA step: the cheaper kind, an advancing micro-DDA step (loop 2,
#   brick-bit test 14, three cell-exit distances 24, their minimum and
#   the axis choice 8, cell and t update 4, count 1, node test 9); an
#   outer step takes 64 into an occupied node and 124 across an empty
#   box (bounds 11, meta address and word 21, its test and the step
#   cap 4, then brick words 6 and hit test 22, or the box exit 88);
OPS_PER_STEP = 62
# - a traversal's start (every counted ray): inverse direction 9, slab
#   test 26, first cell 36, direction signs 9;
OPS_PER_RAY = 80
# - a hit's point and normal, counted for the rays of b1, b2 and s2
#   (each starts at a hit of the phase before);
OPS_PER_HIT = 35
# - a pixel: primary ray 14 and its normalisation 9, noise index 4,
#   colour division 3, 11 G-buffer stores, albedo 15;
OPS_PER_PIXEL = 56
# - shading a hit whose path goes on (the rays of b1 and b2): palette
#   read and colour 13, emission 12, 8 noise reads 40, sun direction and
#   cosine 75, the next direction 28 (the cheaper of reflection and
#   hemisphere sample), blend 9, the path's selects 10;
OPS_PER_BOUNCE = 187
# - shading a last-bounce hit: colour and emission 25, 5 noise reads 25,
#   sun direction and cosine 75; counted for the rays of s2, each cast
#   from such a hit.
OPS_PER_LAST_HIT = 125


def bound(nbytes, ops, rate):
    """(bound_ms, bound_by): the larger of ``nbytes`` over the memory
    rate and ``ops`` over ``rate`` (operations a second)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def trace_ops(rays, steps, h, w):
    """The operations one sample needs, from its per-phase ``rays`` and
    ``steps`` [b0, s0, b1, s1, b2, s2] (arrays or tensors)."""
    rays = [int(n) for n in rays]
    b1, b2, s2 = rays[2], rays[4], rays[5]
    return (OPS_PER_STEP * sum(int(n) for n in steps)
            + OPS_PER_RAY * sum(rays)
            + OPS_PER_HIT * (b1 + b2 + s2) + OPS_PER_PIXEL * h * w
            + OPS_PER_BOUNCE * (b1 + b2) + OPS_PER_LAST_HIT * s2)


def trace_bound(out, h, w, n_slices):
    """(bound_ms, bound_by) of one traced sample from its output: its
    counters, and its ``steps_map`` where the steps-map instance wrote
    one (24 bytes a pixel more)."""
    per_px = 44 + (4 * trace_op.N_PHASES if "steps_map" in out else 0)
    nbytes = per_px * h * w + min(24, n_slices) * 128 * 128 * 4
    return bound(nbytes, trace_ops(out["rays"], out["steps"], h, w),
                 LANE_OPS_PER_S)


def cases(names=tuple(SIZES), scale=1.0):
    """(name, scene, camera, width, height) of each scene in ``names``,
    its size scaled by ``scale``."""
    for name in names:
        scene = load_scene(name)
        if name == "menger":
            cam = Camera(position=np.array(BENCH_POS),
                         direction=np.array(BENCH_DIR))
        elif name == "monu9":
            cam = camera_paths.dolly(scene)(0.0)
        else:
            cam = camera_paths.static(scene)(0.0)
        w, h = (max(8, round(v * scale)) for v in SIZES[name])
        yield name, scene, cam, w, h


def measure(name, scene, cam, w, h, device, reps):
    """One scene's row: time, counters, SIMT efficiency, bound, share."""
    tables = SceneTables(scene, device)
    noise = torch.from_numpy(blue_noise_buffer()).to(device)
    args = (tables, pack_trace_params(cam.rows(w, h), RenderParams()),
            noise, 1, h, w)
    out = {k: v.cpu().numpy() for k, v in
           trace_op.render_sample(*args).items()
           if k in ("rays", "steps", "slots")}
    ms = _stage_ms(lambda: trace_op.render_sample(*args), device, reps)
    bound_ms, bound_by = trace_bound(out, h, w, noise.shape[0])
    steps = int(out["steps"].sum())
    slots = int(out["slots"][0]) if "slots" in out else None
    return {
        "scene": name, "width": w, "height": h, "ms": ms,
        "rays": out["rays"].tolist(), "steps": out["steps"].tolist(),
        "slots": slots,
        "simt_efficiency": steps / (32 * slots) if slots else None,
        "ops": trace_ops(out["rays"], out["steps"], h, w),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "share": bound_ms / ms, "device": device_label(device),
    }


def main(argv=None):
    argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    ).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tracebench needs a CUDA GPU")
    for case in cases():
        print(json.dumps(measure(*case, torch.device("cuda"), REPS)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
