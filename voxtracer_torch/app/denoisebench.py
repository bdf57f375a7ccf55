"""The denoise kernel alone over the GUI's radius range: its time per
call and its share of its bound, at 1080p and 4K.  One JSON line per
(size, radius).

The GUI's denoise slider reaches r = 8, a 17x17 stencil
(``denoise.comp:64-78`` loops dy, dx over [-r, r]); this prices the whole
slider.  The stencil's work is fixed by (radius, H, W): every in-frame
tap runs for every pixel.  Its time need not be: a tap between equal
elements (as between sky pixels) divides a zero, which an IEEE division
would send down its slow path (the kernel's range quotient has none).
So the planes are random (``--planes random``, made with numpy from a seed as the JAX
package's ``voxtracer.app.denoisebench`` makes them; almost no tap is
between equal elements) or uniform (``--planes uniform``: every tap is).

Time: CUDA events around ``--reps`` calls of ``ops.denoise.denoise``
after one warm call.  ``--device cpu`` runs the plain version on the
host clock, at tiny sizes only (for the tests).

Bound (``bound_ms``): the larger of the bytes the function must move over
3.35 TB/s — 11 planes read and 3 written, 56 bytes a pixel — and its
float32 operations over 67 TFLOP/s, counted from the function's
definition (``ops/denoise.py`` ``denoise_plain``), not from any kernel's
instructions: ``FLOPS_PER_TAP`` for each tap inside the frame and
``FLOPS_PER_PX`` for each pixel around it.

Run (on the card): python -m voxtracer_torch.app.denoisebench \\
    [--radii 1,2,4,8] [--sizes 1920x1080,3840x2160] [--reps 20] \\
    [--planes random|uniform]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..engine.params import DenoiseParams, pack_denoise_params
from ..ops import denoise
from .bench import _stage_ms, device_label
from .tracebench import bound

FP32_FLOPS_PER_S = 67e12  # H100 SXM, NVIDIA's data sheet, at 700 W
# float32 operations of the function per tap of the stencil inside the
# frame, and per pixel around it
FLOPS_PER_TAP = 39
FLOPS_PER_PX = 45
# the reference tool's camera rows: position, right, up, forward
CAMERA = np.array([[0.0, 0.0, -4.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                   [0.0, 0.0, 1.0]], np.float32)


def in_frame_taps(n: int, radius: int) -> int:
    """Offsets in [-r, r] that stay inside an axis of ``n`` positions,
    summed over the positions."""
    return sum(min(i + radius, n - 1) - max(i - radius, 0) + 1
               for i in range(n))


def denoise_bound(h: int, w: int, radius: int):
    """(bound_ms, bound_by) of one denoise call on an ``h`` x ``w``
    frame."""
    flops = (FLOPS_PER_TAP * in_frame_taps(h, radius) * in_frame_taps(w, radius)
             + FLOPS_PER_PX * h * w)
    return bound(56 * h * w, flops, FP32_FLOPS_PER_S)


def make_inputs(h: int, w: int, device, seed: int = 0, planes="random"):
    """The planes (colour, normal, depth, albedo, node) and the packed
    params: random, as the reference tool makes them, or uniform."""
    if planes == "uniform":
        arrays = (*(np.full(s, 0.5, np.float32) for s in
                    ((3, h, w), (3, h, w), (h, w), (3, h, w))),
                  np.zeros((h, w), np.int32))
    else:
        rng = np.random.default_rng(seed)
        arrays = (
            rng.random((3, h, w), dtype=np.float32),
            rng.random((3, h, w), dtype=np.float32),
            rng.random((h, w), dtype=np.float32) + np.float32(0.5),
            rng.random((3, h, w), dtype=np.float32),
            rng.integers(0, 2**26, (h, w), dtype=np.int64).astype(np.int32),
        )
    return ((*(torch.from_numpy(a).to(device) for a in arrays),
             pack_denoise_params(CAMERA, DenoiseParams())))


def measure(h: int, w: int, radius: int, inputs, device, reps: int,
            planes: str = "random"):
    """One (size, radius) row: time per call, bound and share."""
    ms = _stage_ms(lambda: denoise.denoise(*inputs, radius), device, reps)
    taps = (2 * radius + 1) ** 2
    bound_ms, bound_by = denoise_bound(h, w, radius)
    return {
        "size": f"{w}x{h}", "radius": radius, "planes": planes, "taps": taps,
        "ms_per_call": ms, "us_per_tap_mpix": ms * 1e3 / taps / (h * w / 1e6),
        "bound_ms": bound_ms, "bound_by": bound_by, "share": bound_ms / ms,
        "device": device_label(device),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--radii", default="1,2,4,8")
    p.add_argument("--sizes", default="1920x1080,3840x2160")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--planes", choices=("random", "uniform"), default="random")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("denoisebench --device cuda needs a CUDA GPU")
    device = torch.device(args.device)
    radii = [int(v) for v in args.radii.split(",") if v]
    for size in args.sizes.split(","):
        w, h = (int(v) for v in size.split("x"))
        inputs = make_inputs(h, w, device, planes=args.planes)
        for r in radii:
            print(json.dumps(measure(h, w, r, inputs, device, args.reps,
                                     args.planes)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
