"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes each stage of a frame needs, counted from the
definitions of the stages (the reference in ``benchmark/reference``)
and the frame's data, never from a kernel's own counters.

Copies of the port's ``app/tracebench.py`` (``trace_ops``, the
per-kind operation counts and the G-buffer bytes), ``app/denoisebench.py``
(``denoise_bound``) and ``app/renderbench.py`` (``still_bytes``,
``encode_bytes``); the temporal kernel's 64 bytes a pixel are the
port's count of its planes (PERF.md, kernel 2).
"""

from __future__ import annotations

import numpy as np
import torch

# The card's peaks (H100 SXM, NVIDIA's data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 33.5e12  # 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz
FP32_FLOPS_PER_S = 67e12

# Operations of one trace sample, per kind of counted work (see the
# port's app/tracebench.py for each term's breakdown):
OPS_PER_STEP = 62  # a DDA step, the cheaper kind
OPS_PER_RAY = 80  # a traversal's start
OPS_PER_HIT = 35  # a hit's point and normal (rays of b1, b2, s2)
OPS_PER_PIXEL = 56  # primary ray, noise index, G-buffer stores, albedo
OPS_PER_BOUNCE = 187  # shading a hit whose path goes on (b1, b2)
OPS_PER_LAST_HIT = 125  # shading a last-bounce hit (s2)
GBUF_BYTES_PER_PX = 44  # colour, normal, albedo, depth, node written once
NOISE_SLICE_BYTES = 128 * 128 * 4
NOISE_SLICES_PER_FRAME = 24

# The denoise function's float32 operations per in-frame tap and per
# pixel, and its bytes a pixel (11 planes read, 3 written)
DENOISE_FLOPS_PER_TAP = 39
DENOISE_FLOPS_PER_PX = 45
DENOISE_BYTES_PER_PX = 56
# The reprojecting blend: 7 planes read at the pixel (colour, normal,
# depth), 5 history planes fetched, 4 written (blend, next blend)
TEMPORAL_BYTES_PER_PX = 64


def least_s(nbytes: float, ops: float, rate: float) -> float:
    """The least seconds: the larger of ``nbytes`` over the memory rate
    and ``ops`` over ``rate`` (operations a second)."""
    return max(nbytes / HBM_BYTES_PER_S, ops / rate)


def trace_ops(rays, steps, pixels: int) -> int:
    """The operations of traced samples from their per-phase ``rays``
    and ``steps`` [b0, s0, b1, s1, b2, s2] over ``pixels`` pixels."""
    rays = [int(n) for n in rays]
    b1, b2, s2 = rays[2], rays[4], rays[5]
    return (OPS_PER_STEP * sum(int(n) for n in steps)
            + OPS_PER_RAY * sum(rays)
            + OPS_PER_HIT * (b1 + b2 + s2) + OPS_PER_PIXEL * pixels
            + OPS_PER_BOUNCE * (b1 + b2) + OPS_PER_LAST_HIT * s2)


def trace_least_s(rays, steps, pixels: int, frames: int) -> float:
    """The least seconds of ``frames`` traced frames of ``pixels``
    pixels in all, from the reference's rays and steps over them: the
    G-buffer written once and each frame's noise slices read once, or
    the operations over the lane rate.  The scene tables' bytes are left
    out (which of them a frame reads depends on its rays)."""
    nbytes = (GBUF_BYTES_PER_PX * pixels
              + frames * NOISE_SLICES_PER_FRAME * NOISE_SLICE_BYTES)
    return least_s(nbytes, trace_ops(rays, steps, pixels), LANE_OPS_PER_S)


def in_frame_taps(n: int, radius: int) -> int:
    """Offsets in [-r, r] that stay inside an axis of ``n`` positions,
    summed over the positions."""
    return sum(min(i + radius, n - 1) - max(i - radius, 0) + 1
               for i in range(n))


def denoise_least_s(h: int, w: int, radius: int) -> float:
    flops = (DENOISE_FLOPS_PER_TAP * in_frame_taps(h, radius)
             * in_frame_taps(w, radius) + DENOISE_FLOPS_PER_PX * h * w)
    return least_s(DENOISE_BYTES_PER_PX * h * w, flops, FP32_FLOPS_PER_S)


def temporal_least_s(h: int, w: int) -> float:
    return TEMPORAL_BYTES_PER_PX * h * w / HBM_BYTES_PER_S


def still_bytes(depth: torch.Tensor, kept: torch.Tensor, history_valid: bool,
                albedo: bool = True, linear: bool = False) -> int:
    """What the still epilogue must move on this frame's data: every
    pixel reads colour and depth and writes blend and next blend (with
    albedo it also reads the albedo and writes the u8 image and, with the
    linear, the linear); a hit with live history also reads the normal
    and the old depth, and a pixel that keeps its history also reads the
    old colour and old blend."""
    n = depth.numel()
    tested = int((depth >= 0).sum()) if history_valid else 0
    nbytes = (4 * 4 + 4 * 4) * n + 16 * tested + 16 * int(kept.sum())
    if albedo:
        nbytes += (4 * 3 + 3 + (4 * 3 if linear else 0)) * n
    return nbytes


def encode_bytes(h: int, w: int, albedo: bool, linear: bool = False) -> int:
    """What the encode must move: 3 float32 planes read (3 more with the
    albedo), the u8 image written (and the modulated linear)."""
    return (4 * 3 + (4 * 3 if albedo else 0) + 3
            + (4 * 3 if albedo and linear else 0)) * h * w


def still_kept(normal, depth, old_depth, cam, old_cam, tp, history_valid):
    """Where the still blend keeps the history: the blend of white over
    black history with old blend 2, which is 2 exactly there."""
    from .reference import stages

    h, w = depth.shape
    dev = depth.device
    px = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    py = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    ones = torch.ones((3, h, w), device=dev)
    blended, _ = stages.blend_still(
        ones, normal, depth, torch.zeros_like(ones), torch.full_like(depth, 2.0),
        old_depth, px, py, np.asarray(cam), np.asarray(old_cam), tp,
        history_valid)
    return blended[0] == 2.0
