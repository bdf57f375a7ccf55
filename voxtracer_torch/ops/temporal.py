"""Temporal accumulation for a camera at rest.

Counterpart of ``voxtracer.ops.temporal.temporal_blend_still_planar``
(``temporal.comp:99-124`` with the identity reprojection): elementwise
over (3, H, W) planes, in the same operation order.  The moving-camera
blend needs the reprojection kernel (ROADMAP Queue 2 #2) and is not
part of this module yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .trace import as_f32, sqrt_f32


def temporal_blend_still_planar(
    sampled_color: torch.Tensor,  # (3, H, W) current trace output
    normal: torch.Tensor,  # (3, H, W) current first-hit normals
    depth: torch.Tensor,  # (H, W) current first-hit depth
    old_color: torch.Tensor,  # (3, H, W) history color
    old_blend: torch.Tensor,  # (H, W) history blending (alpha)
    old_depth: torch.Tensor,  # (H, W) history depth
    cam: np.ndarray,  # (4, 3) f32: origin, right, up, forward (scaled)
    old_cam: np.ndarray,  # (4, 3) f32
    params,  # TemporalParams
    history_valid: bool,
):
    """Returns ``(blended (3, H, W), next_blending (H, W))``."""
    height, width = depth.shape
    origin, right, up, forward = ([float(v) for v in r] for r in cam)
    o_origin, o_right, o_up, o_forward = ([float(v) for v in r] for r in old_cam)
    dev = depth.device
    px = torch.arange(width, device=dev, dtype=torch.float32)[None, :]
    py = torch.arange(height, device=dev, dtype=torch.float32)[:, None]

    def ray_planes(r, u, f):
        x = px * r[0] - py * u[0] + f[0]
        y = px * r[1] - py * u[1] + f[1]
        z = px * r[2] - py * u[2] + f[2]
        n = sqrt_f32(x * x + y * y + z * z)
        return x / n, y / n, z / n

    rx, ry, rz = ray_planes(right, up, forward)
    wx = origin[0] + depth * rx
    wy = origin[1] + depth * ry
    wz = origin[2] + depth * rz

    orx, ory, orz = ray_planes(o_right, o_up, o_forward)
    owx = o_origin[0] + old_depth * orx
    owy = o_origin[1] + old_depth * ory
    owz = o_origin[2] + old_depth * orz

    cdx = origin[0] - wx
    cdy = origin[1] - wy
    cdz = origin[2] - wz
    cn = sqrt_f32(cdx * cdx + cdy * cdy + cdz * cdz)
    bias = torch.clamp_min(
        (cdx / cn) * normal[0] + (cdy / cn) * normal[1] + (cdz / cn) * normal[2],
        0.0,
    )
    dx = owx - wx
    dy = owy - wy
    dz = owz - wz
    dist = sqrt_f32(dx * dx + dy * dy + dz * dz)
    same_position = dist < bias * as_f32(params.blending_distance_cutoff) * depth

    valid = same_position & (depth >= 0) & bool(history_valid)
    use_color = torch.where(valid[None], old_color, 0.0)
    blending = torch.where(valid, old_blend, 1.0)
    blended = torch.where(
        (depth >= 0)[None],
        use_color * (1.0 - blending[None]) + sampled_color * blending[None],
        sampled_color,
    )
    next_blending = torch.clamp(
        as_f32(np.float32(1.0) - np.float32(params.sample_blending)) * blending,
        as_f32(np.float32(1.0) - np.float32(params.maximum_blending)),
        1.0,
    )
    return blended, next_blending
