"""The frame's stages after the trace, in plain torch: the still blend,
the reprojecting blend with its bilinear history fetch, the
cross-bilateral denoise, the albedo modulate and the u8 sRGB encode.

The benchmark's copies of the port's plain versions (``ops/temporal.py``
``_blend_still`` and ``_blend_reproject``, ``ops/reproject.py``
``resample_plain``, ``ops/denoise.py`` ``denoise_plain`` and
``_modulate``, ``ops/tonemap.py``), in their operation order.  One
change: the still blend takes each pixel's column and row (``px``,
``py``), so that it blends a list of pixels as well as a whole frame.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .trace import _div, _max0, _norm_div3, as_f32, sqrt_f32


def _ray_planes(px, py, cam):
    """The unit ray of each pixel of a (4, 3) camera (Python floats)."""
    _, r, u, f = cam
    x = px * r[0] - py * u[0] + f[0]
    y = px * r[1] - py * u[1] + f[1]
    z = px * r[2] - py * u[2] + f[2]
    n = sqrt_f32(x * x + y * y + z * z)
    return x / n, y / n, z / n


def blend_still(sampled_color, normal, depth, old_color, old_blend,
                old_depth, px, py, cam, old_cam, tp, history_valid: bool):
    """The still blend of pixels at columns ``px`` and rows ``py``
    (float32, the shape of ``depth``; colour planes lead with 3).
    ``cam``, ``old_cam``: (4, 3) float32 numpy.  Returns ``(blended,
    next_blending)``."""
    cam = [[float(v) for v in r] for r in np.asarray(cam, np.float32)]
    old_cam = [[float(v) for v in r] for r in np.asarray(old_cam, np.float32)]
    one = np.float32(1.0)
    cutoff = as_f32(tp.blending_distance_cutoff)
    keep_sample = as_f32(one - np.float32(tp.sample_blending))
    keep_floor = as_f32(one - np.float32(tp.maximum_blending))
    origin, o_origin = cam[0], old_cam[0]

    rx, ry, rz = _ray_planes(px, py, cam)
    wx = origin[0] + depth * rx
    wy = origin[1] + depth * ry
    wz = origin[2] + depth * rz

    orx, ory, orz = _ray_planes(px, py, old_cam)
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
    same_position = dist < bias * cutoff * depth

    valid = same_position & (depth >= 0) & bool(history_valid)
    use_color = torch.where(valid[None], old_color, 0.0)
    blending = torch.where(valid, old_blend, 1.0)
    blended = torch.where(
        (depth >= 0)[None],
        use_color * (1.0 - blending[None]) + sampled_color * blending[None],
        sampled_color,
    )
    next_blending = torch.clamp(keep_sample * blending, keep_floor, 1.0)
    return blended, next_blending


def _tap_index(v: torch.Tensor, n: int) -> torch.Tensor:
    """A whole-float tap coordinate -> int index clamped to [0, n - 1]."""
    i = torch.clamp(v, -1.0, float(n)).to(torch.int32)
    return torch.clamp(i, 0, n - 1)


def resample(hist, px_f, py_f):
    """Bilinear fetch of the (C, H, W) planes ``hist`` at pixel
    coordinates, clamp-to-edge, at pixel centres."""
    channels, height, width = hist.shape
    xf = px_f - 0.5
    yf = py_f - 0.5
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    tx = xf - x0
    ty = yf - y0
    flat = hist.reshape(channels, height * width)

    def fetch(xi, yi):
        idx = _tap_index(yi, height) * width + _tap_index(xi, width)
        return flat[:, idx.long()]

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    top = c00 * (1 - tx) + c10 * tx
    bot = c01 * (1 - tx) + c11 * tx
    return top * (1 - ty) + bot * ty


def blend_reproject(sampled_color, normal, depth, old_color, old_blend,
                    old_depth, params: np.ndarray):
    """The reprojecting blend of a whole (H, W) frame against its whole
    history; ``params``: :func:`benchmark.reference.params.
    pack_temporal_params`.  Returns ``(blended, next_blending)``."""
    P = [float(v) for v in np.asarray(params, np.float32)]
    height, width = depth.shape
    dev = depth.device
    px = torch.arange(width, device=dev, dtype=torch.float32)[None, :]
    py = torch.arange(height, device=dev, dtype=torch.float32)[:, None]

    rx, ry, rz = _norm_div3(
        px * P[3] - py * P[6] + P[9],
        px * P[4] - py * P[7] + P[10],
        px * P[5] - py * P[8] + P[11],
    )
    wx = P[0] + depth * rx
    wy = P[1] + depth * ry
    wz = P[2] + depth * rz

    relx, rely, relz = wx - P[12], wy - P[13], wz - P[14]
    s0 = P[24] * relx + P[25] * rely + P[26] * relz
    s1 = P[27] * relx + P[28] * rely + P[29] * relz
    s2 = P[30] * relx + P[31] * rely + P[32] * relz
    sx = s0 / s2
    sy = s1 / s2
    tex_x = _div(sx + 0.5, float(width))
    tex_y = _div(sy - 0.5, float(-height))
    in_range = (tex_x >= 0) & (tex_x <= 1) & (tex_y >= 0) & (tex_y <= 1)

    hist = torch.cat([old_color, old_blend[None], old_depth[None]])
    hist5 = resample(hist, tex_x * width, tex_y * height)

    qx = torch.trunc(sx + 0.5)
    qy = torch.trunc(sy - 0.5)
    orx, ory, orz = _norm_div3(
        qx * P[15] + qy * P[18] + P[21],
        qx * P[16] + qy * P[19] + P[22],
        qx * P[17] + qy * P[20] + P[23],
    )
    old_nd = hist5[4]
    owx = P[12] + old_nd * orx
    owy = P[13] + old_nd * ory
    owz = P[14] + old_nd * orz

    cdx, cdy, cdz = _norm_div3(P[0] - wx, P[1] - wy, P[2] - wz)
    bias = _max0(cdx * normal[0] + cdy * normal[1] + cdz * normal[2], 0.0)
    dx, dy, dz = owx - wx, owy - wy, owz - wz
    dist = sqrt_f32(dx * dx + dy * dy + dz * dz)
    same_position = dist < bias * P[35] * depth

    valid = in_range & same_position & (depth >= 0) & (P[36] > 0.0)
    use_color = torch.where(valid[None], hist5[:3], 0.0)
    blending = torch.where(valid, hist5[3], 1.0)
    blended = torch.where(
        (depth >= 0)[None],
        use_color * (1.0 - blending[None]) + sampled_color * blending[None],
        sampled_color,
    )
    next_blending = torch.clamp(
        as_f32(np.float32(1.0) - np.float32(P[33])) * blending,
        as_f32(np.float32(1.0) - np.float32(P[34])),
        1.0,
    )
    return blended, next_blending


def _sigma2(sigma: float) -> float:
    """2 * sigma**2 rounded in float32."""
    s = np.float32(sigma)
    return float(np.float32(2.0) * (s * s))


def modulate(out, albedo, factor: float):
    """out * (1 - f + f * albedo)."""
    f = np.float32(factor)
    return out * (float(np.float32(1.0) - f) + float(f) * albedo)


def denoise(colors, normal, depth, albedo, node, params: np.ndarray,
            radius: int):
    """The (2r+1)^2 cross-bilateral stencil over a whole frame (zero
    padding, dy outer / dx inner), then the modulate; ``params``:
    :func:`benchmark.reference.params.pack_denoise_params`."""
    P = [float(v) for v in np.asarray(params, np.float32)]
    height, width = depth.shape
    dev = depth.device
    r = int(radius)
    px = torch.arange(width, device=dev, dtype=torch.float32)[None, :]
    py = torch.arange(height, device=dev, dtype=torch.float32)[:, None]
    rx, ry, rz = _norm_div3(
        px * P[3] - py * P[6] + P[9],
        px * P[4] - py * P[7] + P[10],
        px * P[5] - py * P[8] + P[11],
    )
    depth_bias = _max0(normal[0] * -rx + normal[1] * -ry + normal[2] * -rz,
                       0.0)
    sigma_d2 = _sigma2(P[12])
    sigma_r2 = _sigma2(P[13])

    log_depth = torch.log(torch.abs(depth))
    mat_id = node >> 24

    def pad(a):
        return F.pad(a, (r, r, r, r))

    p_color = pad(colors)
    p_normal = pad(normal)
    p_logd = pad(log_depth)
    p_mat = pad(mat_id)
    p_valid = pad(torch.ones_like(depth))
    norm_sum = torch.zeros_like(depth)
    color_sum = torch.zeros_like(colors)
    for dy in range(-r, r + 1):
        rows = slice(r + dy, r + dy + height)
        for dx in range(-r, r + 1):
            cols = slice(r + dx, r + dx + width)
            w_color = p_color[:, rows, cols]
            w_normal = p_normal[:, rows, cols]
            cd = colors - w_color
            nd = normal - w_normal
            dd = log_depth - p_logd[rows, cols]
            md = (mat_id != p_mat[rows, cols]).to(torch.float32)
            bd = depth_bias * dd
            factor_range = _div(
                cd[0] * cd[0] + cd[1] * cd[1] + cd[2] * cd[2]
                + 1e4 * (nd[0] * nd[0] + nd[1] * nd[1] + nd[2] * nd[2])
                + 1e4 * (bd * bd)
                + 1e4 * md,
                sigma_r2,
            )
            factor_dist = float(np.float32(dx * dx + dy * dy)
                                / np.float32(sigma_d2))
            f = torch.exp(-factor_range - factor_dist) * p_valid[rows, cols]
            norm_sum = norm_sum + f
            color_sum = color_sum + f[None] * w_color
    return modulate(color_sum / norm_sum[None], albedo, P[14])


def to_u8(linear: torch.Tensor) -> torch.Tensor:
    """Planar (3, ...) linear colour -> channels-last u8 sRGB."""
    c = torch.clamp(linear, 0.0, 1.0)
    srgb = torch.where(c <= 0.0031308, 12.92 * c,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)
    return torch.movedim(torch.round(srgb * 255.0).to(torch.uint8), 0, -1)
