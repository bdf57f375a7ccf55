"""Denoise stage: the cross-bilateral stencil and the albedo modulate.

Counterpart of ``voxtracer.ops.denoise_pallas.denoise``.  Radius 0 (the
Renderer default) is the albedo remodulation alone
(``denoise.comp:90``), elementwise plain torch on any device.  For
radius r >= 1 a (2r+1)^2 cross-bilateral stencil runs first:

* :func:`denoise_plain` — the stencil of ``voxtracer.ops.denoise.denoise``
  (zero padding, shifted slices, dy outer / dx inner, ``material >> 24``,
  ``log|depth|``) followed by the Pallas kernel's modulation
  ``out * (1 - f + f * albedo)`` (``denoise_pallas.py:228-237``).  Planar
  (3, H, W).  The CPU path and the reference for the kernel.
* :func:`denoise_cuda` — the hand-written kernel ``csrc/denoise.cu``,
  which replaces the Pallas kernel ``denoise_pallas._make_kernel``.
* :func:`denoise` — radius 0, or one of the two by the tensors' device.

All read the (16,) vector of ``engine.params.pack_denoise_params``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.params import DENOISE_PARAMS_LEN, check_params
from .trace import _div, _max0, _norm_div3


def _check_inputs(colors, normal, depth, albedo, node, radius):
    height, width = depth.shape
    for name, t, shape, dtype in (
        ("colors", colors, (3, height, width), torch.float32),
        ("normal", normal, (3, height, width), torch.float32),
        ("depth", depth, (height, width), torch.float32),
        ("albedo", albedo, (3, height, width), torch.float32),
        ("node", node, (height, width), torch.int32),
    ):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"{name} must be {shape} {dtype}, got {tuple(t.shape)} "
                f"{t.dtype}"
            )
        if t.device != depth.device:
            raise ValueError(f"{name} on {t.device}, depth on {depth.device}")
    if radius < 1:
        raise ValueError(f"the stencil needs radius >= 1, got {radius}")


def _sigma2(sigma: float) -> float:
    """2 * sigma**2 rounded in float32, as the reference computes it."""
    s = np.float32(sigma)
    return float(np.float32(2.0) * (s * s))


def _modulate(out, albedo, factor: float):
    """out * (1 - f + f * albedo) (denoise_pallas.py:228-237)."""
    f = np.float32(factor)
    return out * (float(np.float32(1.0) - f) + float(f) * albedo)


def denoise_plain(
    colors: torch.Tensor,  # (3, H, W) temporally blended color
    normal: torch.Tensor,  # (3, H, W) first-hit normals
    depth: torch.Tensor,  # (H, W) first-hit depth (-1 on a miss)
    albedo: torch.Tensor,  # (3, H, W)
    node: torch.Tensor,  # (H, W) int32 first-hit node (top 8 bits compared)
    params: np.ndarray,  # (16,) f32, engine.params.pack_denoise_params
    radius: int,
) -> torch.Tensor:
    """The (2r+1)^2 stencil with plain torch ops, then the modulate."""
    _check_inputs(colors, normal, depth, albedo, node, radius)
    P = [float(v) for v in check_params(params, DENOISE_PARAMS_LEN)]
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
    return _modulate(color_sum / norm_sum[None], albedo, P[14])


def denoise_cuda(
    colors: torch.Tensor,
    normal: torch.Tensor,
    depth: torch.Tensor,
    albedo: torch.Tensor,
    node: torch.Tensor,
    params: np.ndarray,
    radius: int,
) -> torch.Tensor:
    """The same stencil and modulate from the hand-written CUDA kernel
    (csrc/denoise.cu).  Launches on the current stream and does not
    synchronise.  Raises if an input is not what the kernel takes or the
    launch is refused."""
    _check_inputs(colors, normal, depth, albedo, node, radius)
    params = check_params(params, DENOISE_PARAMS_LEN)
    if depth.device.type != "cuda":
        raise ValueError(f"CUDA kernel given tensors on {depth.device}")
    ins = (colors, normal, depth, albedo, node)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("denoise inputs must be contiguous")
    from . import _build

    launch = _build.load().vt_denoise_launch
    height, width = depth.shape
    out = torch.empty_like(colors)
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        err = launch(
            params.ctypes.data,
            *(t.data_ptr() for t in ins),
            height,
            width,
            int(radius),
            out.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"denoise kernel launch failed: cudaError {err}")
    denoise_cuda.launches += 1
    return out


denoise_cuda.launches = 0


def denoise(
    colors: torch.Tensor,
    normal: torch.Tensor,
    depth: torch.Tensor,
    albedo: torch.Tensor,
    node: torch.Tensor,
    params: np.ndarray,
    radius: int,
) -> torch.Tensor:
    """The denoise stage on the tensors' device.  Radius 0 is the
    modulate alone; otherwise the plain stencil for CPU tensors and the
    CUDA kernel for CUDA tensors."""
    if radius == 0:
        return _modulate(colors, albedo,
                         check_params(params, DENOISE_PARAMS_LEN)[14])
    args = (colors, normal, depth, albedo, node, params, radius)
    kind = depth.device.type
    if kind == "cpu":
        return denoise_plain(*args)
    if kind == "cuda":
        return denoise_cuda(*args)
    raise ValueError(f"no denoise implementation for device {depth.device}")
