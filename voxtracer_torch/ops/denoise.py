"""Denoise stage: the cross-bilateral stencil and the albedo modulate.

Counterpart of ``voxtracer.ops.denoise_pallas.denoise``.  Radius 0 (the
Renderer default) is the albedo remodulation alone
(``denoise.comp:90``), elementwise plain torch on any device
(:func:`modulate_row` where the factor comes from a frame row on the
device, as inside a captured CUDA graph).  For
radius r >= 1 a (2r+1)^2 cross-bilateral stencil runs first:

* :func:`denoise_plain` — the stencil of ``voxtracer.ops.denoise.denoise``
  (zero padding, shifted slices, dy outer / dx inner, ``material >> 24``,
  ``log|depth|``) followed by the Pallas kernel's modulation
  ``out * (1 - f + f * albedo)`` (``denoise_pallas.py:228-237``).  Planar
  (3, H, W).  The CPU path and the reference for the kernel.
* :func:`denoise_cuda` — the hand-written kernel ``csrc/denoise.cu``,
  which replaces the Pallas kernel ``denoise_pallas._make_kernel``; its
  launch geometry is :func:`tile_plan`'s and its ``factor_dist`` values
  :func:`factor_dist_table`'s, its range quotient's reciprocal and
  corrections :func:`range_reciprocal`'s; each launch adds the warps
  its plan keeps resident on an SM (:func:`resident_warps`) to
  ``COUNTS["denoise.resident_warps"]``, and a tiled launch whose
  quotient takes one correction adds 1 to
  ``COUNTS["denoise.reciprocal_launches"]``.
* :func:`denoise` — radius 0, or one of the two by the tensors' device.

All read the (16,) vector of ``engine.params.pack_denoise_params``; the
kernel's wrapper and the dispatcher also take a ``DeviceRow``.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.params import (
    DENOISE_PARAMS_LEN,
    ROW_DENOISE,
    ROW_KEEP_ALBEDO,
    DeviceRow,
    check_params,
)
from ..utils.timing import COUNTS
from .trace import _div, _max0, _norm_div3, pixel_rows


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


class RangeReciprocal(NamedTuple):
    """The tiled kernel's range quotient ``num / b`` for one launch."""

    b: float  # 2 * sigma_range**2 in float32, as the kernel forms it
    y: float  # RN(1 / b) in float32
    steps: int  # corrections after q0 = RN(num * y): 1 or 2


# Markstein's test: where |b * y - 1| is at most this, q0 = RN(num * y) is
# faithful and one correction rounds the quotient correctly
MARKSTEIN_BOUND = Fraction(1, 2**25)


@functools.lru_cache(maxsize=256)
def range_reciprocal(sigma_range: float) -> RangeReciprocal:
    """The reciprocal of ``b = 2 * sigma_range**2`` (float32) that the
    tiled kernel divides each tap's range term by (``csrc/denoise.cu``
    ``range_quotient``), and its corrections: 1 where ``|b * y - 1| <=
    2^-25`` in exact rational arithmetic, else 2.  Raises where ``b`` or
    ``y`` is not a normal float32 (sigma_range outside about
    [8e-20, 5.8e18]).  Remembered: an eager launch asks it each call."""
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        b = np.float32(_sigma2(sigma_range))
        y = np.float32(1.0) / b
    tiny = np.finfo(np.float32).tiny
    if not all(np.isfinite(v) and abs(v) >= tiny for v in (b, y)):
        raise ValueError(
            f"sigma_range {sigma_range} gives 2 sigma^2 = {b} and a "
            f"reciprocal {y}: the kernel needs both normal float32")
    one = abs(Fraction(float(b)) * Fraction(float(y)) - 1) <= MARKSTEIN_BOUND
    return RangeReciprocal(float(b), float(y), 1 if one else 2)


def _modulate(out, albedo, factor: float):
    """out * (1 - f + f * albedo) (denoise_pallas.py:228-237)."""
    f = np.float32(factor)
    return out * (float(np.float32(1.0) - f) + float(f) * albedo)


def modulate_row(out, albedo, row: torch.Tensor):
    """The same modulate with ``f`` and ``1 - f`` (formed on the host)
    read as 0-dim views of a frame row on the planes' device, so that a
    captured CUDA graph modulates by whichever row was gathered.
    Bit-equal to :func:`_modulate` on the row's factor."""
    if row.device != out.device or row.dtype != torch.float32:
        raise ValueError(
            f"row is {row.dtype} on {row.device}, planes on {out.device}")
    return out * (row[ROW_KEEP_ALBEDO] + row[ROW_DENOISE + 14] * albedo)


def denoise_plain(
    colors: torch.Tensor,  # (3, H, W) temporally blended color
    normal: torch.Tensor,  # (3, H, W) first-hit normals
    depth: torch.Tensor,  # (H, W) first-hit depth (-1 on a miss)
    albedo: torch.Tensor,  # (3, H, W)
    node: torch.Tensor,  # (H, W) int32 first-hit node (top 8 bits compared)
    params: np.ndarray,  # (16,) f32, engine.params.pack_denoise_params
    radius: int,
    row0: int = 0,
) -> torch.Tensor:
    """The (2r+1)^2 stencil with plain torch ops, then the modulate.
    The planes are image rows ``row0 ..``: a window of a row-sharded
    frame (its slab and the halo rows around it), whose edges pad with
    zeros as the image's do; the rows it keeps tap nothing beyond it."""
    _check_inputs(colors, normal, depth, albedo, node, radius)
    if row0 < 0:
        raise ValueError(f"row0 {row0} < 0")
    P = [float(v) for v in check_params(params, DENOISE_PARAMS_LEN)]
    height, width = depth.shape
    dev = depth.device
    r = int(radius)
    px = torch.arange(width, device=dev, dtype=torch.float32)[None, :]
    py = pixel_rows(height, row0, dev)
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


# csrc/denoise.cu's geometry: 32x8 threads, each computing 4 outputs
# down its column, so a block owns a 32x32 tile; the tile and an r-wide
# halo sit in shared memory as 8 float32 planes.  Radii 1-8 have a
# template instance of their own; larger radii run instance 0, which
# takes the radius at run time.  Above r = 26 the haloed tile no longer
# fits a block's shared memory: instance GLOBAL_INSTANCE computes one
# output a thread and reads every tap from global memory.
BLOCK = (32, 8)
ROWS_PER_THREAD = 4
STATIC_RADII = 8
TILE_PLANES = 8
MAX_SHARED_BYTES = 232_448  # a block's shared memory on an H100
GLOBAL_INSTANCE = -1


class TilePlan(NamedTuple):
    instance: int
    block: tuple
    grid: tuple
    rows_per_thread: int
    shared_bytes: int


def tile_plan(height: int, width: int, radius: int) -> TilePlan:
    """The denoise kernel's launch for a ``height`` x ``width`` frame:
    template instance, block, grid, outputs per thread and dynamic
    shared bytes (the haloed tile's planes)."""
    tile_w, tile_h = BLOCK[0], BLOCK[1] * ROWS_PER_THREAD
    shared_bytes = (TILE_PLANES * 4 * (tile_w + 2 * radius)
                    * (tile_h + 2 * radius))
    if shared_bytes > MAX_SHARED_BYTES:
        return TilePlan(
            instance=GLOBAL_INSTANCE,
            block=BLOCK,
            grid=(-(-width // BLOCK[0]), -(-height // BLOCK[1])),
            rows_per_thread=1,
            shared_bytes=0,
        )
    return TilePlan(
        instance=radius if radius <= STATIC_RADII else 0,
        block=BLOCK,
        grid=(-(-width // tile_w), -(-height // tile_h)),
        rows_per_thread=ROWS_PER_THREAD,
        shared_bytes=shared_bytes,
    )


# (library, instance, row, steps, shared bytes) -> warps: asked once a plan
_RESIDENT: Dict[tuple, int] = {}


def resident_warps(instance: int, row: bool, shared_bytes: int,
                   steps: int = 1) -> int:
    """The warps that a launch of :func:`tile_plan`'s ``instance`` (its
    row-reading entry where ``row``; its quotient's ``steps``, as
    :func:`range_reciprocal` gives them) at ``shared_bytes`` of dynamic
    shared memory keeps resident on one SM of the current device
    (``vt_denoise_resident_warps``: the occupancy query after the
    attribute the launch sets).  Asked of the loaded library once for
    each (instance, row, steps, shared bytes), then remembered.  Raises
    where the query fails."""
    from . import _build

    lib = _build.load()
    key = (lib, int(instance), bool(row), int(steps), int(shared_bytes))
    warps = _RESIDENT.get(key)
    if warps is None:
        warps = lib.vt_denoise_resident_warps(key[1], int(key[2]), key[3],
                                              key[4])
        if warps < 0:
            raise RuntimeError(
                f"denoise occupancy query failed: cudaError {-warps}")
        _RESIDENT[key] = warps
    return warps


def reciprocal_launch(plan: TilePlan, rr: RangeReciprocal) -> int:
    """1 where a launch of ``plan`` divides by ``rr`` with one correction
    (a tiled instance; the GLOBAL one keeps IEEE division), else 0."""
    return int(plan.instance != GLOBAL_INSTANCE and rr.steps == 1)


def factor_dist_table(radius: int, sigma_distance: float) -> np.ndarray:
    """(2r+1)^2 float32 ``factor_dist`` values, dy outer, dx inner: the
    plain version's per-tap ``float32(dx^2 + dy^2) / float32(sigma_d2)``."""
    d = np.arange(-radius, radius + 1)
    sq = (d[:, None] * d[:, None] + d[None, :] * d[None, :]).astype(np.float32)
    return (sq / np.float32(_sigma2(sigma_distance))).reshape(-1)


def denoise_cuda(
    colors: torch.Tensor,
    normal: torch.Tensor,
    depth: torch.Tensor,
    albedo: torch.Tensor,
    node: torch.Tensor,
    params,  # (16,) f32 vector, or a frame's DeviceRow
    radius: int,
    row0: int = 0,
) -> torch.Tensor:
    """The same stencil and modulate from the hand-written CUDA kernel
    (csrc/denoise.cu), ``row0`` by value.  ``params`` is the host's
    vector, passed by value, or a
    :class:`~voxtracer_torch.engine.params.DeviceRow`: the sigmas, the
    albedo factor, the ``factor_dist`` table and the range quotient's
    reciprocal, constant over a camera path, then come by value from its
    host row, and the kernel's row-reading entry takes the camera rows
    from the row on the device.  Launches on the current stream and does
    not synchronise.  Raises if an input is not what the kernel takes or the
    launch is refused."""
    _check_inputs(colors, normal, depth, albedo, node, radius)
    if row0 < 0:
        raise ValueError(f"row0 {row0} < 0")
    row = None
    if isinstance(params, DeviceRow):
        if params.row.device != depth.device:
            raise ValueError(
                f"row on {params.row.device}, depth on {depth.device}")
        row = params.pointer(ROW_DENOISE)
        params = params.host[ROW_DENOISE:ROW_DENOISE + DENOISE_PARAMS_LEN]
    params = check_params(params, DENOISE_PARAMS_LEN)
    height, width = depth.shape
    plan = tile_plan(height, width, int(radius))
    if depth.device.type != "cuda":
        raise ValueError(f"CUDA kernel given tensors on {depth.device}")
    ins = (colors, normal, depth, albedo, node)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("denoise inputs must be contiguous")
    from . import _build

    launch = _build.load().vt_denoise_launch
    # the tiled instances' table; GLOBAL_INSTANCE computes it per tap
    fdist = (factor_dist_table(int(radius), params[12])
             if plan.instance != GLOBAL_INSTANCE else np.zeros(1, np.float32))
    rr = range_reciprocal(params[13])
    out = torch.empty_like(colors)
    with torch.cuda.device(depth.device):
        warps = resident_warps(plan.instance, row is not None,
                               plan.shared_bytes, rr.steps)
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        err = launch(
            params.ctypes.data,
            fdist.ctypes.data,
            row,
            *(t.data_ptr() for t in ins),
            height,
            width,
            row0,
            int(radius),
            plan.instance,
            *plan.block,
            plan.rows_per_thread,
            *plan.grid,
            plan.shared_bytes,
            rr.y,
            rr.steps,
            out.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"denoise kernel launch failed: cudaError {err}")
    denoise_cuda.launches += 1
    COUNTS["denoise.resident_warps"] += warps
    COUNTS["denoise.reciprocal_launches"] += reciprocal_launch(plan, rr)
    return out


denoise_cuda.launches = 0


def quotient_check(sigma_range: float, first: int = 0,
                   count: int = 1 << 31) -> Dict:
    """The tiled kernel's range quotient against IEEE division on the
    current CUDA device (``vt_denoise_quotient_check``), over the
    ``count`` float32 dividends whose bit patterns run up from ``first``
    (by default every non-negative one, inf and the NaNs among them), by
    :func:`range_reciprocal`'s reciprocal and steps: ``differ``, the
    dividends whose quotients differ (any NaN equal to any NaN); ``top``,
    the largest quotient of either among those (0.0 where none);
    ``plateau``, the dividends in [0, 2^-25] whose ``expf(-a)`` is not 1.
    Synchronises."""
    from . import _build

    rr = range_reciprocal(sigma_range)
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    err = _build.load().vt_denoise_quotient_check(
        float(np.float32(sigma_range)), rr.y, rr.steps, first, count,
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"quotient check failed: cudaError {err}")
    differ, top, plateau = out.tolist()
    return {"differ": differ, "plateau": plateau,
            "top": float(np.uint32(top).view(np.float32))}


def denoise(
    colors: torch.Tensor,
    normal: torch.Tensor,
    depth: torch.Tensor,
    albedo: torch.Tensor,
    node: torch.Tensor,
    params,  # (16,) f32 vector, or a frame's DeviceRow
    radius: int,
    row0: int = 0,  # image row of the planes' row 0 (a slab's window)
) -> torch.Tensor:
    """The denoise stage on the tensors' device.  Radius 0 is the
    modulate alone; otherwise the plain stencil for CPU tensors and the
    CUDA kernel for CUDA tensors."""
    if radius == 0:
        if isinstance(params, DeviceRow):
            return modulate_row(colors, albedo, params.row)
        return _modulate(colors, albedo,
                         check_params(params, DENOISE_PARAMS_LEN)[14])
    args = (colors, normal, depth, albedo, node, params, radius, row0)
    kind = depth.device.type
    if kind == "cpu":
        return denoise_plain(*args)
    if kind == "cuda":
        return denoise_cuda(*args)
    raise ValueError(f"no denoise implementation for device {depth.device}")
