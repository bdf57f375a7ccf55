"""Temporal accumulation: the still-camera blend and the reprojecting
blend of a moved camera.

* :func:`temporal_blend_still_planar` — counterpart of
  ``voxtracer.ops.temporal.temporal_blend_still_planar``
  (``temporal.comp:99-124`` with the identity reprojection): elementwise
  plain torch on any device, as XLA fused it in the reference.
  :func:`temporal_blend_still_row` is the same blend reading its cameras
  and constants from one frame row (``engine.params.pack_frame_rows``):
  the form the frame function runs, on the host's row or, inside a
  captured CUDA graph, on 0-dim views of the row on the device.
* :func:`temporal_blend_reproject_plain` — counterpart of
  ``voxtracer.ops.temporal.temporal_blend`` with ``reproject=True,
  resample_impl="xla"`` (the any-offset path): each first-hit point is
  reprojected into the old camera through the inverse old pixel basis,
  the 5-plane history (rgb, blend, depth) is fetched by the shared
  resampler :func:`voxtracer_torch.ops.reproject.resample_plain`, tested
  by world distance, and blended.  Planar (3, H, W), in the reference's
  operation order.  The CPU path and the reference for the kernel.
* :func:`temporal_blend_reproject_cuda` — the hand-written kernel
  ``csrc/temporal.cu``, which replaces the Pallas kernel
  ``temporal_pallas.temporal_blend_fused``.  It gathers history at any
  offset: the Pallas kernel's offset-serve window (``MARGIN``,
  ``MAX_ROUNDS``) turned lanes it could not serve into invalid history,
  so the port's semantics are the any-offset path's, equal to the fused
  kernel's wherever its window serves.
* :func:`temporal_blend_reproject` — picks one of the two by device.
* :func:`temporal_blend` — counterpart of the channels-last
  ``voxtracer.ops.temporal.temporal_blend``: a layout wrapper that runs
  the still blend, or the reprojecting body of
  :func:`temporal_blend_reproject_plain` around the shared resampler
  :func:`voxtracer_torch.ops.reproject.resample`, which picks by device:
  the plain version on the CPU, the kernel ``csrc/reproject.cu`` (which
  replaces ``reproject_pallas.resample``) on CUDA.  The BASELINE harness
  (``app/bench.py``) times it; the renderer's frames do not run it.

The reprojecting functions read the (40,) vector of
``engine.params.pack_temporal_params``, whose inverse the host computes;
the kernel's wrapper also takes a ``DeviceRow``, and the kernel then
reads that vector from device memory.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..engine.params import (
    ROW_KEEP_FLOOR,
    ROW_KEEP_SAMPLE,
    ROW_TEMPORAL,
    TEMPORAL_PARAMS_LEN,
    DeviceRow,
    TemporalParams,
    check_params,
    pack_temporal_params,
)
from .reproject import resample, resample_plain
from .trace import _div, _max0, _norm_div3, as_f32, pixel_rows, sqrt_f32


def _blend_still(
    sampled_color, normal, depth, old_color, old_blend, old_depth,
    cam, old_cam, cutoff, keep_sample, keep_floor, history_valid, row0=0,
):
    """The still blend's one body.  ``cam`` and ``old_cam`` are 4 x 3
    scalars; these, ``cutoff``, ``keep_sample`` (1 - sample_blending),
    ``keep_floor`` (1 - maximum_blending) and ``history_valid`` are all
    Python numbers holding float32 values, or all 0-dim tensors on the
    planes' device.  Both kinds give the same bits: a tensor times a
    Python number is computed in float32, and nothing here divides by
    one.  The planes are image rows ``row0 ..`` (a slab of a row-sharded
    frame), history included."""
    height, width = depth.shape
    origin, right, up, forward = cam
    o_origin, o_right, o_up, o_forward = old_cam
    dev = depth.device
    px = torch.arange(width, device=dev, dtype=torch.float32)[None, :]
    py = pixel_rows(height, row0, dev)

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
    same_position = dist < bias * cutoff * depth

    valid = same_position & (depth >= 0) & history_valid
    use_color = torch.where(valid[None], old_color, 0.0)
    blending = torch.where(valid, old_blend, 1.0)
    blended = torch.where(
        (depth >= 0)[None],
        use_color * (1.0 - blending[None]) + sampled_color * blending[None],
        sampled_color,
    )
    # torch.clamp takes two numbers or two tensors, never one of each
    one = torch.ones_like(keep_floor) if torch.is_tensor(keep_floor) else 1.0
    next_blending = torch.clamp(keep_sample * blending, keep_floor, one)
    return blended, next_blending


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
    row0: int = 0,  # image row of the planes' row 0 (a slab)
):
    """Returns ``(blended (3, H, W), next_blending (H, W))``."""
    one = np.float32(1.0)
    return _blend_still(
        sampled_color, normal, depth, old_color, old_blend, old_depth,
        [[float(v) for v in r] for r in cam],
        [[float(v) for v in r] for r in old_cam],
        as_f32(params.blending_distance_cutoff),
        as_f32(one - np.float32(params.sample_blending)),
        as_f32(one - np.float32(params.maximum_blending)),
        bool(history_valid), row0,
    )


def temporal_blend_still_row(
    sampled_color: torch.Tensor,
    normal: torch.Tensor,
    depth: torch.Tensor,
    old_color: torch.Tensor,
    old_blend: torch.Tensor,
    old_depth: torch.Tensor,
    row,  # (ROW_LEN,) f32, one row of engine.params.pack_frame_rows
    row0: int = 0,  # image row of the planes' row 0 (a slab)
):
    """The still blend reading one frame row: a numpy row on the host
    (its values as Python numbers) or a tensor on the planes' device (its
    values as 0-dim views, so that a captured CUDA graph blends whichever
    row was gathered).  Bit-equal to :func:`temporal_blend_still_planar`
    on the row's cameras and constants."""
    if torch.is_tensor(row):
        if row.device != depth.device or row.dtype != torch.float32:
            raise ValueError(
                f"row is {row.dtype} on {row.device}, depth on {depth.device}")
    else:
        row = [float(v) for v in row]
    t = row[ROW_TEMPORAL:ROW_TEMPORAL + TEMPORAL_PARAMS_LEN]
    return _blend_still(
        sampled_color, normal, depth, old_color, old_blend, old_depth,
        [t[3 * i:3 * i + 3] for i in range(4)],
        [t[12 + 3 * i:15 + 3 * i] for i in range(4)],
        t[35], row[ROW_KEEP_SAMPLE], row[ROW_KEEP_FLOOR], t[36] > 0.0,
        row0,
    )


def _check_planes(sampled_color, normal, depth, old_color, old_blend,
                  old_depth, row0=0, whole_history=False):
    """The planes' shapes, types and device.  The history has the
    current planes' rows, or with ``whole_history`` every row of the
    image, of which the current planes are rows ``row0 ..``."""
    height, width = depth.shape
    hist_h = old_depth.shape[0] if whole_history else height
    if row0 < 0 or (whole_history and row0 + height > hist_h):
        raise ValueError(f"rows {row0}..{row0 + height} outside the "
                         f"history's {hist_h}")
    for name, t, shape in (
        ("sampled_color", sampled_color, (3, height, width)),
        ("normal", normal, (3, height, width)),
        ("old_color", old_color, (3, hist_h, width)),
        ("old_blend", old_blend, (hist_h, width)),
        ("old_depth", old_depth, (hist_h, width)),
    ):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be {shape} float32, got {tuple(t.shape)} "
                f"{t.dtype}"
            )
        if t.device != depth.device:
            raise ValueError(f"{name} on {t.device}, depth on {depth.device}")


def _blend_reproject(
    sampled_color: torch.Tensor,  # (3, H, W) current trace output
    normal: torch.Tensor,  # (3, H, W) current first-hit normals
    depth: torch.Tensor,  # (H, W) current first-hit depth
    old_color: torch.Tensor,  # (3, H, W) history color
    old_blend: torch.Tensor,  # (H, W) history blending (alpha)
    old_depth: torch.Tensor,  # (H, W) history depth
    params: np.ndarray,  # (40,) f32, engine.params.pack_temporal_params
    resample: Callable,  # an ops.reproject resampler
    row0: int = 0,
):
    """The reprojecting blend in plain torch ops around ``resample``.
    The current planes are image rows ``row0 ..`` (a slab), the history
    is the whole image, whose height scales the old screen.  Returns
    ``(blended (3, h, W), next_blending (h, W))``."""
    _check_planes(sampled_color, normal, depth, old_color, old_blend,
                  old_depth, row0, whole_history=True)
    # exact float32 values
    P = [float(v) for v in check_params(params, TEMPORAL_PARAMS_LEN)]
    height, width = depth.shape
    img_height = old_depth.shape[0]
    dev = depth.device
    px = torch.arange(width, device=dev, dtype=torch.float32)[None, :]
    py = pixel_rows(height, row0, dev)

    # the current pixel's ray and first-hit world point
    rx, ry, rz = _norm_div3(
        px * P[3] - py * P[6] + P[9],
        px * P[4] - py * P[7] + P[10],
        px * P[5] - py * P[8] + P[11],
    )
    wx = P[0] + depth * rx
    wy = P[1] + depth * ry
    wz = P[2] + depth * rz

    # world -> old screen: s = inv @ (world - old origin)
    relx, rely, relz = wx - P[12], wy - P[13], wz - P[14]
    s0 = P[24] * relx + P[25] * rely + P[26] * relz
    s1 = P[27] * relx + P[28] * rely + P[29] * relz
    s2 = P[30] * relx + P[31] * rely + P[32] * relz
    sx = s0 / s2
    sy = s1 / s2
    tex_x = _div(sx + 0.5, float(width))
    tex_y = _div(sy - 0.5, float(-img_height))
    in_range = (tex_x >= 0) & (tex_x <= 1) & (tex_y >= 0) & (tex_y <= 1)

    # the 5 history planes (rgb, blend, depth) at the old screen point;
    # the resampler's coverage mask narrows the in-range test
    hist = torch.cat([old_color, old_blend[None], old_depth[None]])
    hist5, ok = resample(hist, tex_x * width, tex_y * img_height)
    in_range = in_range & ok

    # the old ray quantizes to the pixel lattice (temporal.comp:99-103)
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

    # world-distance validity scaled by depth and view angle
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


def temporal_blend_reproject_plain(
    sampled_color: torch.Tensor,  # (3, H, W) current trace output
    normal: torch.Tensor,  # (3, H, W) current first-hit normals
    depth: torch.Tensor,  # (H, W) current first-hit depth
    old_color: torch.Tensor,  # (3, H, W) history color
    old_blend: torch.Tensor,  # (H, W) history blending (alpha)
    old_depth: torch.Tensor,  # (H, W) history depth
    params: np.ndarray,  # (40,) f32, engine.params.pack_temporal_params
    row0: int = 0,  # image row of the current planes' row 0 (a slab)
):
    """Returns ``(blended (3, h, W), next_blending (h, W))`` for the
    current planes' h rows; the history is the whole (H, W) image."""
    return _blend_reproject(sampled_color, normal, depth, old_color,
                            old_blend, old_depth, params,
                            resample_plain, row0)


def temporal_blend_reproject_cuda(
    sampled_color: torch.Tensor,
    normal: torch.Tensor,
    depth: torch.Tensor,
    old_color: torch.Tensor,
    old_blend: torch.Tensor,
    old_depth: torch.Tensor,
    params,  # (40,) f32 vector, or a frame's DeviceRow
    row0: int = 0,
):
    """The same blend from the hand-written CUDA kernel
    (csrc/temporal.cu).  ``params`` is the host's vector, passed by
    value, or a :class:`~voxtracer_torch.engine.params.DeviceRow`: the
    kernel's row-reading entry then takes its vector from the row on the
    device.  ``row0`` and the history's height go by value.  Launches on
    the current stream and does not synchronise.  Raises if an input is
    not what the kernel takes or the launch is refused."""
    _check_planes(sampled_color, normal, depth, old_color, old_blend,
                  old_depth, row0, whole_history=True)
    if isinstance(params, DeviceRow):
        if params.row.device != depth.device:
            raise ValueError(
                f"row on {params.row.device}, depth on {depth.device}")
        source = (None, params.pointer(ROW_TEMPORAL))
    else:
        params = check_params(params, TEMPORAL_PARAMS_LEN)
        source = (params.ctypes.data, None)
    if depth.device.type != "cuda":
        raise ValueError(f"CUDA kernel given tensors on {depth.device}")
    ins = (sampled_color, normal, depth, old_color, old_blend, old_depth)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("temporal inputs must be contiguous")
    from . import _build

    launch = _build.load().vt_temporal_launch
    height, width = depth.shape
    blended = torch.empty_like(sampled_color)
    next_blending = torch.empty_like(depth)
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        err = launch(
            *source,
            *(t.data_ptr() for t in ins),
            height,
            width,
            row0,
            old_depth.shape[0],
            blended.data_ptr(),
            next_blending.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"temporal kernel launch failed: cudaError {err}")
    temporal_blend_reproject_cuda.launches += 1
    return blended, next_blending


temporal_blend_reproject_cuda.launches = 0


def temporal_blend_reproject(
    sampled_color: torch.Tensor,
    normal: torch.Tensor,
    depth: torch.Tensor,
    old_color: torch.Tensor,
    old_blend: torch.Tensor,
    old_depth: torch.Tensor,
    params,
    row0: int = 0,
):
    """The reprojecting blend on the tensors' device: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    args = (sampled_color, normal, depth, old_color, old_blend, old_depth,
            params, row0)
    kind = depth.device.type
    if kind == "cpu":
        return temporal_blend_reproject_plain(*args)
    if kind == "cuda":
        return temporal_blend_reproject_cuda(*args)
    raise ValueError(f"no temporal implementation for device {depth.device}")


def temporal_blend(
    sampled_color: torch.Tensor,  # (H, W, 3) current trace output
    normal: torch.Tensor,  # (H, W, 3) current first-hit normals
    depth: torch.Tensor,  # (H, W) current first-hit depth
    old_color: torch.Tensor,  # (H, W, 3) history color
    old_blend: torch.Tensor,  # (H, W) history blending (alpha)
    old_depth: torch.Tensor,  # (H, W) history depth
    cam: np.ndarray,  # (4, 3) f32: origin, right, up, forward (scaled)
    old_cam: np.ndarray,  # (4, 3) f32
    params: TemporalParams,
    history_valid: bool,
    reproject: bool,
    row0: int = 0,
):
    """Channels-last layout wrapper of the planar blends, the counterpart
    of ``voxtracer.ops.temporal.temporal_blend``.  ``reproject=False`` is
    the still blend; ``reproject=True`` the reprojecting blend around
    :func:`voxtracer_torch.ops.reproject.resample`, which takes the
    tensors' device: the plain resampler on the CPU (the reference's
    ``"xla"``), the kernel on CUDA (its ``"pallas"``, which takes the
    current planes at the history's size only).  With ``row0`` the
    current planes are a slab from that image row on, against the whole
    history when reprojecting, their own rows of it when still.
    Returns ``(blended (h, W, 3), next_blending (h, W))``."""
    planar = [torch.movedim(t, -1, 0)
              for t in (sampled_color, normal, old_color)]
    if reproject:
        blended, next_blending = _blend_reproject(
            planar[0], planar[1], depth, planar[2], old_blend, old_depth,
            pack_temporal_params(cam, old_cam, params, history_valid),
            resample, row0,
        )
    else:
        blended, next_blending = temporal_blend_still_planar(
            planar[0], planar[1], depth, planar[2], old_blend, old_depth,
            cam, old_cam, params, history_valid, row0,
        )
    return torch.movedim(blended, 0, -1), next_blending
