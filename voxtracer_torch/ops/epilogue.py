"""The frame epilogue: the still blend, the radius-0 modulate and the u8
sRGB encode in one pass over the image.

In the JAX package the tail of a frame is jitted code that XLA fuses
into one pass: the still blend (``voxtracer/ops/temporal.py:104``), the
radius-0 albedo modulate (``voxtracer/ops/denoise_pallas.py:281-283``)
and the u8 encode with its crop (``voxtracer/ops/tonemap.py:37``).  No
``pallas_call`` is involved.  Here:

* :func:`still_epilogue_plain` and :func:`encode_plain` — compositions
  of the plain stages that exist beside them
  (:func:`~voxtracer_torch.ops.temporal.temporal_blend_still_row`,
  :func:`~voxtracer_torch.ops.denoise.modulate_row` /
  ``_modulate``, :func:`~voxtracer_torch.ops.tonemap.to_u8_planar_cropped`);
  they add no arithmetic of their own.  The CPU path and the reference
  for the kernels.
* :func:`still_epilogue_cuda` and :func:`encode_cuda` — the hand-written
  kernels ``csrc/epilogue.cu``.
* :func:`still_epilogue` and :func:`encode` — one of the two by the
  tensors' device.

Both read their parameters from a frame row (``engine.params``
``pack_frame_rows``): the host's numpy row, or a ``DeviceRow`` whose
slice the kernels' row-reading entries copy to constant memory (inside a
captured CUDA graph).  An image goes to a fresh (H, W, 3) u8 tensor, or,
given ``dest = (frames, slot)``, into ``frames[slot]`` where ``slot`` is
a (1,) int64 tensor on the device (the sequence path's frame slot).
With ``in_place=True`` the still epilogue blends into the history it
reads: the blend over ``old_color``, the next blend over ``old_blend``
and this frame's depth over ``old_depth`` (the sequence path's carried
state), with the values of the out-of-place call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..engine.params import (
    ROW_DENOISE,
    ROW_KEEP_ALBEDO,
    ROW_LEN,
    ROW_TEMPORAL,
    DeviceRow,
    check_params,
)
from .denoise import _modulate, modulate_row
from .temporal import _check_planes, temporal_blend_still_row
from .tonemap import to_u8_planar_cropped

# the kernels' slice of a frame row: the temporal vector, the denoise
# vector and the three 1 - x constants (csrc/epilogue.cu `Params`)
ROW_EPILOGUE = ROW_TEMPORAL
EPILOGUE_PARAMS_LEN = ROW_KEEP_ALBEDO + 1 - ROW_EPILOGUE

Dest = Optional[Tuple[torch.Tensor, torch.Tensor]]  # (frames, slot)


def _modulate_by_row(linear, albedo, row):
    """The radius-0 modulate with the albedo factor of ``row``."""
    if isinstance(row, DeviceRow):
        return modulate_row(linear, albedo, row.row)
    return _modulate(linear, albedo,
                     check_params(row, ROW_LEN)[ROW_DENOISE + 14])


def _store(image, dest: Dest):
    """``image`` returned, or written at the slot of ``dest``."""
    if dest is None:
        return image
    frames, slot = dest
    frames.index_copy_(0, slot, image[None])
    return None


def encode_plain(
    linear: torch.Tensor,  # (3, >=height, >=width) float32
    height: int,
    width: int,
    albedo: Optional[torch.Tensor] = None,  # (3, ...) like linear
    row=None,  # the frame's numpy row or DeviceRow (with albedo)
    keep_linear: bool = False,
    dest: Dest = None,
):
    """``(image, out)``: the (height, width, 3) u8 image (None when
    written to ``dest``) of ``linear``, modulated by ``albedo`` where one
    is given; ``out`` is the linear the image encodes, or None where it
    was modulated and not asked for."""
    out = linear if albedo is None else _modulate_by_row(linear, albedo, row)
    image = _store(to_u8_planar_cropped(out, height, width), dest)
    return image, (out if keep_linear or albedo is None else None)


def still_epilogue_plain(
    sampled_color, normal, depth, old_color, old_blend, old_depth,
    albedo: Optional[torch.Tensor],  # None: the blend alone
    row,  # the frame's numpy row or DeviceRow
    keep_linear: bool = False,
    dest: Dest = None,
    in_place: bool = False,
):
    """``(blended, next_blend, out, image)``: the still blend and, with
    an albedo plane, the radius-0 modulate and the u8 image (``out`` and
    ``image`` as :func:`encode_plain`'s; both None without albedo).
    ``in_place``: ``blended`` is ``old_color`` and ``next_blend`` is
    ``old_blend``, overwritten, and ``depth`` is copied into
    ``old_depth``."""
    blended, next_blend = temporal_blend_still_row(
        sampled_color, normal, depth, old_color, old_blend, old_depth,
        row.row if isinstance(row, DeviceRow) else row)
    if in_place:
        blended = old_color.copy_(blended)
        next_blend = old_blend.copy_(next_blend)
        old_depth.copy_(depth)
    if albedo is None:
        return blended, next_blend, None, None
    height, width = depth.shape
    image, out = encode_plain(blended, height, width, albedo, row,
                              keep_linear, dest)
    return blended, next_blend, out, image


def _params(row, device):
    """The kernels' parameters: ``(host pointer, device pointer, host
    slice)``, one of the pointers None; the caller holds the slice until
    the launch has copied it."""
    if isinstance(row, DeviceRow):
        if row.row.device != device:
            raise ValueError(f"row on {row.row.device}, planes on {device}")
        return None, row.pointer(ROW_EPILOGUE), None
    vec = np.ascontiguousarray(check_params(row, ROW_LEN)[
        ROW_EPILOGUE:ROW_EPILOGUE + EPILOGUE_PARAMS_LEN])
    return vec.ctypes.data, None, vec


def _image(dest: Dest, height, width, device):
    """``(image, slot pointer, images, returned)``: where the kernel
    writes the image."""
    if dest is None:
        image = torch.empty((height, width, 3), dtype=torch.uint8,
                            device=device)
        return image, None, 1, image
    frames, slot = dest
    if (frames.dtype != torch.uint8 or frames.dim() != 4
            or tuple(frames.shape[1:]) != (height, width, 3)
            or not frames.is_contiguous() or frames.device != device):
        raise ValueError(
            f"frames must be contiguous (N, {height}, {width}, 3) uint8 on "
            f"{device}, got {tuple(frames.shape)} {frames.dtype} on "
            f"{frames.device}")
    if (slot.dtype != torch.int64 or tuple(slot.shape) != (1,)
            or slot.device != device):
        raise ValueError(f"slot must be (1,) int64 on {device}, got "
                         f"{tuple(slot.shape)} {slot.dtype} on {slot.device}")
    return frames, slot.data_ptr(), frames.shape[0], None


def _launch(name, *args):
    from . import _build

    err = getattr(_build.load(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")


def _check_cuda(tensors, device):
    if device.type != "cuda":
        raise ValueError(f"CUDA kernel given tensors on {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("epilogue inputs must be contiguous")


def still_epilogue_cuda(
    sampled_color, normal, depth, old_color, old_blend, old_depth,
    albedo: Optional[torch.Tensor],
    row,
    keep_linear: bool = False,
    dest: Dest = None,
    in_place: bool = False,
):
    """:func:`still_epilogue_plain` from the hand-written CUDA kernel
    (csrc/epilogue.cu, one launch; with ``in_place`` it writes over the
    history it reads).  Launches on the current stream and does not
    synchronise.  Raises if an input is not what the kernel
    takes or the launch is refused."""
    planes = (sampled_color, normal, depth, old_color, old_blend, old_depth)
    _check_planes(*planes)
    height, width = depth.shape
    dev = depth.device
    ins = planes
    if albedo is not None:
        if (tuple(albedo.shape) != (3, height, width)
                or albedo.dtype != torch.float32 or albedo.device != dev):
            raise ValueError(
                f"albedo must be (3, {height}, {width}) float32 on {dev}, "
                f"got {tuple(albedo.shape)} {albedo.dtype} on {albedo.device}")
        ins = planes + (albedo,)
    _check_cuda(ins, dev)
    params, row_ptr, _host = _params(row, dev)
    if in_place:
        blended, next_blend = old_color, old_blend
    else:
        blended = torch.empty_like(sampled_color)
        next_blend = torch.empty_like(depth)
    out = image = None
    image_ptr = slot_ptr = None
    n_images = 0
    if albedo is not None:
        if keep_linear:
            out = torch.empty_like(sampled_color)
        target, slot_ptr, n_images, image = _image(dest, height, width, dev)
        image_ptr = target.data_ptr()
    with torch.cuda.device(dev):
        _launch(
            "vt_still_epilogue_launch", params, row_ptr,
            *(t.data_ptr() for t in planes),
            None if albedo is None else albedo.data_ptr(),
            height, width, blended.data_ptr(), next_blend.data_ptr(),
            None if out is None else out.data_ptr(), image_ptr, slot_ptr,
            n_images, int(in_place),
            torch.cuda.current_stream(dev).cuda_stream)
    still_epilogue_cuda.launches += 1
    return blended, next_blend, out, image


still_epilogue_cuda.launches = 0


def encode_cuda(
    linear: torch.Tensor,
    height: int,
    width: int,
    albedo: Optional[torch.Tensor] = None,
    row=None,
    keep_linear: bool = False,
    dest: Dest = None,
):
    """:func:`encode_plain` from the hand-written CUDA kernel
    (csrc/epilogue.cu, one launch).  Launches on the current stream and
    does not synchronise.  Raises if an input is not what the kernel
    takes or the launch is refused."""
    dev = linear.device
    if (linear.dim() != 3 or linear.shape[0] != 3
            or linear.dtype != torch.float32):
        raise ValueError(f"linear must be (3, H, W) float32, got "
                         f"{tuple(linear.shape)} {linear.dtype}")
    in_h, in_w = linear.shape[1:]
    if not (0 <= height <= in_h and 0 <= width <= in_w):
        raise ValueError(f"crop {height}x{width} beyond {in_h}x{in_w}")
    ins = (linear,)
    params = row_ptr = None
    if albedo is not None:
        if (albedo.shape != linear.shape or albedo.dtype != torch.float32
                or albedo.device != dev):
            raise ValueError(
                f"albedo must be {tuple(linear.shape)} float32 on {dev}, "
                f"got {tuple(albedo.shape)} {albedo.dtype} on {albedo.device}")
        ins = (linear, albedo)
    _check_cuda(ins, dev)
    if albedo is not None:
        params, row_ptr, _host = _params(row, dev)
    out = linear if albedo is None else None
    if albedo is not None and keep_linear:
        out = torch.empty_like(linear)
    target, slot_ptr, n_images, image = _image(dest, height, width, dev)
    with torch.cuda.device(dev):
        _launch(
            "vt_encode_launch", params, row_ptr, linear.data_ptr(),
            None if albedo is None else albedo.data_ptr(), in_h, in_w,
            height, width,
            None if out is None or albedo is None else out.data_ptr(),
            target.data_ptr(), slot_ptr, n_images,
            torch.cuda.current_stream(dev).cuda_stream)
    encode_cuda.launches += 1
    return image, out


encode_cuda.launches = 0


def _pick(depth, plain, cuda, what):
    kind = depth.device.type
    if kind == "cpu":
        return plain
    if kind == "cuda":
        return cuda
    raise ValueError(f"no {what} implementation for device {depth.device}")


def still_epilogue(sampled_color, normal, depth, old_color, old_blend,
                   old_depth, albedo, row, keep_linear=False, dest=None,
                   in_place=False):
    """The still epilogue on the tensors' device: the plain composition
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    fn = _pick(depth, still_epilogue_plain, still_epilogue_cuda,
               "still epilogue")
    return fn(sampled_color, normal, depth, old_color, old_blend, old_depth,
              albedo, row, keep_linear, dest, in_place)


def encode(linear, height, width, albedo=None, row=None, keep_linear=False,
           dest=None):
    """The u8 encode on the tensor's device: the plain composition for a
    CPU tensor, the CUDA kernel for a CUDA tensor."""
    fn = _pick(linear, encode_plain, encode_cuda, "encode")
    return fn(linear, height, width, albedo, row, keep_linear, dest)
