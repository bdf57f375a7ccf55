"""History resampling for temporal reprojection: a bilinear fetch of C
history planes at per-pixel source coordinates, clamp-to-edge, at pixel
centres.

Counterpart of ``voxtracer.ops.reproject_pallas.resample`` (the Pallas
TPU kernel) and of ``voxtracer.ops.temporal._bilinear`` (its XLA twin):

* :func:`resample_plain` — plain torch ops in the operation order of
  ``_bilinear``.  The CPU path and the reference for the kernel; the
  planar temporal blend (``ops.temporal``) uses it.
* :func:`resample_cuda` — the hand-written kernel ``csrc/reproject.cu``.
* :func:`resample` — picks one of the two by the tensors' device.

All return ``(sampled (C, H, W) f32, ok (H, W) bool)``.  The Pallas
kernel served taps by integer offset out of a VMEM window and reported
``ok`` False for lanes beyond it (``MARGIN``, ``WY_MAX``,
``MAX_ROUNDS``): a TPU artifact.  The port gathers at any offset, so
``ok`` is all True, and wherever the Pallas kernel reports ok the two
agree.

Tap indices are clamped in float to [-1, n] before the conversion to
int, then to [0, n - 1]: a non-finite or huge coordinate reads an edge
pixel, never out of bounds, identically in both versions.  A NaN or
infinite coordinate gives NaN weights, so its sample is NaN.
"""

from __future__ import annotations

import torch


def _check(hist, px_f, py_f, any_rows: bool):
    """Types, devices, and the coordinates' shape: the history's (H, W),
    or with ``any_rows`` any (h, W)."""
    if hist.dim() != 3 or hist.dtype != torch.float32:
        raise ValueError(
            f"hist must be (C, H, W) float32, got {tuple(hist.shape)} "
            f"{hist.dtype}"
        )
    shape = tuple((px_f.shape[:1] if any_rows else hist.shape[1:2])
                  + hist.shape[2:])
    for name, t in (("px_f", px_f), ("py_f", py_f)):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be {shape} float32, got {tuple(t.shape)} "
                f"{t.dtype}"
            )
        if t.device != hist.device:
            raise ValueError(f"{name} on {t.device}, hist on {hist.device}")


def _tap_index(v: torch.Tensor, n: int) -> torch.Tensor:
    """A whole-float tap coordinate -> int index clamped to [0, n - 1]."""
    i = torch.clamp(v, -1.0, float(n)).to(torch.int32)
    return torch.clamp(i, 0, n - 1)


def resample_plain(
    hist: torch.Tensor,  # (C, H, W) f32 history planes
    px_f: torch.Tensor,  # (h, W) f32 source x in pixel units
    py_f: torch.Tensor,  # (h, W) f32 source y in pixel units
):
    """Bilinear resample of ``hist`` at (py_f, px_f) with plain torch
    ops; ``(sampled (C, h, W), ok (h, W))``: the coordinates may cover
    fewer rows than the history (a slab's pixels against the whole
    image)."""
    _check(hist, px_f, py_f, any_rows=True)
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
    sampled = top * (1 - ty) + bot * ty
    return sampled, torch.ones_like(px_f, dtype=torch.bool)


def resample_cuda(
    hist: torch.Tensor,
    px_f: torch.Tensor,
    py_f: torch.Tensor,
):
    """The same resample from the hand-written CUDA kernel
    (csrc/reproject.cu).  Launches on the current stream and does not
    synchronise.  The coordinates have the history's shape.  Raises if
    an input is not what the kernel takes or the launch is refused."""
    _check(hist, px_f, py_f, any_rows=False)
    if hist.device.type != "cuda":
        raise ValueError(f"CUDA kernel given tensors on {hist.device}")
    if not all(t.is_contiguous() for t in (hist, px_f, py_f)):
        raise ValueError("resample inputs must be contiguous")
    from . import _build

    launch = _build.load().vt_resample_launch
    channels, height, width = hist.shape
    sampled = torch.empty_like(hist)
    ok = torch.empty((height, width), dtype=torch.bool, device=hist.device)
    with torch.cuda.device(hist.device):
        stream = torch.cuda.current_stream(hist.device).cuda_stream
        err = launch(
            hist.data_ptr(),
            px_f.data_ptr(),
            py_f.data_ptr(),
            channels,
            height,
            width,
            sampled.data_ptr(),
            ok.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"resample kernel launch failed: cudaError {err}")
    resample_cuda.launches += 1
    return sampled, ok


resample_cuda.launches = 0


def resample(hist: torch.Tensor, px_f: torch.Tensor, py_f: torch.Tensor):
    """The resample on the tensors' device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    kind = hist.device.type
    if kind == "cpu":
        return resample_plain(hist, px_f, py_f)
    if kind == "cuda":
        return resample_cuda(hist, px_f, py_f)
    raise ValueError(f"no resample implementation for device {hist.device}")
