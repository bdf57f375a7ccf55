"""Render parameters and the kernels' packed parameter vectors.

Counterpart of :mod:`voxtracer.engine.params`: the same three parameter
sets with the same fields and defaults, as plain frozen dataclasses (no
pytree registration; nothing here is traced).  Each device stage reads
one host-packed float32 vector; its plain torch version reads the same
one, so both see the same float32 values.

A camera path known up front is packed as one row per frame
(:func:`pack_frame_rows`, the analog of the reference's
``pack_kernel_rows`` / ``(N, KROWS, 128)`` ``packed_seq``).  On the card
the rows live in a device tensor and every stage reads the row that a
device cursor picked (:class:`DeviceRow`), so one captured CUDA graph
serves every frame of the path.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .camera import cross3


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Lighting / material parameters of the path tracer."""

    emit_strength: float = 4.0
    sun_strength: float = 4.0
    sun_size: float = 0.05
    sun_yaw: float = 1.32
    sun_pitch: float = 1.0
    sun_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    sky_color: Tuple[float, float, float] = (0.45, 0.6, 0.65)
    specularity: float = 0.0


@dataclasses.dataclass(frozen=True)
class TemporalParams:
    """Temporal reprojection blending parameters."""

    sample_blending: float = 0.5
    maximum_blending: float = 0.98
    blending_distance_cutoff: float = 1e-2


@dataclasses.dataclass(frozen=True)
class DenoiseParams:
    """Cross-bilateral denoiser parameters (the radius is a Renderer
    field, as in the reference package)."""

    sigma_distance: float = 2.0
    sigma_range: float = 1.5
    albedo_factor: float = 1.0


DENOISE_RADIUS_DEFAULT = 0


def check_params(params, n: int) -> np.ndarray:
    """A packed parameter vector as the (n,) contiguous float32 array
    that both implementations of a stage read; raises otherwise."""
    params = np.ascontiguousarray(params)
    if params.shape != (n,) or params.dtype != np.float32:
        raise ValueError(
            f"params must be ({n},) float32, got {params.shape} {params.dtype}"
        )
    return params

# float32 trace-parameter layout, read by both trace implementations:
#   0-2 cam origin | 3-5 right | 6-8 up | 9-11 forward (pixel-scaled)
#   12 sun_yaw | 13 sun_pitch | 14 sun_size | 15 sun_strength
#   16 emit_strength | 17 specularity | 18-20 sun_color | 21-23 sky_color
#   24-26 sun direction (raw) | 27-29 sun direction (normalized)
# The sun trig runs here, in float64 numpy, so both implementations
# read the same float32 values.
TRACE_PARAMS_LEN = 32


def pack_trace_params(cam: np.ndarray, p: RenderParams) -> np.ndarray:
    """(4, 3) camera rows + RenderParams -> (32,) float32 trace vector,
    bit-equal to ``voxtracer.ops.trace_pallas.pack_params`` (flattened)."""
    out = np.zeros(TRACE_PARAMS_LEN, np.float32)
    out[0:12] = np.asarray(cam, np.float32).reshape(12)
    out[12] = p.sun_yaw
    out[13] = p.sun_pitch
    out[14] = p.sun_size
    out[15] = p.sun_strength
    out[16] = p.emit_strength
    out[17] = p.specularity
    out[18:21] = np.asarray(p.sun_color)
    out[21:24] = np.asarray(p.sky_color)
    sd = np.array(
        [
            np.cos(p.sun_yaw) * np.cos(p.sun_pitch),
            -np.sin(p.sun_pitch),
            np.sin(p.sun_yaw) * np.cos(p.sun_pitch),
        ],
        np.float32,
    )
    out[24:27] = sd
    out[27:30] = sd / np.linalg.norm(sd)
    return out


# float32 temporal-parameter layout, read by both temporal
# implementations (the fields of ``temporal_pallas.pack_temporal_row_host``
# without its mesh slots):
#   0-11 camera rows (origin, right, up, forward) | 12-23 old camera rows
#   24-32 row-major inverse of the old basis columns [right up forward]
#   33 sample_blending | 34 maximum_blending | 35 blending_distance_cutoff
#   36 history_valid (1.0 / 0.0)
TEMPORAL_PARAMS_LEN = 40


def inv3(m: np.ndarray) -> np.ndarray:
    """Adjugate 3x3 inverse in float32 numpy, the cofactor order of
    ``voxtracer.ops.temporal._inv3_np``."""
    m = np.asarray(m, np.float32)
    a, b, c = m[:, 0], m[:, 1], m[:, 2]
    r0 = cross3(b, c)
    r1 = cross3(c, a)
    r2 = cross3(a, b)
    det = np.dot(a, r0)
    return (np.stack([r0, r1, r2], axis=0) / det).astype(np.float32)


def pack_temporal_params(
    cam: np.ndarray, old_cam: np.ndarray, p: TemporalParams,
    history_valid: bool,
) -> np.ndarray:
    """Camera rows, old camera rows and TemporalParams -> (40,) float32."""
    cam = np.asarray(cam, np.float32)
    old = np.asarray(old_cam, np.float32)
    out = np.zeros(TEMPORAL_PARAMS_LEN, np.float32)
    out[0:12] = cam.reshape(12)
    out[12:24] = old.reshape(12)
    out[24:33] = inv3(np.stack([old[1], old[2], old[3]], axis=1)).reshape(9)
    out[33] = p.sample_blending
    out[34] = p.maximum_blending
    out[35] = p.blending_distance_cutoff
    out[36] = float(bool(history_valid))
    return out


# float32 denoise-parameter layout (``denoise_pallas.pack_denoise_row_host``
# without its mesh row offset):
#   0-11 camera rows | 12 sigma_distance | 13 sigma_range
#   14 albedo_factor
DENOISE_PARAMS_LEN = 16


def pack_denoise_params(cam: np.ndarray, p: DenoiseParams) -> np.ndarray:
    """Camera rows and DenoiseParams -> (16,) float32."""
    out = np.zeros(DENOISE_PARAMS_LEN, np.float32)
    out[0:12] = np.asarray(cam, np.float32).reshape(12)
    out[12] = p.sigma_distance
    out[13] = p.sigma_range
    out[14] = p.albedo_factor
    return out


# One float32 row per frame of a sequence:
#   0-31 the trace vector | 32 the frame number (int32 bit pattern; the
#   noise index is frame % n_slices), so that the trace kernel's
#   parameters are one run of 33 words | 33-72 the temporal vector |
#   73-88 the denoise vector, each vector bit-equal to its pack_*
#   function's
#   89 1 - sample_blending | 90 1 - maximum_blending
#   91 1 - albedo_factor: formed in float32 here, so that the plain
#      torch stages reading the row on the device use the host's values
ROW_TRACE = 0
ROW_FRAME = ROW_TRACE + TRACE_PARAMS_LEN
ROW_TEMPORAL = ROW_FRAME + 1
ROW_DENOISE = ROW_TEMPORAL + TEMPORAL_PARAMS_LEN
ROW_KEEP_SAMPLE = ROW_DENOISE + DENOISE_PARAMS_LEN
ROW_KEEP_FLOOR = ROW_KEEP_SAMPLE + 1
ROW_KEEP_ALBEDO = ROW_KEEP_SAMPLE + 2
ROW_LEN = 96


def pack_frame_rows(
    cams: Sequence[np.ndarray],  # N x (4, 3) f32 camera rows
    prev_cam: np.ndarray,  # (4, 3) f32: the camera of the live history
    history_valid: bool,  # before the first frame; True from the second
    first_frame: int,  # frame number of cams[0]
    rp: RenderParams,
    tp: TemporalParams,
    dp: DenoiseParams,
) -> np.ndarray:
    """The (N, ROW_LEN) float32 rows of a camera path.  Frame i's old
    camera is frame i-1's; the first frame's is ``prev_cam``, or its own
    while there is no history to reproject.

    The host packs a whole path before the device starts on it, and
    ``render()`` packs a row every frame, so only what differs between
    frames is packed per frame, and for all frames at once: the cameras,
    the old basis's inverse, the validity flag and the frame number.
    The rest is packed once per parameter set."""
    cams = np.asarray(cams, np.float32).reshape(-1, 4, 3)
    old = np.asarray(prev_cam if history_valid else cams[0], np.float32)
    first = np.empty(ROW_LEN, np.float32)
    fill_frame_row(first, cams[0], old, history_valid, first_frame,
                   _constant_row(rp, tp, dp), old_basis_inverse(old))
    if len(cams) == 1:  # render()'s frame: nothing to repeat
        return first[None]

    rows = np.tile(first, (len(cams), 1))
    frames = rows[:, ROW_FRAME].view(np.int32)
    frames[:] = np.arange(first_frame, first_frame + len(cams))
    flat = cams.reshape(-1, 12)
    rows[:, ROW_TRACE:ROW_TRACE + 12] = flat
    rows[:, ROW_DENOISE:ROW_DENOISE + 12] = flat
    later = rows[1:, ROW_TEMPORAL:ROW_DENOISE]  # frame i's old: i - 1's
    later[:, 0:12] = flat[1:]
    later[:, 12:24] = flat[:-1]
    later[:, 24:33] = _inv3_rows(cams[:-1])
    later[:, 36] = 1.0
    return rows


def old_basis_inverse(old: np.ndarray) -> np.ndarray:
    """(9,) float32: the temporal vector's slots 24-32, the inverse of
    the basis columns [right up forward] of the (4, 3) camera rows
    ``old``."""
    return inv3(np.stack([old[1], old[2], old[3]], axis=1)).reshape(9)


def fill_frame_row(row: np.ndarray, cam: np.ndarray, old: np.ndarray,
                   history_valid: bool, frame: int, constant: np.ndarray,
                   old_inverse: np.ndarray):
    """One frame's row into ``row`` (ROW_LEN,) float32: ``constant``
    (:func:`_constant_row` of the frame's parameter sets), the camera
    rows ``cam``, the old camera ``old`` (float32 (4, 3)) and its
    :func:`old_basis_inverse`, the validity flag and the frame
    number."""
    cam0 = np.asarray(cam, np.float32).reshape(12)
    row[:] = constant
    row[ROW_TRACE:ROW_TRACE + 12] = cam0
    row[ROW_DENOISE:ROW_DENOISE + 12] = cam0
    t = row[ROW_TEMPORAL:ROW_DENOISE]
    t[0:12] = cam0
    t[12:24] = old.reshape(12)
    t[24:33] = old_inverse
    t[36] = float(bool(history_valid))
    row[ROW_FRAME:ROW_FRAME + 1].view(np.int32)[0] = frame


def _constant_row(rp: RenderParams, tp: TemporalParams,
                  dp: DenoiseParams) -> np.ndarray:
    """The slots of a row that no camera and no frame number changes,
    from the pack_* functions on a zero camera (whose slots stay 0).
    The parameter sets are frozen, so one row serves every frame packed
    with them (kept while they hash: colours given as lists do not);
    callers copy it."""
    try:
        return _cached_constant_row(rp, tp, dp)
    except TypeError:
        return _cached_constant_row.__wrapped__(rp, tp, dp)


@functools.lru_cache(maxsize=8)
def _cached_constant_row(rp, tp, dp):
    zero = np.zeros((4, 3), np.float32)
    row = np.zeros(ROW_LEN, np.float32)
    row[ROW_TRACE:ROW_FRAME] = pack_trace_params(zero, rp)
    t = row[ROW_TEMPORAL:ROW_DENOISE]
    t[33] = tp.sample_blending
    t[34] = tp.maximum_blending
    t[35] = tp.blending_distance_cutoff
    row[ROW_DENOISE:ROW_KEEP_SAMPLE] = pack_denoise_params(zero, dp)
    one = np.float32(1.0)
    row[ROW_KEEP_SAMPLE] = one - np.float32(tp.sample_blending)
    row[ROW_KEEP_FLOOR] = one - np.float32(tp.maximum_blending)
    row[ROW_KEEP_ALBEDO] = one - np.float32(dp.albedo_factor)
    return row


def _inv3_rows(cams: np.ndarray) -> np.ndarray:
    """:func:`inv3` of each camera's basis, (N, 4, 3) -> (N, 9), with
    its roundings: the same float32 products, differences and quotients
    elementwise, and its ``np.dot`` per row (a vectorised sum could
    round otherwise)."""
    a, b, c = cams[:, 1], cams[:, 2], cams[:, 3]

    def cross(u, v):
        return np.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                         u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                         u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], axis=1)

    r0, r1, r2 = cross(b, c), cross(c, a), cross(a, b)
    det = np.array([np.dot(x, y) for x, y in zip(a, r0)], np.float32)
    inv = np.stack([r0, r1, r2], axis=1) / det[:, None, None]
    return inv.reshape(-1, 9)


class DeviceRow(NamedTuple):
    """One frame's row where the stages read it on the card.

    ``row`` is on the device (in a sequence: the path's row at the device
    cursor, gathered inside the frame).  The kernels' row-reading entries
    take the address of their slice of it; the plain torch stages read
    0-dim views of it.  ``host`` is a row of the same path on the host,
    for what a stage keeps by value over a path (the denoise sigmas,
    albedo factor and ``factor_dist`` table)."""

    row: torch.Tensor  # (ROW_LEN,) float32, contiguous, on the card
    host: np.ndarray  # (ROW_LEN,) float32

    def pointer(self, offset: int) -> int:
        """The device address of slot ``offset``, for a kernel's
        row-reading entry; raises unless the row is what those read."""
        row = self.row
        if (row.dtype != torch.float32 or tuple(row.shape) != (ROW_LEN,)
                or not row.is_contiguous() or row.device.type != "cuda"):
            raise ValueError(
                f"row must be a contiguous ({ROW_LEN},) float32 CUDA tensor, "
                f"got {tuple(row.shape)} {row.dtype} on {row.device}"
            )
        return row.data_ptr() + 4 * offset
