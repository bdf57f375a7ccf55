"""Render parameters and the kernels' packed parameter vectors.

Counterpart of :mod:`voxtracer.engine.params`: the same three parameter
sets with the same fields and defaults, as plain frozen dataclasses (no
pytree registration; nothing here is traced).  Each device stage reads
one host-packed float32 vector; its plain torch version reads the same
one, so both see the same float32 values.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


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
    r0 = np.cross(b, c)
    r1 = np.cross(c, a)
    r2 = np.cross(a, b)
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
