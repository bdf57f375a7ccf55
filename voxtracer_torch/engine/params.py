"""Render parameters and the trace kernel's packed parameter vector.

Counterpart of :mod:`voxtracer.engine.params`: the same three parameter
sets with the same fields and defaults, as plain frozen dataclasses (no
pytree registration; nothing here is traced).
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
