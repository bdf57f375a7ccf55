"""Denoise stage.

Counterpart of ``voxtracer.ops.denoise_pallas.denoise``.  Radius 0 (the
Renderer default) is the albedo remodulation alone
(``denoise.comp:90``), elementwise; the cross-bilateral stencil for
radius > 0 needs the denoise kernel (ROADMAP Queue 1 #6 / Queue 2 #3)
and is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def denoise(
    colors: torch.Tensor,  # (3, H, W)
    albedo: torch.Tensor,  # (3, H, W)
    params,  # DenoiseParams
    radius: int,
) -> torch.Tensor:
    if radius != 0:
        raise NotImplementedError(
            f"denoise radius {radius} needs the cross-bilateral denoise "
            "kernel, not ported yet (ROADMAP Queue 1 #6, Queue 2 #3); "
            "radius 0 is supported"
        )
    factor = np.float32(params.albedo_factor)
    return colors * (float(np.float32(1.0) - factor) + float(factor) * albedo)
