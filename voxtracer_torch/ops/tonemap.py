"""Final frame encode: linear -> sRGB -> u8.

Counterpart of :mod:`voxtracer.ops.tonemap`.
"""

from __future__ import annotations

import torch


def srgb_encode(linear: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(linear, 0.0, 1.0)
    return torch.where(
        c <= 0.0031308,
        12.92 * c,
        1.055 * torch.pow(c, 1.0 / 2.4) - 0.055,
    )


def to_u8(linear_rgb: torch.Tensor) -> torch.Tensor:
    return torch.round(srgb_encode(linear_rgb) * 255.0).to(torch.uint8)


def to_u8_planar_cropped(
    linear_rgb: torch.Tensor, height: int, width: int
) -> torch.Tensor:
    """(3, >=height, >=width) planar linear color -> (height, width, 3) u8."""
    return torch.movedim(to_u8(linear_rgb)[:, :height, :width], 0, -1)
