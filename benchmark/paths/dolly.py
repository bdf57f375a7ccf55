"""Push-in / pull-out along a fixed bearing (the port's
``app/camera_paths.py`` ``dolly``, copied)."""

import math

import numpy as np


def make(world_min, world_max, period=6.0, elevation=0.35):
    """``f(t) -> (position, direction)`` of a camera dollying towards
    and away from the centre of the box ``[world_min, world_max]``."""
    center = (world_min + world_max) / 2.0
    radius = float(np.linalg.norm(world_max - world_min)) / 2.0

    def path(t: float):
        phase = 0.5 - 0.5 * math.cos(2 * math.pi * t / period)
        d = (2.2 - 1.4 * phase) * radius
        offset = np.array([
            math.cos(0.7) * math.cos(elevation),
            math.sin(elevation),
            math.sin(0.7) * math.cos(elevation),
        ])
        pos = center + d * offset
        return pos, center - pos

    return path
