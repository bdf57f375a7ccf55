"""The camera circles the scene's centre (the port's
``app/camera_paths.py`` ``orbit``, copied)."""

import math

import numpy as np


def make(world_min, world_max, period=8.0, elevation=0.45, distance=1.6):
    """``f(t) -> (position, direction)`` of a camera orbiting the box
    ``[world_min, world_max]``."""
    center = (world_min + world_max) / 2.0
    radius = float(np.linalg.norm(world_max - world_min)) / 2.0
    d = distance * radius

    def path(t: float):
        a = 2 * math.pi * t / period
        offset = np.array([
            math.cos(a) * math.cos(elevation),
            math.sin(elevation),
            math.sin(a) * math.cos(elevation),
        ])
        pos = center + d * offset
        return pos, center - pos

    return path
