"""Scripted camera paths (the still ones so far).

Counterpart of ``voxtracer.app.camera_paths``; only ``static`` is
ported, because a moving path needs the reprojection kernel (ROADMAP
Queue 1 #5).
"""

from __future__ import annotations

import math

import numpy as np

from ..engine.camera import Camera
from ..engine.scene import GridScene


def _scene_frame(scene: GridScene):
    center = (scene.world_min() + scene.world_max()) / 2.0
    radius = float(np.linalg.norm(scene.world_max() - scene.world_min())) / 2.0
    return center, radius


def static(scene: GridScene, azimuth=0.8, elevation=0.5, distance=1.8):
    """One fixed three-quarter view framing the scene."""
    center, radius = _scene_frame(scene)
    d = distance * radius

    def path(t: float) -> Camera:
        offset = np.array(
            [
                math.cos(azimuth) * math.cos(elevation),
                math.sin(elevation),
                math.sin(azimuth) * math.cos(elevation),
            ]
        )
        pos = center + d * offset
        return Camera(position=pos, direction=center - pos)

    return path
