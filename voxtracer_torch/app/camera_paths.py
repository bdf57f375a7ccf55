"""Scripted camera paths for headless rendering and benchmarks.

Copy of ``voxtracer.app.camera_paths``, which cannot be imported without
JAX (it imports the reference's camera through its engine package).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

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


def orbit(scene: GridScene, period=8.0, elevation=0.45, distance=1.6):
    """Camera circles the scene center — exercises temporal
    reprojection under continuous motion (BASELINE config 3)."""
    center, radius = _scene_frame(scene)
    d = distance * radius

    def path(t: float) -> Camera:
        a = 2 * math.pi * t / period
        offset = np.array(
            [
                math.cos(a) * math.cos(elevation),
                math.sin(elevation),
                math.sin(a) * math.cos(elevation),
            ]
        )
        pos = center + d * offset
        return Camera(position=pos, direction=center - pos)

    return path


def dolly(scene: GridScene, period=6.0, elevation=0.35):
    """Push-in / pull-out along a fixed bearing."""
    center, radius = _scene_frame(scene)

    def path(t: float) -> Camera:
        phase = 0.5 - 0.5 * math.cos(2 * math.pi * t / period)
        d = (2.2 - 1.4 * phase) * radius
        offset = np.array(
            [
                math.cos(0.7) * math.cos(elevation),
                math.sin(elevation),
                math.sin(0.7) * math.cos(elevation),
            ]
        )
        pos = center + d * offset
        return Camera(position=pos, direction=center - pos)

    return path


PATHS: Dict[str, Callable] = {
    "static": static,
    "orbit": orbit,
    "dolly": dolly,
}
