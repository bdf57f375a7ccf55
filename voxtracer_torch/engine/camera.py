"""Pinhole fly-camera and its ray basis (numpy).

Copy of :mod:`voxtracer.engine.camera`, which cannot be imported
without JAX (its package imports the JAX parameter pytrees).  The
per-pixel ray is ``normalize(px * right - py * up + forward)`` with the
pixel-scaled basis from :meth:`Camera.axis_scaled`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

WORLD_UP = np.array([0.0, 1.0, 0.0], dtype=np.float64)


@dataclasses.dataclass
class Camera:
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, -2.0])
    )
    direction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 1.0])
    )
    fov: float = math.radians(70.0)

    def axis(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        forward = np.asarray(self.direction, dtype=np.float64)
        forward = forward / np.linalg.norm(forward)
        right = np.cross(WORLD_UP, forward)
        right = right / np.linalg.norm(right)
        up = np.cross(forward, right)
        return right, up, forward

    def axis_scaled(
        self, width: int, height: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pixel-space ray basis: ray(px, py) = px*right - py*up + fwd."""
        right, up, forward = self.axis()
        fov_scale = math.tan(self.fov / 2.0)
        forward_ray = (
            (-width / 2.0) * right
            + (height / 2.0) * up
            + (height / 2.0) / fov_scale * forward
        )
        return right, up, forward_ray

    def rows(self, width: int, height: int) -> np.ndarray:
        """(4, 3) float32 rows: origin, right, up, forward (pixel-scaled)."""
        right, up, forward = self.axis_scaled(width, height)
        return np.stack(
            [np.asarray(self.position), right, up, forward]
        ).astype(np.float32)

    def with_yaw_pitch(self, yaw: float, pitch: float) -> "Camera":
        direction = np.array(
            [
                math.sin(yaw) * math.cos(pitch),
                math.sin(pitch),
                math.cos(yaw) * math.cos(pitch),
            ]
        )
        return dataclasses.replace(self, direction=direction)

    def pitched(self, degrees: float) -> "Camera":
        """The same camera pitched up by ``degrees``."""
        d = self.direction / np.linalg.norm(self.direction)
        return self.with_yaw_pitch(math.atan2(d[0], d[2]),
                                   math.asin(d[1]) + math.radians(degrees))
