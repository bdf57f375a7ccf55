"""Pinhole fly-camera and its ray basis (numpy).

The benchmark's copy of the port's ``engine/camera.py``, with
``np.cross`` written out (:func:`cross3`).  The
per-pixel ray is ``normalize(px * right - py * up + forward)`` with the
pixel-scaled basis from :meth:`Camera.axis_scaled`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

WORLD_UP = np.array([0.0, 1.0, 0.0], dtype=np.float64)


def cross3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``np.cross`` of two 3-vectors of one float type, with its
    roundings (each product, then the difference) at a fraction of its
    cost: a camera path computes a basis per frame on the host."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    return np.array([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0],
                    dtype=a.dtype)


def _unit(v: np.ndarray) -> np.ndarray:
    """``v / np.linalg.norm(v)`` for a float64 vector: the norm is
    ``sqrt(v.dot(v))`` there too."""
    return v / math.sqrt(v.dot(v))


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
        forward = _unit(np.asarray(self.direction, dtype=np.float64))
        right = _unit(cross3(WORLD_UP, forward))
        up = cross3(forward, right)
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
        out = np.empty((4, 3), np.float32)
        out[0] = self.position
        out[1], out[2], out[3] = self.axis_scaled(width, height)
        return out

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
