"""Fly-camera input controller — a frontend-agnostic state machine.

Copy of :mod:`voxtracer.app.input` over the port's
:class:`voxtracer_torch.engine.camera.Camera` (the reference's module
imports its camera through the JAX package):

  * W/S along the view direction, A/D strafe, Q/E world up/down
  * speed 5.0 world-units/s; 0.5 with Ctrl, 50 with Shift
  * mouse-look at 0.001 rad per pixel while the cursor is grabbed
    (Tab toggles grab; Esc requests exit)
  * any movement or look resets the renderer's still-frame counter

Frontends (the terminal and browser viewers, tests) feed events in and
read the resulting camera out.  Nothing here touches the device.
"""

from __future__ import annotations

import dataclasses
from typing import Set

import numpy as np

from ..engine.camera import Camera

SPEED_NORMAL = 5.0
SPEED_SLOW = 0.5
SPEED_FAST = 50.0
LOOK_RADIANS_PER_PIXEL = 0.001


@dataclasses.dataclass
class FlyController:
    camera: Camera = dataclasses.field(default_factory=Camera)
    yaw: float = 0.0
    pitch: float = 0.0
    pressed: Set[str] = dataclasses.field(default_factory=set)
    cursor_grabbed: bool = False
    exit_requested: bool = False
    moved: bool = False

    def key_down(self, key: str):
        key = key.lower()
        if key == "escape":
            self.exit_requested = True
        elif key == "tab":
            self.cursor_grabbed = not self.cursor_grabbed
        else:
            self.pressed.add(key)

    def key_up(self, key: str):
        self.pressed.discard(key.lower())

    def mouse_delta(self, dx: float, dy: float):
        if self.cursor_grabbed:
            self.yaw += LOOK_RADIANS_PER_PIXEL * dx
            self.pitch -= LOOK_RADIANS_PER_PIXEL * dy
            self.moved = True

    def update(self, dt: float) -> Camera:
        """Advance the camera by dt seconds of held keys; returns it."""
        self.camera = self.camera.with_yaw_pitch(self.yaw, self.pitch)
        right, _, forward = self.camera.axis()

        movement = np.zeros(3)
        if "w" in self.pressed:
            movement += forward
        if "s" in self.pressed:
            movement -= forward
        if "d" in self.pressed:
            movement += right
        if "a" in self.pressed:
            movement -= right
        if "e" in self.pressed:
            movement[1] += 1.0
        if "q" in self.pressed:
            movement[1] -= 1.0

        if np.any(movement != 0):
            if "ctrl" in self.pressed:
                speed = SPEED_SLOW
            elif "shift" in self.pressed:
                speed = SPEED_FAST
            else:
                speed = SPEED_NORMAL
            movement = movement / np.linalg.norm(movement)
            self.camera = dataclasses.replace(
                self.camera,
                position=self.camera.position + speed * dt * movement,
            )
            self.moved = True
        return self.camera

    def take_moved(self) -> bool:
        """Read-and-clear the movement flag (drives still_sample reset)."""
        moved, self.moved = self.moved, False
        return moved

    def frame(self, camera: Camera):
        """Start from ``camera``, with yaw and pitch read from its
        direction (the viewers open on a framing view of the scene)."""
        self.camera = camera
        d = camera.direction / np.linalg.norm(camera.direction)
        self.pitch = float(np.arcsin(d[1]))
        self.yaw = float(np.arctan2(d[0], d[2]))
