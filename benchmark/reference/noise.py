"""The frames' random numbers: the shipped blue-noise asset, read from
its file (``rand()`` slot k of bounce b at pixel (y, x) on frame f is
``buffer[(f + 1 + 8*b + k) % S, y % 128, x % 128]``)."""

from __future__ import annotations

import os

import numpy as np

BLUE_NOISE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets", "generated", "bluenoise-128x128x512-s0.npz")


def blue_noise_buffer(path: str = BLUE_NOISE_PATH) -> np.ndarray:
    """The (512, 128, 128) float32 buffer."""
    with np.load(path) as f:
        return f["noise"]
