"""The frame's random numbers: one fixed (S, 128, 128) float32 buffer.

``rand()`` slot k of bounce b at pixel (y, x) on frame f reads
``buffer[(f + 1 + 8*b + k) % S, y % 128, x % 128]`` (the reference
package's fixed slot schedule, ``voxtracer/ops/noise.py``).  The buffer
is the baked blue-noise asset, or seeded white noise for tests; the
planes of one frame (:func:`noise_planes`) are what the numpy oracle
reads.  Copies of ``voxtracer.ops.noise`` and of the asset loader of
``voxtracer.ops.bluenoise.cached_buffer``.  The frames load the shipped
asset and a missing one is an error here: ``ops/bluenoise.py`` bakes
blue noise, but not these values (another generator, another FFT).
"""

from __future__ import annotations

import os

import numpy as np

SLICE = 128
SLICE_COUNT = 512
PLANES_PER_FRAME = 24  # RANDS_PER_BOUNCE * MAX_BOUNCES

BLUE_NOISE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
    "generated",
    f"bluenoise-{SLICE}x{SLICE}x{SLICE_COUNT}-s0.npz",
)


def blue_noise_buffer(path: str = BLUE_NOISE_PATH) -> np.ndarray:
    """The baked (512, 128, 128) float32 blue-noise buffer.  Raises
    ``FileNotFoundError`` if the asset is missing."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"blue-noise asset {path} is missing (the frames load the shipped "
            f"asset; ops/bluenoise.py bakes other values)"
        )
    with np.load(path) as f:
        return f["noise"]


def white_noise_buffer(
    seed: int = 0, count: int = SLICE_COUNT, size: int = SLICE
) -> np.ndarray:
    """Uniform-random stand-in for the blue-noise asset; same shape/dtype."""
    rng = np.random.default_rng(seed)
    return rng.random((count, size, size), dtype=np.float32)


def noise_planes(
    buffer: np.ndarray,  # (SLICE_COUNT, SLICE, SLICE) float32
    frame: int,
    height: int,
    width: int,
    count: int = PLANES_PER_FRAME,
) -> np.ndarray:
    """Materialize the frame's rand() planes -> (count, height, width)."""
    n_slices, sh, sw = buffer.shape
    reps_y = -(-height // sh)
    reps_x = -(-width // sw)
    planes = []
    for k in range(count):
        s = (frame + 1 + k) % n_slices
        planes.append(np.tile(buffer[s], (reps_y, reps_x))[:height, :width])
    return np.stack(planes)
