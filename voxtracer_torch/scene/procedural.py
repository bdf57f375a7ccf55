"""The default procedural scene: a hemispherical "bowl" with random
colors, sparse emissive voxels and an emissive light strip.

Behaviourally equivalent to ``create_voxels`` (``src/context.rs:838-910``):
a radius-256 hemisphere heightmap over [-r, r]^2 (flat y=0 outside the
disc), columns filled down to the lowest 4-neighbour to close slope
voids, colors uniform in [50, 255] per channel, 1% of voxels emissive,
plus a strip of emissive white voxels along x at (y=-10, z=0).

The reference seeds from the OS (``rand::thread_rng``); we use a seeded
numpy Generator so scenes are reproducible across runs and across the
oracle/TPU renderers.  Construction is vectorized column arithmetic
instead of nested x/z loops.

The port's copy of ``voxtracer/scene/procedural.py``.
"""

from __future__ import annotations

import numpy as np

from .voxels import EMISSIVE_MATERIAL_BIT, VoxelList


def default_scene(radius: int = 256, seed: int = 0) -> VoxelList:
    r = int(radius)
    coords = np.arange(-r, r + 1)
    x, z = np.meshgrid(coords, coords, indexing="ij")

    inside = x * x + z * z <= r * r
    height = np.where(
        inside,
        -np.sqrt(np.maximum(0.0, float(r) ** 2 - x**2 - z**2)).astype(int),
        0,
    )

    # Fill from each column's height down to the minimum of its
    # 4-neighbourhood so steep slopes have no holes.
    padded = np.pad(height, 1, mode="edge")
    low = np.minimum.reduce(
        [
            height,
            padded[:-2, 1:-1],
            padded[2:, 1:-1],
            padded[1:-1, :-2],
            padded[1:-1, 2:],
        ]
    )
    counts = (height - low + 1).astype(np.int64)

    col_x = np.repeat(x.ravel(), counts.ravel())
    col_z = np.repeat(z.ravel(), counts.ravel())
    base = np.repeat(low.ravel(), counts.ravel())
    offsets = np.arange(counts.sum()) - np.repeat(
        np.concatenate([[0], np.cumsum(counts.ravel())[:-1]]), counts.ravel()
    )
    col_y = base + offsets

    pos = np.stack([col_x, col_y, col_z], axis=1).astype(np.int16)

    rng = np.random.default_rng(seed)
    n = len(pos)
    rgb = rng.integers(50, 256, size=(n, 3), dtype=np.int64).astype(np.uint8)
    emissive = rng.random(n) < 0.01
    material = np.where(emissive, EMISSIVE_MATERIAL_BIT, 0).astype(np.uint8)
    mrgb = np.concatenate([material[:, None], rgb], axis=1)

    # Light strip through the middle: emissive white along x at y=-10.
    strip_x = np.arange(-r, r + 1, dtype=np.int16)
    strip_pos = np.stack(
        [strip_x, np.full_like(strip_x, -10), np.zeros_like(strip_x)], axis=1
    )
    strip_mrgb = np.tile(
        np.array([[EMISSIVE_MATERIAL_BIT, 255, 255, 255]], dtype=np.uint8),
        (len(strip_x), 1),
    )

    return VoxelList(
        pos=np.concatenate([pos, strip_pos]),
        mrgb=np.concatenate([mrgb, strip_mrgb]),
    )
