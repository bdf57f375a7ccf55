"""The procedural default scene: the bowl of the upstream's
``create_voxels`` (``src/context.rs:838-910``), which the viewer renders
when no ``.vox`` is given.

A hemisphere of radius ``r`` as a heightmap over the square
``[-r, r]^2`` of (x, z) columns: inside the disc a column's top lies at
``y = -floor(sqrt(r^2 - x^2 - z^2))``, outside it at ``y = 0``.  Each
column is filled from its top down to the lowest top among itself and
its four neighbours (the square's edge repeats itself), so that a steep
slope shows no holes.  Every voxel gets a colour uniform in [50, 255]
per channel, and 1% of them are emissive.  A strip of emissive white
voxels runs along x at y = -10, z = 0, after the bowl.

The upstream draws from the OS; the port draws from
``numpy.random.default_rng(seed)``: first the colours, an (n, 3) int64
draw, then one float a voxel for the emissive flag, with the voxels in
column order (x major, then z, then y upward).  This module follows
that order, so the same ``seed`` gives the same voxel list.
"""

from __future__ import annotations

import numpy as np

from .voxels import EMISSIVE_MATERIAL_BIT, VoxelList


def default_scene(radius: int = 256, seed: int = 0) -> VoxelList:
    r = int(radius)
    axis = np.arange(-r, r + 1)
    x = np.repeat(axis, len(axis)).reshape(len(axis), len(axis))
    z = x.T

    depth2 = r * r - x * x - z * z
    top = np.zeros_like(x)
    inside = depth2 >= 0
    top[inside] = -np.sqrt(depth2[inside].astype(np.float64)).astype(np.int64)

    edge = np.pad(top, 1, mode="edge")
    bottom = np.minimum(
        np.minimum(top, np.minimum(edge[:-2, 1:-1], edge[2:, 1:-1])),
        np.minimum(edge[1:-1, :-2], edge[1:-1, 2:]))
    heights = (top - bottom + 1).reshape(-1)

    # one row per voxel: its column, and its place up the column
    column = np.repeat(np.arange(heights.size), heights)
    first = np.cumsum(heights) - heights
    up = np.arange(column.size) - first[column]
    pos = np.stack([x.reshape(-1)[column],
                    bottom.reshape(-1)[column] + up,
                    z.reshape(-1)[column]], axis=1).astype(np.int16)

    rng = np.random.default_rng(seed)
    n = len(pos)
    rgb = rng.integers(50, 256, size=(n, 3), dtype=np.int64).astype(np.uint8)
    glow = rng.random(n) < 0.01
    mrgb = np.zeros((n, 4), np.uint8)
    mrgb[:, 0] = np.where(glow, EMISSIVE_MATERIAL_BIT, 0)
    mrgb[:, 1:] = rgb

    strip = np.zeros((len(axis), 3), np.int16)
    strip[:, 0] = axis
    strip[:, 1] = -10
    light = np.full((len(axis), 4), 255, np.uint8)
    light[:, 0] = EMISSIVE_MATERIAL_BIT
    return VoxelList(pos=np.concatenate([pos, strip]),
                     mrgb=np.concatenate([mrgb, light]))
