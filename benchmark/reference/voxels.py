"""Voxel lists and the packed leaf-value encoding.

The engine-wide voxel unit is ``([x, y, z] int16, [material, r, g, b]
uint8)``, identical to the reference's host representation
(``src/context.rs:710``).  A solid voxel is stored in acceleration
structures as a packed negative int32 "leaf value"
(``src/context.rs:734-735``):

    bit 31      : leaf marker (sign bit)
    bit 30      : emissive flag (bit 6 of the material byte; the shader's
                  EMMITANCE_BIT, ``shaders/voxels.comp:11``)
    bits 24-30  : material & 0x7f
    bits 16-23  : red
    bits 8-15   : green
    bits 0-7    : blue

World mapping: voxel integer position ``p`` occupies the half-open world
cube ``[p * 0.5, p * 0.5 + 0.5)`` — see ``scene.grid.CELL_SIZE`` for the
derivation.

The benchmark's copy of the port's ``scene/voxels.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .vox import MaterialKind, Vox

EMISSIVE_MATERIAL_BIT = 1 << 6  # material-byte flag (src/context.rs:921-924)


@dataclasses.dataclass(frozen=True)
class VoxelList:
    """A set of solid voxels: positions (N,3) int16, mrgb (N,4) uint8."""

    pos: np.ndarray
    mrgb: np.ndarray

    def __post_init__(self):
        assert self.pos.ndim == 2 and self.pos.shape[1] == 3
        assert self.mrgb.shape == (self.pos.shape[0], 4)

    def __len__(self) -> int:
        return self.pos.shape[0]


def pack_leaves(mrgb: np.ndarray) -> np.ndarray:
    """Pack (N,4) uint8 material+rgb rows into negative int32 leaf values."""
    m, r, g, b = (mrgb[:, i].astype(np.uint32) for i in range(4))
    packed = (
        np.uint32(1 << 31)
        | ((m & 0x7F) << 24)
        | (r << 16)
        | (g << 8)
        | b
    )
    return packed.astype(np.int32)


def unpack_leaf_rgb(leaf: np.ndarray) -> np.ndarray:
    """Inverse of the rgb part of :func:`pack_leaves` -> (..., 3) float in [0,1]."""
    v = np.asarray(leaf).astype(np.int64)
    return (
        np.stack([(v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF], axis=-1)
        / 255.0
    )


def voxels_from_vox(vox: Vox, model_index: int = 0) -> VoxelList:
    """Adapt a parsed .vox model to engine voxels.

    MagicaVoxel is z-up while the engine is y-up, so positions swizzle
    ``(x, y, z) -> (x, z, y)``; colors resolve through the palette and the
    emissive flag comes from the palette slot's material
    (``src/context.rs:913-933``).
    """
    model = vox.models[model_index]
    v = model.voxels
    pos = np.stack([v[:, 0], v[:, 2], v[:, 1]], axis=1).astype(np.int16)

    color_idx = v[:, 3]
    rgb = vox.color_rgb(color_idx)

    emissive = np.zeros(len(v), dtype=bool)
    for mat_id, mat in vox.materials.items():
        if mat.kind is MaterialKind.EMIT:
            emissive |= color_idx == mat_id
    material = np.where(emissive, EMISSIVE_MATERIAL_BIT, 0).astype(np.uint8)

    mrgb = np.concatenate([material[:, None], rgb], axis=1)
    return VoxelList(pos=pos, mrgb=mrgb)
