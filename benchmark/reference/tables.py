"""The scene tables of the reference, built from the ``.vox`` asset or
the procedural scene alone (:mod:`benchmark.reference.grid`) and held on
the device."""

from __future__ import annotations

import os

import numpy as np
import torch

from . import grid, procedural, vox, voxels

ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets", "vox")


def asset_path(name: str) -> str:
    return os.path.join(ASSET_DIR, name + ".vox")


def load_voxels(name: str) -> voxels.VoxelList:
    """The voxels of ``assets/vox/<name>.vox``, or of the procedural
    scene for ``"default"``, as the port names its scenes."""
    if name == "default":
        return procedural.default_scene()
    return voxels.voxels_from_vox(vox.load(asset_path(name)))


def load_grid(name: str) -> grid.GridScene:
    """The dense grid of the scene ``name`` (:func:`load_voxels`)."""
    return grid.GridScene.from_voxels(load_voxels(name))


def world_bounds(name: str):
    """(world_min, world_max) float32 of the scene's grid: what a camera
    path frames."""
    g = load_grid(name)
    return g.world_min(), g.world_max()


class Tables:
    """``packed_idx``, ``meta_idx``, ``brick_idx``, ``palette`` (int32,
    on ``device``) and the geometry the trace reads."""

    def __init__(self, scene: grid.GridScene, device):
        t = scene.device_tables()
        for name in ("packed_idx", "meta_idx", "brick_idx", "palette"):
            setattr(self, name, torch.from_numpy(
                np.ascontiguousarray(t[name], np.int32)).to(device))
        self.dims = tuple(int(d) for d in scene.values.shape)
        self.origin = tuple(int(v) for v in scene.origin)
        self.zw = int(t["zw"])
        self.l3_dims = tuple(int(d) for d in t["l3_dims"])
        self.brick_dedup = int(t["brick_idx"].shape[0]) == 3

    @property
    def device(self) -> torch.device:
        return self.packed_idx.device
