"""Scene tables on the device.

Counterpart of ``voxtracer.parallel.mesh.scene_device_args``: the four
int32 tables of ``GridScene.device_tables()`` (the trace kernel's scene
ABI, built by the port's :mod:`voxtracer_torch.scene`) as module
buffers, plus the static geometry both trace implementations need.
The reference package's VMEM budget and its HBM / XLA fallback chain
have no counterpart: the tables of every shipped scene fit the card's
memory as they are.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch
from torch import nn

from ..io import vox as voxio
from ..scene import (  # noqa: F401  (re-exported scene types)
    GridScene,
    VoxelList,
    default_scene,
    voxels_from_vox,
)

ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
    "vox",
)


def available_scenes():
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(ASSET_DIR, "*.vox"))
    )


def load_scene(name: str) -> GridScene:
    """A scene by asset name (``assets/vox/<name>.vox``), by .vox path,
    or ``"default"`` for the procedural scene."""
    return GridScene.from_voxels(load_voxels(name))


def load_voxels(name: str) -> VoxelList:
    """The voxel list of a scene named as for :func:`load_scene` (the
    legacy Whitted renderer walks the pointer octree built from it, not
    the dense grid)."""
    if name == "default":
        return default_scene()
    path = name if os.path.exists(name) else os.path.join(
        ASSET_DIR, name + ".vox"
    )
    if not os.path.exists(path):
        raise ValueError(
            f"unknown scene {name!r}; available: "
            f"{', '.join(['default'] + available_scenes())}"
        )
    return voxels_from_vox(voxio.load(path))


class SceneTables(nn.Module):
    """``packed_idx`` (n_rows, 128), ``meta_idx`` (m_rows, 128),
    ``brick_idx`` (3 or 2, b_rows, 128) and ``palette`` (8, 128), int32.

    ``brick_idx`` has two layouts (``voxtracer_torch/scene/grid.py``
    ``_pack_nodes``): content-addressed dedup, 3 planes (mask lo, mask
    hi, uniform slot) indexed by the meta word's 15-bit brick index; or
    per-node, 2 planes (mask lo, mask hi) indexed by the node address,
    with the uniform slot in the meta word.  The leading axis says which.
    """

    def __init__(self, scene: GridScene, device):
        super().__init__()
        t = scene.device_tables()
        for name in ("packed_idx", "meta_idx", "brick_idx", "palette"):
            arr = np.ascontiguousarray(t[name], dtype=np.int32)
            self.register_buffer(
                name, torch.from_numpy(arr).to(torch.device(device))
            )
        self.dims = tuple(int(d) for d in scene.values.shape)
        self.origin = tuple(int(v) for v in scene.origin)
        self.zw = int(t["zw"])
        self.l3_dims = tuple(int(d) for d in t["l3_dims"])
        self.brick_dedup = int(t["brick_idx"].shape[0]) == 3
        if self.palette.numel() != 1024:
            raise ValueError("palette must hold 1024 slots")

    @property
    def device(self) -> torch.device:
        return self.packed_idx.device

    def geometry(self) -> np.ndarray:
        """The static geometry as the kernel's int32 argument block:
        dims(3), origin(3), zw, l3_dims(3), dedup flag, brick plane
        stride (words)."""
        return np.array(
            self.dims
            + self.origin
            + (self.zw,)
            + self.l3_dims
            + (int(self.brick_dedup), self.brick_idx[0].numel()),
            np.int32,
        )
