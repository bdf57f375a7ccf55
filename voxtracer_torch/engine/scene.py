"""Scene tables on the device.

Counterpart of ``voxtracer.parallel.mesh.scene_device_args``: the four
int32 tables of ``GridScene.device_tables()`` (the trace kernel's scene
ABI, built by the port's :mod:`voxtracer_torch.scene`) as module
buffers, plus the static geometry both trace implementations need.
The reference package's VMEM budget and its HBM / XLA fallback chain
have no counterpart: the tables of every shipped scene fit the card's
memory as they are (menger's about 1 MB; the scale probe's 480^3 shell,
``app/scaleprobe.py``, about 147 MB).  The trace kernel addresses the
tables with int32 arithmetic, so :class:`SceneTables` refuses a scene
whose tables it would address past 2^31 (:func:`check_table_addressing`)
rather than let the index wrap.

The build is set-up work, and it is traced as the frames are
(``utils.timing``): spans ``vt.scene.voxels`` and ``vt.scene.grid``
(:func:`load_scene`), ``vt.scene.tables`` with ``vt.scene.distance``
(twice) and ``vt.scene.nodes`` inside it, and the ``scene.*`` counts of
its microseconds, bytes and brick layout.  Where the tables go and the
grid's size decide where they are built (:func:`builds_on_device`): on
a CUDA device, for a grid past the size where that is faster, with
torch ops there (``scene/device_build.py``: the value grid's one copy,
span ``vt.scene.upload``, inside ``vt.scene.tables``; counted by
``scene.device_builds``); else by ``GridScene.device_tables()`` on the
host, then copied (``vt.scene.upload`` after ``vt.scene.tables``).
Both give the same bits.
"""

from __future__ import annotations

import glob
import math
import os
import time

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
from ..scene.device_build import device_tables as scene_device_tables
from ..utils.timing import COUNTS, span

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
    t0 = time.perf_counter_ns()
    with span("vt.scene.voxels"):
        voxels = load_voxels(name)
    with span("vt.scene.grid"):
        scene = GridScene.from_voxels(voxels)
    COUNTS["scene.load_us"] += (time.perf_counter_ns() - t0) // 1000
    return scene


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


INT32_LIMIT = 1 << 31
TABLES = ("packed_idx", "meta_idx", "brick_idx", "palette")

# The card builds a scene's tables in about 0.5 s whatever its size (the
# first launch of each torch kernel family in a process loads its
# module), the host in about 170 ns a cell; the two meet near 4 M cells
# on an NVIDIA H100 (PERF.md, section 6).  Every ``.vox`` asset lies
# below, the default bowl (71 M cells) far above.
DEVICE_BUILD_MIN_CELLS = 1 << 22


def builds_on_device(scene: GridScene, device) -> bool:
    """Whether :class:`SceneTables` builds ``scene``'s tables on
    ``device`` itself: a CUDA device and a grid of at least
    ``DEVICE_BUILD_MIN_CELLS`` cells; else the host builds them."""
    return (torch.device(device).type == "cuda"
            and scene.values.size >= DEVICE_BUILD_MIN_CELLS)


def check_table_addressing(dims, zw, l3_dims, numel, brick_dedup):
    """Raise ``ValueError``, naming the table and its size, if a table's
    element count or an index the trace kernel forms into it in int32
    (``csrc/trace.cu`` ``traverse``: the meta word ``l3_col * QZW2 +
    (qz >> 1)``, the brick words ``2 * plane + baddr`` or ``l3_col * QZ +
    qz`` and ``plane + baddr``, the fine word ``fcol * zw + fzw``) would
    reach 2^31.  ``numel``: each table's element count, by name; the
    indices are bounded from the geometry alone, so a scene can be
    checked from its tables' shapes without their data."""
    X, Y, _ = (int(d) for d in dims)
    QX, QY, QZ = (int(d) for d in l3_dims)
    cols = -(-X // 4) * -(-Y // 4) * 16  # fine columns: fcol < cols
    l3_cols = -(-QX // 4) * -(-QY // 4) * 16  # meta columns: l3_col < l3_cols
    plane = int(numel["brick_idx"]) // (3 if brick_dedup else 2)
    baddr = 0x8000 if brick_dedup else l3_cols * QZ
    reach = {
        "packed_idx": max(int(numel["packed_idx"]), cols * int(zw)),
        "meta_idx": max(int(numel["meta_idx"]), l3_cols * -(-QZ // 2)),
        "brick_idx": max(int(numel["brick_idx"]),
                         (2 if brick_dedup else 1) * plane + baddr),
        "palette": int(numel["palette"]),
    }
    for name, n in reach.items():
        if n >= INT32_LIMIT:
            raise ValueError(
                f"scene table {name} ({int(numel[name])} elements, "
                f"{4 * int(numel[name])} bytes) is addressed up to {n}, past "
                f"the trace kernel's int32 indices (2^31); scene dims "
                f"{tuple(int(d) for d in dims)}")


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
        device = torch.device(device)
        on_device = builds_on_device(scene, device)
        t0 = time.perf_counter_ns()
        with span("vt.scene.tables"):
            if on_device:
                t = scene_device_tables(scene.values, device)
                torch.cuda.synchronize(device)
            else:
                t = scene.device_tables()
        t1 = time.perf_counter_ns()
        check_table_addressing(
            scene.values.shape, t["zw"], t["l3_dims"],
            {name: math.prod(t[name].shape) for name in TABLES},
            int(t["brick_idx"].shape[0]) == 3)
        t2 = time.perf_counter_ns()
        if on_device:  # born on the device: nothing to copy
            for name in TABLES:
                self.register_buffer(name, t[name])
        else:
            with span("vt.scene.upload"):
                for name in TABLES:
                    arr = np.ascontiguousarray(t[name], dtype=np.int32)
                    self.register_buffer(name,
                                         torch.from_numpy(arr).to(device))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        t3 = time.perf_counter_ns()
        self.dims = tuple(int(d) for d in scene.values.shape)
        self.origin = tuple(int(v) for v in scene.origin)
        self.zw = int(t["zw"])
        self.l3_dims = tuple(int(d) for d in t["l3_dims"])
        self.brick_dedup = int(t["brick_idx"].shape[0]) == 3
        if self.palette.numel() != 1024:
            raise ValueError("palette must hold 1024 slots")
        COUNTS["scene.builds"] += 1
        COUNTS["scene.device_builds"] += int(on_device)
        COUNTS["scene.tables_us"] += (t1 - t0) // 1000
        COUNTS["scene.upload_us"] += (t3 - t2) // 1000
        COUNTS["scene.table_bytes"] += sum(
            getattr(self, name).nbytes for name in TABLES)
        COUNTS["scene.per_node"] += int(not self.brick_dedup)

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
