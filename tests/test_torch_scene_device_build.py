"""The scene tables built with torch ops (``scene/device_build.py``, the
path ``SceneTables`` takes on a CUDA device) against the host build
(``GridScene.device_tables()``), bit for bit, on CPU tensors: every
asset in both brick layouts, the procedural bowl in each layout it takes
unforced, a single voxel, an empty grid, and a grid whose padding
branches the shipped scenes never reach.  A CPU ``SceneTables`` keeps
the host build; a CUDA one takes the device build from
``DEVICE_BUILD_MIN_CELLS`` cells up, closed by a synchronise (held
through stand-ins for the card).  The card's own test is
``tests/test_torch_scene_device_build_cuda.py``."""

import numpy as np
import pytest
import torch

from voxtracer_torch.engine import scene as scene_mod
from voxtracer_torch.engine.pipeline import counters
from voxtracer_torch.engine.scene import (
    DEVICE_BUILD_MIN_CELLS,
    TABLES,
    SceneTables,
    available_scenes,
    builds_on_device,
    load_scene,
)
from voxtracer_torch.scene import GridScene, VoxelList, default_scene
from voxtracer_torch.scene import grid as tgrid
from voxtracer_torch.scene.device_build import device_tables


def _assert_same_tables(scene):
    """The torch build of ``scene`` on the CPU == its host build."""
    want = scene.device_tables()
    got = device_tables(scene.values, "cpu")
    for name in TABLES:
        assert got[name].dtype == torch.int32, name
        assert got[name].is_contiguous(), name
        assert tuple(got[name].shape) == want[name].shape, name
        assert got[name].numpy().tobytes() == want[name].tobytes(), name
    assert got["zw"] == want["zw"]
    assert tuple(got["l3_dims"]) == tuple(want["l3_dims"])
    return got


def _grid(values):
    return GridScene(values=np.ascontiguousarray(values, np.int32),
                     origin=np.zeros(3, np.int32), mips=[values != 0])


@pytest.mark.parametrize("dedup_max", [None, 0], ids=["dedup", "per_node"])
@pytest.mark.parametrize("name", available_scenes())
def test_assets_bit_equal(name, dedup_max, monkeypatch):
    if dedup_max is not None:
        monkeypatch.setattr(tgrid, "BRICK_DEDUP_MAX", dedup_max)
    got = _assert_same_tables(load_scene(name))
    assert got["brick_idx"].shape[0] == (3 if dedup_max is None else 2)


@pytest.mark.parametrize("radius,planes", [(24, 3), (128, 2)])
def test_bowl_bit_equal_in_the_layout_it_takes(radius, planes):
    """The bowl dedups at radius 24 and is per-node at 128, unforced."""
    got = _assert_same_tables(GridScene.from_voxels(default_scene(radius)))
    assert got["brick_idx"].shape[0] == planes


def test_single_voxel_and_empty_grid_bit_equal():
    one = GridScene.from_voxels(VoxelList(
        pos=np.array([[0, 0, 0]], dtype=np.int16),
        mrgb=np.array([[0, 200, 100, 50]], dtype=np.uint8)))
    _assert_same_tables(one)
    empty = _assert_same_tables(GridScene.from_voxels(VoxelList(
        pos=np.zeros((0, 3), np.int16), mrgb=np.zeros((0, 4), np.uint8))))
    assert not empty["palette"].any()


@pytest.mark.parametrize("dedup_max", [None, 0], ids=["dedup", "per_node"])
def test_padding_branches_bit_equal(dedup_max, monkeypatch):
    """x 12 and y 8 (the L3 level padded past the grid's own blocks), z
    20 (no multiple of 3: padded words; 5 L3 cells: a padded meta
    halfword), leaves of both signs, blocks uniform and mixed."""
    if dedup_max is not None:
        monkeypatch.setattr(tgrid, "BRICK_DEDUP_MAX", dedup_max)
    rng = np.random.default_rng(7)
    leaves = np.array([-7, -(1 << 31), 5, (1 << 31) - 1, -1], np.int32)
    values = np.where(rng.random((12, 8, 20)) < 0.2,
                      rng.choice(leaves, (12, 8, 20)), 0)
    values[0:4, 4:8, 12:16] = -7  # a uniform block
    values[8:12, 0:4, 16:20] = 5  # one in the last L3 cell along z
    got = _assert_same_tables(_grid(values))
    assert got["zw"] == 7 and got["l3_dims"] == (4, 4, 5)


def test_palette_overflow_refused_as_on_the_host():
    values = np.zeros((16, 8, 8), np.int32)
    values.reshape(-1)[: tgrid.PALETTE_CAPACITY] = -1 - np.arange(
        tgrid.PALETTE_CAPACITY)
    with pytest.raises(AssertionError, match="not palettized"):
        _grid(values).device_tables()
    with pytest.raises(AssertionError, match="not palettized"):
        device_tables(values, "cpu")


def _grown(before):
    after = counters()
    return {k: after[k] - before[k] for k in after if k.startswith("scene.")}


def test_cpu_scene_tables_takes_the_host_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the device build ran for a CPU SceneTables")

    monkeypatch.setattr(scene_mod, "scene_device_tables", refuse)
    before = counters()
    tables = SceneTables(load_scene("menger"), "cpu")
    grown = _grown(before)
    assert grown["scene.builds"] == 1 and grown["scene.device_builds"] == 0
    assert tables.brick_dedup


@pytest.mark.parametrize("device,cells,on_device", [
    ("cpu", DEVICE_BUILD_MIN_CELLS, False),
    ("cuda", DEVICE_BUILD_MIN_CELLS - 128 * 128, False),
    ("cuda", DEVICE_BUILD_MIN_CELLS, True),
    ("cuda:0", 2 * DEVICE_BUILD_MIN_CELLS, True),
])
def test_builds_on_device_by_device_and_grid_cells(device, cells, on_device):
    values = np.zeros((cells // (128 * 128), 128, 128), np.int32)
    assert builds_on_device(_grid(values), device) is on_device
    assert not builds_on_device(load_scene("room"), "cuda")  # largest .vox


def test_cuda_scene_tables_builds_on_the_device(monkeypatch):
    """Through stand-ins for the card: a CUDA ``SceneTables`` of a grid
    past the size (here every grid) builds with the torch ops on its
    device, closes the build with a synchronise on it before the clock
    stops, copies nothing and counts a device build."""
    monkeypatch.setattr(scene_mod, "DEVICE_BUILD_MIN_CELLS", 0)
    scene = load_scene("chr_knight")
    host = SceneTables(scene, "cpu")
    calls = []

    def build(values, device):
        calls.append(("build", device))
        return device_tables(values, "cpu")

    def refuse(self):
        raise AssertionError("the host build ran for a CUDA SceneTables")

    monkeypatch.setattr(scene_mod, "scene_device_tables", build)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(("sync", device)))
    monkeypatch.setattr(GridScene, "device_tables", refuse)
    before = counters()
    tables = SceneTables(scene, "cuda")
    card = torch.device("cuda")
    assert calls == [("build", card), ("sync", card)]
    grown = _grown(before)
    assert grown["scene.builds"] == grown["scene.device_builds"] == 1
    assert grown["scene.table_bytes"] == sum(
        getattr(host, name).nbytes for name in TABLES)
    assert grown["scene.per_node"] == 0
    for name in TABLES:
        assert torch.equal(getattr(tables, name), getattr(host, name)), name
    assert (tables.geometry() == host.geometry()).all()
