"""The scene tables built on the card (``scene/device_build.py``) against
the host build (``GridScene.device_tables()``), bit for bit, on the full
procedural bowl (radius 256, per-node) and the benchmark's two ``.vox``
scenes (dedup); ``SceneTables`` on the card builds the bowl there and
the ``.vox`` scenes, below ``DEVICE_BUILD_MIN_CELLS``, on the host, with
the counters of each; the device build's spans under a profiler.  Needs
a card: ``python -m pytest --noconftest -m cuda
tests/test_torch_scene_device_build_cuda.py`` (chip_smoke phase 27 runs
it too).  The same build on CPU tensors is held in
``tests/test_torch_scene_device_build.py``."""

import pytest
import torch
from torch.autograd import DeviceType

from voxtracer_torch.engine import scene as scene_mod
from voxtracer_torch.engine.pipeline import counters
from voxtracer_torch.engine.scene import TABLES, SceneTables, load_scene
from voxtracer_torch.scene.device_build import device_tables

DEVICE_SPANS = ["vt.scene.voxels", "vt.scene.grid", "vt.scene.tables",
                "vt.scene.upload", "vt.scene.distance", "vt.scene.distance",
                "vt.scene.nodes"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the build under test runs on it)")
    return torch.device("cuda")


def _grown(before):
    after = counters()
    return {k: after[k] - before[k] for k in after if k.startswith("scene.")}


@pytest.mark.cuda
@pytest.mark.parametrize("name,per_node,on_card", [
    ("default", 1, 1), ("menger", 0, 0), ("monu9", 0, 0)])
def test_card_build_bit_equal_to_the_host_build(cuda, name, per_node,
                                                on_card):
    scene = load_scene(name)
    want = scene.device_tables()
    got = device_tables(scene.values, cuda)
    before = counters()
    tables = SceneTables(scene, cuda)
    grown = _grown(before)
    for table in TABLES:
        for t in (got[table], getattr(tables, table)):
            assert t.device.type == "cuda" and t.dtype == torch.int32
            assert tuple(t.shape) == want[table].shape, table
            assert t.cpu().numpy().tobytes() == want[table].tobytes(), table
    assert got["zw"] == tables.zw == want["zw"]
    assert got["l3_dims"] == tables.l3_dims == tuple(
        int(d) for d in want["l3_dims"])
    assert grown["scene.builds"] == 1
    assert grown["scene.device_builds"] == on_card
    assert grown["scene.per_node"] == per_node
    assert grown["scene.table_bytes"] == sum(
        want[table].nbytes for table in TABLES)
    assert grown["scene.tables_us"] > 0


@pytest.mark.cuda
def test_card_build_spans_nest(cuda, monkeypatch):
    monkeypatch.setattr(scene_mod, "DEVICE_BUILD_MIN_CELLS", 0)
    with torch.autograd.profiler.profile(use_kineto=True) as prof:
        SceneTables(load_scene("menger"), cuda)
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.function_events
                    if e.device_type == DeviceType.CPU
                    and e.name.startswith("vt.scene.")),
                   key=lambda s: s[1])
    assert [s[0] for s in spans] == DEVICE_SPANS
    (_, t0, t1), = [s for s in spans if s[0] == "vt.scene.tables"]
    inside = [s[0] for s in spans if t0 <= s[1] and s[2] <= t1]
    assert inside == DEVICE_SPANS[2:]
    top = spans[:3]
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))
