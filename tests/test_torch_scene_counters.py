"""The scene build's counters and spans (``engine/scene.py``,
``scene/grid.py``, ``utils/timing.py``): one ``SceneTables`` counts one
build, its four tables' bytes and its brick layout; the host
microseconds grow; under a profiler the ``vt.scene.*`` ranges come in
the order the build runs them, the distance fields and the node tables
inside ``vt.scene.tables``; with none, every span is the shared no-op;
``--stats`` prints the build's counts."""

import pytest
import torch
from torch.autograd import DeviceType

from voxtracer_torch.app import cli
from voxtracer_torch.engine.pipeline import counters
from voxtracer_torch.engine.scene import TABLES, SceneTables, load_scene
from voxtracer_torch.scene import GridScene, default_scene
from voxtracer_torch.scene import grid as tgrid
from voxtracer_torch.utils import timing

SCENE_SPANS = ["vt.scene.voxels", "vt.scene.grid", "vt.scene.tables",
               "vt.scene.distance", "vt.scene.distance", "vt.scene.nodes",
               "vt.scene.upload"]


def _grown(before):
    after = counters()
    return {k: after[k] - before[k] for k in after if k.startswith("scene.")}


def _per_node_bowl(monkeypatch):
    """The procedural bowl at radius 24 in the per-node brick layout:
    the dedup cap forced to 0 (at the shipped cap the bowl dedups up to
    a radius of about 96)."""
    monkeypatch.setattr(tgrid, "BRICK_DEDUP_MAX", 0)
    return GridScene.from_voxels(default_scene(radius=24))


@pytest.mark.parametrize("per_node", [0, 1], ids=["menger", "bowl-per-node"])
def test_a_build_counts_once_with_its_bytes_and_layout(per_node, monkeypatch):
    scene = (_per_node_bowl(monkeypatch) if per_node
             else load_scene("menger"))
    before = counters()
    tables = SceneTables(scene, "cpu")
    grown = _grown(before)
    assert tables.brick_idx.shape[0] == (2 if per_node else 3)
    assert grown["scene.builds"] == 1
    assert grown["scene.table_bytes"] == sum(
        getattr(tables, name).nbytes for name in TABLES)
    assert grown["scene.per_node"] == per_node
    assert grown["scene.load_us"] == 0  # the grid was built before
    assert grown["scene.tables_us"] > 0 and grown["scene.upload_us"] > 0


def test_load_and_build_microseconds_grow():
    before = counters()
    scene = load_scene("8x8x8")
    loaded = _grown(before)
    assert loaded["scene.load_us"] > 0
    assert loaded["scene.builds"] == loaded["scene.tables_us"] == 0
    SceneTables(scene, "cpu")
    built = _grown(before)
    assert built["scene.load_us"] == loaded["scene.load_us"]
    assert built["scene.tables_us"] > 0 and built["scene.upload_us"] > 0
    assert all(v >= 0 for v in built.values())


def test_profiled_build_spans_nest():
    with torch.autograd.profiler.profile(use_kineto=True) as prof:
        SceneTables(load_scene("8x8x8"), "cpu")
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.function_events
                    if e.device_type == DeviceType.CPU
                    and e.name.startswith("vt.scene.")),
                   key=lambda s: s[1])
    assert [s[0] for s in spans] == SCENE_SPANS
    (_, t0, t1), = [s for s in spans if s[0] == "vt.scene.tables"]
    inside = [s[0] for s in spans if t0 <= s[1] and s[2] <= t1]
    assert inside == SCENE_SPANS[2:6]
    # each top-level span closes before the next opens
    top = [s for s in spans if s[0] not in SCENE_SPANS[3:6]]
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))


def test_build_spans_are_the_shared_noop_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a range built with the profiler off")

    monkeypatch.setattr(timing, "_RecordFunctionFast", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert timing.span("vt.scene.tables") is timing.span("vt.scene.upload")
    SceneTables(load_scene("8x8x8"), "cpu")


def test_cli_stats_prints_the_scene_build(tmp_path, capsys):
    assert cli.main(["--device", "cpu", "--scene", "8x8x8", "--size",
                     "16x12", "--frames", "1", "--stats",
                     "-o", str(tmp_path / "a.png")]) == 0
    got = {ln.split()[1].rstrip(":"): int(ln.split()[2])
           for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("  counter scene.")}
    assert set(got) == {k for k in counters() if k.startswith("scene.")}
    assert got["scene.builds"] == 1 and got["scene.per_node"] == 0
    assert got["scene.table_bytes"] > 0 and got["scene.load_us"] > 0
    assert got["scene.tables_us"] > 0
