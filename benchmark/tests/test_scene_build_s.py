"""The reader of the program's scene-build counters: the host seconds
of ``load_scene``, ``device_tables()`` and the tables' copies to the
device."""

import pytest

from benchmark import profiling
from benchmark.harness import Run
from benchmark.metrics import scene_build_s
from voxtracer_torch.engine import pipeline
from voxtracer_torch.utils import timing


def _run():
    return Run("cell", {}, {}, 1.0, 1.0, {},
               trace=profiling.Trace((0, 1e4), [], []))


def test_scene_build_s_reads_the_counters(monkeypatch):
    monkeypatch.setitem(timing.COUNTS, "scene.load_us", 1_200_000)
    monkeypatch.setitem(timing.COUNTS, "scene.tables_us", 10_500_000)
    monkeypatch.setitem(timing.COUNTS, "scene.upload_us", 300_000)
    # the other scene counts are no time
    monkeypatch.setitem(timing.COUNTS, "scene.table_bytes", 107_220_000)
    monkeypatch.setitem(timing.COUNTS, "scene.builds", 1)
    assert scene_build_s.read(_run()) == pytest.approx(12.0)


@pytest.mark.parametrize("missing", scene_build_s.KEYS)
def test_scene_build_s_finds_nothing_without_the_counters(monkeypatch,
                                                           missing):
    # a program older than the counters (the parent of the scene build's)
    monkeypatch.delitem(timing.COUNTS, missing)
    assert scene_build_s.read(_run()) is None


def test_scene_build_s_finds_nothing_without_a_counters_function(
        monkeypatch):
    monkeypatch.delattr(pipeline, "counters")
    assert scene_build_s.read(_run()) is None
