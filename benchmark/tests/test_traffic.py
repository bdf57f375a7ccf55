"""The copied camera paths and the seeded traffic."""

import numpy as np
import pytest

from benchmark.harness import load_json
from benchmark.reference import tables as ref_tables
from benchmark.traffic import Traffic, load_path
from voxtracer_torch.app import camera_paths
from voxtracer_torch.engine.scene import load_scene

from .conftest import ROOT

TIMES = (0.0, 0.37, 1.0 / 60, 2.5, 7.9, 123.4)


@pytest.mark.parametrize("name,params,scene", [
    ("orbit", {"period": 8.0, "elevation": 0.45, "distance": 1.6}, "menger"),
    ("dolly", {"period": 6.0, "elevation": 0.35}, "monu9"),
])
def test_paths_equal_the_programs(name, params, scene):
    wmin, wmax = ref_tables.world_bounds(scene)
    ours = load_path({"name": name, **params}, wmin, wmax)
    theirs = camera_paths.PATHS[name](load_scene(scene), **params)
    for t in TIMES:
        pos, d = ours(t)
        cam = theirs(t)
        assert np.array_equal(pos, cam.position)
        assert np.array_equal(d, cam.direction)


@pytest.mark.parametrize("config", ["menger720-r0", "monu9-1080-r2"])
def test_config_bounds_are_the_grids(config):
    """The bounds a configuration's camera paths frame are its scene's
    grid's, as the reference builds it from the asset."""
    cfg = load_json(ROOT, "benchmark", "configs", config + ".json")
    wmin, wmax = ref_tables.world_bounds(cfg["scene"])
    assert cfg["world_min"] == wmin.tolist()
    assert cfg["world_max"] == wmax.tolist()


def test_fixed_path_is_the_bench_pose():
    wmin, wmax = ref_tables.world_bounds("menger")
    path = load_path({"name": "fixed", "position": [36.0, 34.0, -5.0],
                      "direction": [-16.0, -14.0, 25.0]}, wmin, wmax)
    for t in TIMES:
        pos, d = path(t)
        assert pos.tolist() == [36.0, 34.0, -5.0]
        assert d.tolist() == [-16.0, -14.0, 25.0]


SPEC = {"path": {"name": "orbit", "period": 8.0}, "frame_dt": 1 / 60,
        "segments": {"min": 60, "max": 240}}


def _runs(tr, n):
    """Lengths and kinds of the runs of frames 1..n-1."""
    kinds = [tr.moving(i) for i in range(1, n)]
    runs, start = [], 0
    for i in range(1, len(kinds) + 1):
        if i == len(kinds) or kinds[i] != kinds[start]:
            runs.append((i - start, kinds[start]))
            start = i
    return runs


def test_segments_are_seeded_and_in_range():
    wmin, wmax = ref_tables.world_bounds("menger")
    a = Traffic(SPEC, wmin, wmax, 2**31 + 7)
    b = Traffic(SPEC, wmin, wmax, 2**31 + 7)
    c = Traffic(SPEC, wmin, wmax, 5)
    n = 20000
    assert [a.time(i) for i in range(n)] == [b.time(i) for i in range(n)]
    assert [a.time(i) for i in range(n)] != [c.time(i) for i in range(n)]
    runs = _runs(a, n)[1:-1]  # whole runs only
    assert all(60 <= length <= 240 for length, _ in runs)
    assert all(k1 != k2 for (_, k1), (_, k2) in zip(runs, runs[1:]))
    held = sum(length for length, kind in runs if not kind)
    assert 0.4 < held / sum(length for length, _ in runs) < 0.6


def test_frames_advance_by_index():
    wmin, wmax = ref_tables.world_bounds("menger")
    tr = Traffic(SPEC, wmin, wmax, 11)
    for i in range(1, 3000):
        step = tr.time(i) - tr.time(i - 1)
        assert step == (SPEC["frame_dt"] if tr.moving(i) else 0.0) or \
            abs(step - SPEC["frame_dt"]) < 1e-9
    assert 0.0 <= tr.t0 < 8.0


def test_without_segments_every_frame_moves():
    wmin, wmax = ref_tables.world_bounds("monu9")
    tr = Traffic({"path": {"name": "dolly", "period": 6.0},
                  "frame_dt": 1 / 30}, wmin, wmax, 3)
    assert all(tr.moving(i) for i in range(500))
