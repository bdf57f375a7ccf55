"""The default scene's cell (``default1080-r2.view``): its
configuration frames the bowl's grid, and the control (the reference in
bfloat16 in the program's place) fails its limits."""

import torch

from benchmark import check
from benchmark.harness import load_json
from benchmark.reference import frame as ref_frame
from benchmark.reference import noise as ref_noise
from benchmark.reference import tables as ref_tables
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.pipeline import Renderer
from voxtracer_torch.engine.scene import load_scene

from .conftest import ROOT
from .limits import time_limit
from .test_reference import LOOSE_S, _poses, _Snap

CELL = "default1080-r2.view"
H = W = 64


def _cell():
    wl = load_json(ROOT, "benchmark", "workloads", CELL + ".json")
    return wl, load_json(ROOT, "benchmark", "configs", wl["config"] + ".json")


def test_default_config_bounds_are_the_bowls_grid():
    _, cfg = _cell()
    assert cfg["scene"] == "default" and cfg["reduced"] == []
    wmin, wmax = ref_tables.world_bounds("default")
    assert cfg["world_min"] == wmin.tolist() == [-128.0, -128.0, -128.0]
    assert cfg["world_max"] == wmax.tolist() == [132.0, 4.0, 132.0]
    entry, = [c for c in load_json(ROOT, "BENCHMARK.json")["configs"]
              if c["name"] == cfg["name"]]
    assert entry["file"] == f"benchmark/configs/{cfg['name']}.json"


def test_control_fails_the_default_cells_limits():
    """As ``test_reference.test_control_fails_the_limits`` for the other
    cells: at 64x64, one of the cell's numbers beyond its limit, and the
    program's own frames within them."""
    wl, cfg = _cell()
    radius = cfg["denoise_radius"]
    with time_limit(LOOSE_S):
        r = Renderer(scene=load_scene("default"), height=H, width=W,
                     device="cpu", denoise_radius=radius, lean=True)
        poses = _poses("default")
        r.render(Camera(position=poses[0][0], direction=poses[0][1]))
        snap = _Snap(dict(r.state), poses[1:3], 2, poses[0])
        snap.images = [r.render(Camera(position=p, direction=d))["image"]
                       for p, d in poses[1:3]]
        snap.state_after = dict(r.state)
        tables = ref_tables.Tables(ref_tables.load_grid("default"), "cpu")
        assert not tables.brick_dedup
        noise = torch.from_numpy(ref_noise.blue_noise_buffer())
        cams, frames, params = check.frame_jobs(snap, W, H)
        traces = ref_frame.trace_batch(tables, noise, cams, frames, H, W,
                                       params=params)
        got = check.compare_frames(tables, noise, snap, radius, traces,
                                   lowp=True)
        sound = check.compare_frames(tables, noise, snap, radius, traces)
    limits = wl["check"]["limits"]
    assert any(got[k] > limits[k] for k in limits), got
    assert all(sound[k] <= limits[k] for k in limits), sound
