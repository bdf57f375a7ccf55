"""The denoiser's far end (``monu9-1080-r8.view``): its configuration is
the r=2 view's at radius 8, its traffic the r=2 view's key for key, its
entries in BENCHMARK.json are where the harness reads them, a frame
denoised at a smaller radius fails its check, the control fails its
limits, and ``denoise_occupancy`` reads the program's counters."""

import pytest
import torch

from benchmark import check, profiling
from benchmark.harness import Run, load_json, run_cell
from benchmark.metrics import denoise_occupancy
from benchmark.reference import frame as ref_frame
from benchmark.reference import noise as ref_noise
from benchmark.reference import tables as ref_tables
from voxtracer_torch.engine import pipeline
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.pipeline import Renderer
from voxtracer_torch.engine.scene import load_scene
from voxtracer_torch.ops import denoise as denoise_op
from voxtracer_torch.utils import timing

from .conftest import ROOT
from .test_faults import SEED, seconds
from .test_reference import _poses, _Snap

CELL = "monu9-1080-r8.view"
PAIR = "monu9-1080-r2.view"
H = W = 64
# the metrics of the view cells, each of which lists the cell
VIEW_METRICS = (
    "latency_p95_ms", "render_call_us", "fetch_wait_us", "trace_ms",
    "trace_roofline", "temporal_roofline", "denoise_roofline",
    "epilogue_roofline", "device_idle_share", "launches_per_frame",
    "direct_frame_share", "scene_build_s", "fetch_stream_share")


def _cell(name=CELL):
    wl = load_json(ROOT, "benchmark", "workloads", name + ".json")
    return wl, load_json(ROOT, "benchmark", "configs", wl["config"] + ".json")


def test_cell_agrees_with_benchmark_json():
    bench = load_json(ROOT, "BENCHMARK.json")
    wl, cfg = _cell()
    entry, = [c for c in bench["configs"] if c["name"] == cfg["name"]]
    assert entry["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert entry["reduced"] == cfg["reduced"] == []
    assert "shaders/denoise.comp" in entry["source"]
    cell, = [c for c in bench["workloads"] if c["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        cfg["name"], wl["traffic"]["driver"], 1) == (
            "monu9-1080-r8", "view", 1)
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in VIEW_METRICS:
        assert CELL in metrics[name]["workloads"], name
        assert PAIR in metrics[name]["workloads"], name
    occupancy = metrics["denoise_occupancy"]
    assert (occupancy["unit"], occupancy["better"], occupancy["source"],
            occupancy["layer"], occupancy["moves"]) == (
                "%", "higher", "program_counter", "denoise stage", "frame_ms")
    assert occupancy["workloads"] == ["monu9-1080-r2.view",
                                      "monu9-1080-r2.export",
                                      "default1080-r2.view", CELL]


def test_pair_differs_in_the_radius_alone():
    """The traffic is the r=2 view's, key for key; the configurations
    differ in ``denoise_radius`` and ``name`` alone."""
    wl, cfg = _cell()
    wl2, cfg2 = _cell(PAIR)
    assert wl["traffic"] == wl2["traffic"]
    assert wl["trace"] == wl2["trace"]
    assert {k: v for k, v in wl["check"].items() if k != "limits"} == {
        k: v for k, v in wl2["check"].items() if k != "limits"}
    assert cfg.keys() == cfg2.keys()
    assert {k for k in cfg if cfg[k] != cfg2[k]} == {"denoise_radius",
                                                     "name"}
    assert (cfg["denoise_radius"], cfg2["denoise_radius"]) == (8, 2)


def denoised_at_radius_2(r):
    """Every frame denoised at the r=2 cell's radius."""
    r.denoise_radius = 2


@pytest.mark.parametrize("fault", [None, denoised_at_radius_2],
                         ids=["sound", "radius-2"])
def test_a_smaller_radius_fails_image_off(fault, tiny_root):
    """A whole run on the CPU at the tiny size, at the seed and window
    of ``test_faults`` (the r=2 view's traffic keeps the same units):
    sound, both numbers 0; with every frame denoised at radius 2,
    ``image_off`` beyond its limit, and the carried state, which the
    denoise does not touch, still equal."""
    res = run_cell(CELL, SEED, seconds(CELL), False, device="cpu",
                   root=tiny_root, hook=fault)
    checks = res["checks"]
    assert checks["state_off"]["value"] == 0, checks
    if fault is None:
        assert res["correct"], checks
        assert checks["image_off"]["value"] == 0
    else:
        assert not res["correct"], checks
        assert checks["image_off"]["value"] > checks["image_off"]["limit"]


def test_radius_7_is_within_a_level_of_radius_8():
    """What the check cannot see: at the default sigma_distance of 2 the
    taps of the stencil's outer ring (dx^2 + dy^2 >= 64) weigh at most
    e^-8 of the centre tap, so a frame denoised at radius 7 lies within
    one u8 level of radius 8's and ``image_off`` (values more than 1
    apart) reads 0 for it; radius 2's frame does not."""
    tables = ref_tables.Tables(ref_tables.load_grid("monu9"), "cpu")
    noise = torch.from_numpy(ref_noise.blue_noise_buffer())
    state = check.fresh_state(W, H, "cpu")
    cams = [ref_frame.camera_rows(p, d, W, H) for p, d in _poses("monu9")]
    frames = list(range(1, len(cams) + 1))
    traces = ref_frame.trace_batch(tables, noise, cams, frames, H, W)
    images = {r: ref_frame.render_frames(tables, noise, state, cams, frames,
                                         r, traces=traces)[0]
              for r in (2, 7, 8)}
    for a, b in zip(images[7], images[8]):
        assert int((a.int() - b.int()).abs().max()) <= 1
        assert check.image_off(a, b) == 0
    assert all(check.image_off(a, b) > 0.01
               for a, b in zip(images[2], images[8]))


def test_control_fails_the_r8_cells_limits():
    """As ``test_reference.test_control_fails_the_limits``: at 64x64,
    two frames from the program's state; one of the cell's numbers
    beyond its limit for the control, the program's own frames within
    them."""
    wl, cfg = _cell()
    radius = cfg["denoise_radius"]
    r = Renderer(scene=load_scene("monu9"), height=H, width=W, device="cpu",
                 denoise_radius=radius, lean=True)
    poses = _poses("monu9")
    r.render(Camera(position=poses[0][0], direction=poses[0][1]))
    snap = _Snap(dict(r.state), poses[1:3], 2, poses[0])
    snap.images = [r.render(Camera(position=p, direction=d))["image"]
                   for p, d in poses[1:3]]
    snap.state_after = dict(r.state)
    tables = ref_tables.Tables(ref_tables.load_grid("monu9"), "cpu")
    noise = torch.from_numpy(ref_noise.blue_noise_buffer())
    cams, frames, params = check.frame_jobs(snap, W, H)
    traces = ref_frame.trace_batch(tables, noise, cams, frames, H, W,
                                   params=params)
    got = check.compare_frames(tables, noise, snap, radius, traces,
                               lowp=True)
    sound = check.compare_frames(tables, noise, snap, radius, traces)
    limits = wl["check"]["limits"]
    assert any(got[k] > limits[k] for k in limits), got
    assert all(sound[k] == 0 for k in limits), sound


def _run():
    return Run("cell", {}, {}, 1.0, 1.0, {},
               trace=profiling.Trace((0, 1e4), [], []))


@pytest.mark.parametrize("launches, warps, share", [
    (10, 240, 37.5),  # r = 8: 3 blocks of 8 warps an SM
    (10, 400, 62.5),  # 5 blocks
    (3, 64 * 3, 100.0),
], ids=["r8", "r2", "full"])
def test_denoise_occupancy_reads_the_counters(monkeypatch, launches, warps,
                                              share):
    monkeypatch.setattr(denoise_op.denoise_cuda, "launches", launches)
    monkeypatch.setitem(timing.COUNTS, "denoise.resident_warps", warps)
    assert denoise_occupancy.read(_run()) == pytest.approx(share)


def test_denoise_occupancy_finds_nothing_without_the_counter(monkeypatch):
    # a program older than the counter
    monkeypatch.setattr(denoise_op.denoise_cuda, "launches", 10)
    monkeypatch.delitem(timing.COUNTS, "denoise.resident_warps")
    assert denoise_occupancy.read(_run()) is None
    # no denoise launch (radius 0, or the CPU)
    monkeypatch.setitem(timing.COUNTS, "denoise.resident_warps", 0)
    monkeypatch.setattr(denoise_op.denoise_cuda, "launches", 0)
    assert denoise_occupancy.read(_run()) is None
    monkeypatch.delattr(pipeline, "counters")
    assert denoise_occupancy.read(_run()) is None
