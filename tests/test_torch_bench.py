"""The port's BASELINE harness (``voxtracer_torch.app.bench``) and
``phasestats`` on the CPU: the plain versions at sizes shrunk through
the harness's ``SIZES`` table.  Timings here are host numbers of the
plain versions and are not checked; keys, exact ray counts, the oracle
gate and the exit code are."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from voxtracer_torch.app import bench, camera_paths, phasestats
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.params import RenderParams, pack_trace_params
from voxtracer_torch.engine.scene import SceneTables, available_scenes, load_scene
from voxtracer_torch.ops import trace
from voxtracer_torch.ops.noise import white_noise_buffer

# config 1 at its --quick size; the frame configs at a few dozen pixels
TINY = {
    1: {"hw": (256, 256), "quick_hw": (128, 128)},
    2: {"hw": (6, 8), "frames": 1},
    3: {"hw": (6, 8), "frames": 1},
    4: {"hw": (6, 8), "frames": 1},
    5: {"hw": (6, 8), "frames": 1},
    6: {"hw": (4, 6), "frames": 0, "crop": (4, 6)},
}
RATE = {"ms_per_frame", "fps", "rays_per_frame", "mrays_per_s"}
# the reference harness's keys per config (voxtracer/app/bench.py), plus
# the device
KEYS = {
    1: {"resolution", "node_agreement", "color_psnr_db"},
    2: RATE,
    3: RATE | {"reprojection_accepted"},
    4: RATE | {"standalone_stage_ms_incl_dispatch"},
    5: RATE,
    6: {"resolution", "ms_per_frame", "fps", "fuse_pixels", "node_agreement"},
}
MENGER = Camera(position=np.array([36.0, 34.0, -5.0]),
                direction=np.array([-16.0, -14.0, 25.0]))


def _main(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--device", "cpu", "--quick", *argv])
    rows = [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.startswith("{")]
    return rc, rows


@pytest.fixture(scope="module")
def harness():
    """One run of every config at the shrunk sizes."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "SIZES", TINY)
        return _main()


def _by_config(rows):
    out = {}
    for r in rows:
        out.setdefault(r["config"], []).append(r)
    return out


def test_every_config_prints_the_reference_keys(harness):
    rc, rows = harness
    assert rc == 0
    by = _by_config(rows)
    assert sorted(by) == [1, 2, 3, 4, 5, 6]
    assert len(by[6]) == len(available_scenes()) == 15
    for config, config_rows in by.items():
        for r in config_rows:
            assert set(r) == KEYS[config] | {"config", "name", "device"}, r
            assert r["device"] == "cpu"
    stages = by[4][0]["standalone_stage_ms_incl_dispatch"]
    assert set(stages) == {"temporal_reproject", "denoise_r2", "tonemap_u8"}
    assert all(v > 0 for v in stages.values())
    for config in (2, 3, 4, 5):
        r = by[config][0]
        assert r["rays_per_frame"] > 0 and r["ms_per_frame"] > 0
    assert 0.0 <= by[3][0]["reprojection_accepted"] <= 1.0


def test_config1_agrees_with_the_oracle(harness):
    """Measured at 128x128: every node id equal (0 px differ)."""
    (row,) = _by_config(harness[1])[1]
    assert row["resolution"] == "128x128"
    assert row["node_agreement"] >= 0.999
    assert round((1.0 - row["node_agreement"]) * 128 * 128) == 0
    assert row["color_psnr_db"] > 60.0


def test_config6_sweep_agrees_with_the_oracle(harness):
    """Measured on the 4x6 crop of every asset: 0 px differ, no pixel
    hits the step cap at 6x4."""
    for row in _by_config(harness[1])[6]:
        assert row["node_agreement"] == 1.0, row
        assert row["fuse_pixels"] == 0, row


def test_rays_per_frame_is_the_trace_count(harness):
    """Config 2's rays are the trace's per-phase counts of one sample
    (white noise of seed 7, frame 1) at the config's size."""
    (row,) = _by_config(harness[1])[2]
    h, w = TINY[2]["hw"]
    out = trace.render_sample(
        SceneTables(load_scene("menger"), "cpu"),
        pack_trace_params(MENGER.rows(w, h), RenderParams()),
        torch.from_numpy(white_noise_buffer(seed=7)), 1, h, w,
    )
    assert row["rays_per_frame"] == int(out["rays"].sum())


def test_phase_stats_rows_sum_to_the_trace_rays():
    scene = load_scene("chr_knight")
    cam = camera_paths.orbit(scene)(0.0)
    h, w = 12, 16
    rows = phasestats.phase_stats(scene, cam, h, w, torch.device("cpu"))
    out = phasestats.render_one_sample(scene, cam, h, w, torch.device("cpu"))
    assert [r["phase"] for r in rows] == phasestats.PHASES
    assert sum(r["rays"] for r in rows) == int(out["rays"].sum())
    rays = {r["phase"]: r["rays"] for r in rows}
    hits = int((out["depth"] >= 0).sum())
    assert rays["b0"] == h * w  # every pixel's primary ray
    assert rays["b1"] == hits > 0  # every primary hit bounces
    assert 0 < rays["s0"] <= hits  # shadow rays: a subset of the hits


def test_phasestats_cli(capsys):
    assert phasestats.main(["--scene", "8x8x8", "--size", "8x6",
                            "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines[2:]] == phasestats.PHASES + ["total"]


def test_a_failing_config_fails_the_harness(monkeypatch):
    """The failing config prints its error line, the rest still run, and
    the harness exits non-zero."""
    def boom(device, quick=False):
        raise RuntimeError("device path broken")
        yield  # a generator, as every config

    monkeypatch.setattr(bench, "SIZES", TINY)
    monkeypatch.setattr(bench, "CONFIGS",
                        {1: bench.config1_oracle_match, 2: boom})
    rc, rows = _main()
    assert rc == 1
    assert rows[0]["config"] == 1 and "error" not in rows[0]
    assert rows[1] == {"config": 2, "error": "RuntimeError: device path broken",
                       "device": "cpu"}


def test_harness_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(SystemExit, match="cuda"):
        bench.main(["--only", "1"])
