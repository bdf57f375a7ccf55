"""The harness finds what it runs by name, and refuses to run without a
card."""

import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from benchmark.harness import (
    cell_metrics,
    forbidden_modules,
    load_json,
    run_cell,
)
from benchmark.reference import tables as ref_tables

from .conftest import ROOT, shrink

DUMMY_METRIC = '''"""A test's metric: the frames delivered in the window."""


def read(run):
    return float(len(run.delivered()) * run.record["frames_per_unit"])
'''


def _benchmark_copy(tmp_path) -> str:
    """The benchmark copied at the CPU's size (``shrink``), the assets
    beside it."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    os.symlink(os.path.join(ROOT, "assets"), os.path.join(root, "assets"))
    shrink(root)
    return root


def _add_cell(root, cfg, wl, metrics=()):
    """A configuration and a cell, each added as a file with an entry
    in BENCHMARK.json, with ``metrics`` added to its end-to-end ones."""
    cell = cfg["name"] + "." + wl["traffic"]["driver"]
    with open(os.path.join(root, "benchmark/configs", cfg["name"] + ".json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "benchmark/workloads", cell + ".json"),
              "w") as f:
        json.dump(wl, f)
    bench = load_json(root, "BENCHMARK.json")
    bench["configs"].append({"name": cfg["name"], "source": "a test",
                             "file": f"benchmark/configs/{cfg['name']}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": cell, "config": cfg["name"],
                               "traffic": wl["traffic"]["driver"],
                               "chips": 1, "why": "a test"})
    bench["end_to_end"] += [dict(m, workloads=[cell]) for m in metrics]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return cell


def _run_cell(root, cell, seconds, timeout):
    """``run_cell`` on the CPU in a fresh interpreter, from ``root``."""
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from benchmark.harness import run_cell; "
            f"print(json.dumps(run_cell({cell!r}, 5, {seconds!r}, False, "
            "'cpu')))")
    out = subprocess.run([sys.executable, "-c", code, root, ROOT],
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_added_files_are_found_without_an_edit(tmp_path):
    """A configuration, a traffic mix and a metric, each added as a file
    with an entry in BENCHMARK.json, run in a copy of the benchmark."""
    root = _benchmark_copy(tmp_path)
    wmin, wmax = ref_tables.world_bounds("chr_knight")
    cfg = {"name": "knight-dummy", "scene": "chr_knight", "width": 24,
           "height": 16, "denoise_radius": 1, "reduced": [],
           "world_min": wmin.tolist(), "world_max": wmax.tolist()}
    wl = {"config": "knight-dummy", "why": "a test",
          "traffic": {"driver": "view",
                      "path": {"name": "orbit", "period": 8.0},
                      "frame_dt": 1 / 60, "segments": {"min": 2, "max": 3}},
          "check": {"moving": 1, "limits": {"image_off": 0.001,
                                            "state_off": 0.001}},
          "trace": {"units": 2, "picks": 1}}
    with open(os.path.join(root, "benchmark/metrics/dummy_frames.py"),
              "w") as f:
        f.write(DUMMY_METRIC)
    cell = _add_cell(root, cfg, wl, [
        {"name": "dummy_frames", "unit": "frames", "better": "higher",
         "bound": 0.25, "source": "host_clock"}])
    res = _run_cell(root, cell, 4.0, 600)
    assert res["correct"], res["checks"]
    assert res["metrics"]["dummy_frames"]["value"] > 0
    assert set(res["metrics"]) == {"frame_ms", "setup_s", "dummy_frames"}


def test_added_default_scene_is_checked_without_an_edit(tmp_path):
    """A configuration that names the procedural scene, added as files
    alone: the reference builds the 520x264x520 bowl and finds every
    frame and state plane equal to the program's.  A frame takes about
    half a second on the CPU alone and longer beside the other tests'
    workers (``-n 4``), so the window leaves room for both of the check's
    units."""
    root = _benchmark_copy(tmp_path)
    wmin, wmax = ref_tables.world_bounds("default")
    cfg = {"name": "default-dummy", "scene": "default", "width": 24,
           "height": 16, "denoise_radius": 2, "reduced": [],
           "world_min": wmin.tolist(), "world_max": wmax.tolist()}
    wl = {"config": "default-dummy", "why": "a test",
          "traffic": {"driver": "view",
                      "path": {"name": "orbit", "period": 8.0,
                               "elevation": 0.45, "distance": 1.6},
                      "frame_dt": 1 / 60, "segments": {"min": 3, "max": 4}},
          "check": {"moving": 1, "held": 1,
                    "limits": {"image_off": 0.001, "state_off": 0.05}},
          "trace": {"units": 2, "picks": 1}}
    res = _run_cell(root, _add_cell(root, cfg, wl), 24.0, 300)
    assert res["correct"], res["checks"]
    assert res["checks"]["image_off"]["value"] == 0
    assert res["checks"]["state_off"]["value"] == 0
    assert set(res["metrics"]) == {"frame_ms", "setup_s"}


def test_cell_metrics_follow_benchmark_json():
    """Every cell reports ``frame_ms`` and ``setup_s``; ``latency_p95_ms``
    exactly the cells of its list, which are the closed-loop viewers (the
    ``view`` driver); and each per-layer metric only in cells that carry
    the end-to-end metric it moves."""
    bench = load_json(ROOT, "BENCHMARK.json")
    latency, = [m for m in bench["end_to_end"]
                if m["name"] == "latency_p95_ms"]
    viewers = {c["name"] for c in bench["workloads"]
               if load_json(ROOT, "benchmark", "workloads", c["name"]
                            + ".json")["traffic"]["driver"] == "view"}
    assert set(latency["workloads"]) == viewers
    for cell in (c["name"] for c in bench["workloads"]):
        e2e = {m["name"] for m in cell_metrics(bench, cell, False)}
        assert {"frame_ms", "setup_s"} <= e2e
        assert ("latency_p95_ms" in e2e) == (cell in latency["workloads"])
        per = cell_metrics(bench, cell, True)
        assert {"trace_ms", "trace_roofline", "device_idle_share"} <= {
            m["name"] for m in per}
        assert all(m["moves"] in e2e for m in per), cell


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", "menger720-r0.view", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names():
    found = forbidden_modules(dict.fromkeys([
        "voxtracer_torch", "voxtracer_torch.engine", "jaxtyping", "flaxen",
        "numpy", "jax.numpy", "jaxlib", "flax.linen", "voxtracer",
        "voxtracer.scene.grid"]))
    assert found == ["flax.linen", "jax.numpy", "jaxlib", "voxtracer",
                     "voxtracer.scene.grid"]


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_client", "flax",
                                  "voxtracer.scene"])
def test_refuses_a_run_that_loaded_jax(name, tiny_root, monkeypatch):
    """A module of JAX or of the JAX package in the run's process once
    the window has closed: the run gives no result."""
    def plant(renderer):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))

    with pytest.raises(RuntimeError, match=re.escape(name)):
        run_cell("menger720-r0.burst", 2**31 + 5, 2.0, False, device="cpu",
                 root=tiny_root, hook=plant)
