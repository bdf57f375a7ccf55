"""The harness finds what it runs by name, and refuses to run without a
card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import cell_metrics, load_json
from benchmark.reference import tables as ref_tables

from .conftest import ROOT, shrink

DUMMY_METRIC = '''"""A test's metric: the frames delivered in the window."""


def read(run):
    return float(len(run.delivered()) * run.record["frames_per_unit"])
'''


def test_added_files_are_found_without_an_edit(tmp_path):
    """A configuration, a traffic mix and a metric, each added as a file
    with an entry in BENCHMARK.json, run in a copy of the benchmark."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    os.symlink(os.path.join(ROOT, "assets"), os.path.join(root, "assets"))
    shrink(root)
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
    with open(os.path.join(root, "benchmark/configs/knight-dummy.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "benchmark/workloads/knight-dummy.view.json"),
              "w") as f:
        json.dump(wl, f)
    with open(os.path.join(root, "benchmark/metrics/dummy_frames.py"),
              "w") as f:
        f.write(DUMMY_METRIC)
    bench = load_json(root, "BENCHMARK.json")
    bench["configs"].append({"name": "knight-dummy", "source": "a test",
                             "file": "benchmark/configs/knight-dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "knight-dummy.view",
                               "config": "knight-dummy", "traffic": "view",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_frames", "unit": "frames",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["knight-dummy.view"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from benchmark.harness import run_cell; "
            "print(json.dumps(run_cell('knight-dummy.view', 5, 4.0, False, "
            "'cpu')))")
    out = subprocess.run([sys.executable, "-c", code, root, ROOT],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["metrics"]["dummy_frames"]["value"] > 0
    assert set(res["metrics"]) == {"frame_ms", "setup_s", "dummy_frames"}


def test_cell_metrics_follow_benchmark_json():
    bench = load_json(ROOT, "BENCHMARK.json")
    for cell in (c["name"] for c in bench["workloads"]):
        e2e = {m["name"] for m in cell_metrics(bench, cell, False)}
        assert {"frame_ms", "setup_s"} <= e2e
        assert ("latency_p95_ms" in e2e) == cell.endswith(".view")
        per = {m["name"] for m in cell_metrics(bench, cell, True)}
        assert {"trace_ms", "trace_roofline", "device_idle_share"} <= per
    assert not [m for m in bench["per_layer"] if m["moves"] != "frame_ms"]


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
