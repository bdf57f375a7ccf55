import os
import sys

# the checkout's root, so that ``benchmark`` and ``voxtracer_torch``
# import when the tests run from anywhere
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import json  # noqa: E402

import pytest  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ("menger720-r0.view", "monu9-1080-r2.view", "menger720-r0.burst",
         "monu9-1080-r2.export", "castle4k-r0.sun")


def shrink(root_out):
    """The benchmark's data files at a size the CPU runs: 32x16 frames,
    segments of 2-4 frames, bursts of 4, batches of 3, 100 checked
    pixels, a traced stretch of 2 units.  The cells, their checks and
    limits are the benchmark's own."""
    os.makedirs(os.path.join(root_out, "benchmark", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root_out, "benchmark", "workloads"),
                exist_ok=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(root_out, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["width"], cfg["height"] = 32, 16
        with open(os.path.join(root_out, c["file"]), "w") as f:
            json.dump(cfg, f)
    for c in bench["workloads"]:
        name = os.path.join("benchmark", "workloads", c["name"] + ".json")
        with open(os.path.join(ROOT, name)) as f:
            wl = json.load(f)
        t = wl["traffic"]
        if "segments" in t:
            t["segments"] = {"min": 2, "max": 4}
        if "burst" in t:
            t["burst"] = 4
            wl["check"]["pixels"] = 100
        if "batch" in t:
            t["batch"] = 3
        wl["trace"] = {"units": 2, "picks": 1}
        with open(os.path.join(root_out, name), "w") as f:
            json.dump(wl, f)
    return root_out


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return shrink(str(tmp_path_factory.mktemp("tiny")))
