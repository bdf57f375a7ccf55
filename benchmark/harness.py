"""The benchmark of the PyTorch and CUDA port (``voxtracer_torch``).

One run of one cell: ``run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.  Everything is found by name:

* ``benchmark/workloads/<cell>.json``: the cell's configuration, its
  traffic (driver kind, camera path and parameters, segment rule or a
  held camera, a stepped sun, burst or batch length), its check and the
  check's limits;
* ``benchmark/configs/<config>.json``: scene, size, denoise radius;
* ``benchmark/drivers/<kind>.py``: the loop that drives the program;
* ``benchmark/paths/<name>.py``: a camera path;
* ``benchmark/metrics/<metric>.py``: one reader a metric, which takes
  the run (:class:`Run`) and returns a number, or None where it finds
  nothing to read;
* ``BENCHMARK.json``: which metrics a cell reports.

A run: set-up (the program's scene, the ``Renderer``, the warm-up of
the cell's loop in ``benchmark/drivers/``, whose first frames build and
capture whatever the cell's frames use), then the window of
``--seconds``; with ``--trace 1`` a traced stretch of the same loop
under the profiler follows.  Then the card's power limit is read, the
program's renderer is freed and the reference checks the warm-up's
frames (from a fresh state of its own) and the units kept during the
window.  The last line of standard output is the result; a run whose
process holds a module of JAX or of the JAX package (``voxtracer``) at
its end prints none and exits with an error.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "benchmark")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: with ``trace`` its per-layer ones,
    otherwise its end-to-end ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "unread"


@dataclasses.dataclass
class Pick:
    """A traced frame whose trace and epilogue are counted: its
    position among the traced window's frames and what the reference
    read of it."""

    position: int
    rays: np.ndarray
    steps: np.ndarray
    depth: object  # (H, W) tensor
    kept: object  # (H, W) bool tensor
    history_valid: bool


@dataclasses.dataclass
class Run:
    """What the readers read."""

    cell: str
    workload: dict
    config: dict
    seconds: float
    setup_s: float
    record: dict
    trace: Optional[object] = None  # profiling.Trace
    picks: List[Pick] = dataclasses.field(default_factory=list)

    @property
    def height(self) -> int:
        return int(self.config["height"])

    @property
    def width(self) -> int:
        return int(self.config["width"])

    @property
    def radius(self) -> int:
        return int(self.config["denoise_radius"])

    def delivered(self) -> List[int]:
        """Indices of the units whose frames reached the host inside
        the window."""
        t_end = self.record["t_end"]
        return [j for j, t in enumerate(self.record["ready"]) if t <= t_end]


# top-level names that no module in a run's process may have: JAX and
# its libraries, and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "voxtracer")


def forbidden_modules(modules=None) -> List[str]:
    """The names in ``modules`` (``sys.modules`` by default) whose
    top-level name, the part before the first dot, is one of
    ``FORBIDDEN_MODULES``: ``voxtracer_torch`` is not ``voxtracer``."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules)
                  if m.split(".")[0] in FORBIDDEN_MODULES)


def check_draws(workload: dict, seed: int):
    """The window fractions at which units are kept for the check, and
    which kind each must be, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    spec = workload["check"]
    kinds = []
    for kind in ("moving", "held"):
        kinds += [kind] * int(spec.get(kind, 0))
    kinds += ["any"] * int(spec.get("calls", 0) + spec.get("batches", 0))
    fracs = rng.uniform(0.05, 0.9, size=len(kinds))
    return [(float(f), k) for f, k in zip(fracs, kinds)]


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             control: bool = False,
             hook: Optional[Callable] = None, root: str = ROOT) -> dict:
    """One run of ``cell``; returns the result object.  ``hook(renderer)``
    may wrap the program before the warm-up (the tests' planted
    faults); ``control`` also reads the control's numbers and verdict
    (``control_correct``); ``root``: the checkout whose
    ``BENCHMARK.json`` and ``benchmark/`` data files are read."""
    import torch

    from .traffic import Traffic

    t0 = time.perf_counter() if t0 is None else t0
    bench = load_json(root, "BENCHMARK.json")
    wl = load_json(root, "benchmark", "workloads", cell + ".json")
    cfg = load_json(root, "benchmark", "configs", wl["config"] + ".json")
    from voxtracer_torch.engine.pipeline import Renderer
    from voxtracer_torch.engine.scene import load_scene

    log(f"program imported {time.perf_counter() - t0:.3f} s")
    h, w, radius = int(cfg["height"]), int(cfg["width"]), int(
        cfg["denoise_radius"])
    traffic = Traffic(wl["traffic"], cfg["world_min"], cfg["world_max"], seed)
    scene = load_scene(cfg["scene"])
    log(f"scene {time.perf_counter() - t0:.3f} s")
    renderer = Renderer(scene=scene, height=h, width=w,
                        device=device, denoise_radius=radius, lean=True)
    log(f"renderer {time.perf_counter() - t0:.3f} s")
    if hook is not None:
        hook(renderer)
    kind = wl["traffic"]["driver"]
    drivers = importlib.import_module(f"benchmark.drivers.{kind}")
    driver = drivers.Driver(renderer, traffic, wl)
    driver.warm()
    cuda = renderer.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    log(f"set-up {setup_s:.3f} s")
    draws = check_draws(wl, seed)
    record = driver.run(seconds, draws)
    if cuda:
        torch.cuda.synchronize()
    t_phase = time.perf_counter()
    run = Run(cell, wl, cfg, seconds, setup_s, record)

    picks = []
    if trace:
        run.trace, picks = traced_stretch(driver, drivers.SPANS, wl["trace"],
                                          seed, cuda)
        log(f"traced stretch and its reading "
            f"{time.perf_counter() - t_phase:.3f} s")
        t_phase = time.perf_counter()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    # the warm-up's frames, which start from a fresh state, come first
    snapshots = [driver.warm_unit] + record["snapshots"]
    del driver, renderer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    from . import check

    results, control_results, pick_traces = reference_check(
        cfg, wl, snapshots, picks, seed, control, device)
    log(f"check {time.perf_counter() - t_phase:.3f} s")
    limits = wl["check"]["limits"]
    numbers, correct, failed = check.verdict(results, limits,
                                             1 + len(draws))
    if trace:
        run.picks = count_picks(picks, pick_traces, h, w)

    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    result = {
        "correct": bool(correct),
        "attempted": sum(record["frames_per_unit"] for _ in run.delivered()),
        "failed": failed,
        "metrics": metrics,
        "device": device_info(device, memory_peak, run),
    }
    if control:
        cn, result["control_correct"], _ = check.verdict(
            control_results, limits, 1 + len(draws))
        checks.update({"control_" + k: {"value": cn[k], "limit": limits[k]}
                       for k in limits})
    if trace and run.trace is not None:
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.top_ops(10)],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_by_span(10)],
        }
    result["checks"] = checks
    # once the window has closed and every reader has run, in the process
    # that prints the result: a run that loaded JAX or the JAX package
    # gives no result
    found = forbidden_modules()
    if found:
        log(f"refused: modules of JAX or the JAX package loaded: "
            f"{', '.join(found)}")
        raise RuntimeError(f"forbidden modules loaded: {', '.join(found)}")
    return result


def traced_stretch(driver, span_names, tspec: dict, seed: int, cuda: bool):
    """``tspec["units"]`` more units of the cell's loop under the
    profiler, ``tspec["picks"]`` of them (drawn from the seed) kept for
    the counts of their first frame; returns ``(Trace, picks)``."""
    import torch

    from . import profiling

    rng = np.random.default_rng([seed, 2])
    pick_units = sorted(int(u) for u in rng.choice(
        tspec["units"], size=tspec["picks"], replace=False))
    with torch.autograd.profiler.profile(
            use_device="cuda" if cuda else None, use_kineto=True) as prof:
        with torch.autograd.profiler.record_function(profiling.RANGE):
            picks = driver.traced(tspec["units"], pick_units)
            if cuda:
                torch.cuda.synchronize()
    return profiling.Trace.from_profiler(prof, span_names), picks


def reference_check(cfg: dict, wl: dict, snapshots, picks, seed: int,
                    control: bool, device: str):
    """The reference over the kept units (and, with ``control``, the
    control too): ``(results, control_results, pick_traces)``, one
    result a unit and the reference's trace of each picked frame.  A
    unit without ``state_before`` (the warm-up's) starts from the
    reference's own fresh state."""
    import torch

    from . import check
    from .reference import frame as ref_frame
    from .reference import noise as ref_noise
    from .reference import tables as ref_tables

    h, w, radius = (int(cfg[k]) for k in ("height", "width",
                                          "denoise_radius"))
    burst = wl["traffic"]["driver"] == "burst"
    tables = ref_tables.Tables(ref_tables.load_grid(cfg["scene"]), device)
    noise = torch.from_numpy(ref_noise.blue_noise_buffer()).to(device)
    # every whole frame the check and the counts need, traced together:
    # a trace call lasts as long as its slowest ray
    jobs = [] if burst else [check.frame_jobs(s, w, h) for s in snapshots]
    jobs += [check.frame_jobs(snap, w, h) for _, snap in picks]
    traces = ref_frame.trace_batch(
        tables, noise, [c for cams, _, _ in jobs for c in cams],
        [f for _, frames, _ in jobs for f in frames], h, w,
        params=[p for _, _, ps in jobs for p in ps]) if jobs else []
    units = []
    for cams, _, _ in jobs:
        units.append(traces[:len(cams)])
        traces = traces[len(cams):]
    results, control_results = [], []
    for j, snap in enumerate(snapshots):
        for lowp in (False, True) if control else (False,):
            if burst:
                r = check.compare_burst(
                    tables, noise, snap, int(wl["traffic"]["burst"]),
                    int(wl["check"]["pixels"]), seed + j, h, w, lowp=lowp)
            else:
                r = check.compare_frames(tables, noise, snap, radius,
                                         units[j], lowp=lowp)
            (control_results if lowp else results).append(r)
    return results, control_results, units[len(units) - len(picks):]


def count_picks(picks, traces, h: int, w: int) -> List[Pick]:
    """Each picked frame's rays and steps from the reference's trace of
    it, its depth, and where its still blend keeps the history."""
    from . import counts
    from .check import ref_state
    from .reference import frame as ref_frame

    out = []
    for (position, snap), (g,) in zip(picks, traces):
        cam = ref_frame.camera_rows(*snap.cams[0], w, h)
        state = ref_state(snap, w, h, g["depth"].device)
        kept = counts.still_kept(g["normal"], g["depth"], state["old_depth"],
                                 cam, state["old_cam"], ref_frame.TP, True)
        out.append(Pick(position, g["rays"].cpu().numpy(),
                        g["steps"].cpu().numpy(), g["depth"], kept, True))
    return out


def device_info(device: str, memory_peak: int, run: Run) -> dict:
    import torch

    info = {"platform": "gpu" if device == "cuda" else device,
            "kind": torch.cuda.get_device_name(0) if device == "cuda"
            else device,
            "count": 1, "memory_peak_bytes": int(memory_peak)}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_us() * 1e-6
        info["window_s"] = run.trace.window_us() * 1e-6
    return info


def parse(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="also compare the control (the reference in "
                        "bfloat16) with the reference; not part of a "
                        "benchmark run")
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    try:
        import torch
    except ImportError as e:
        log(f"no torch: {e}")
        return 3
    log(f"torch imported {time.perf_counter() - t0:.3f} s")
    wl_path = os.path.join(BENCH_DIR, "workloads", args.workload + ".json")
    if not os.path.exists(wl_path):
        log(f"unknown workload {args.workload!r}")
        return 2
    chips = int(next(c for c in load_json(ROOT, "BENCHMARK.json")["workloads"]
                     if c["name"] == args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count "
            f"{torch.cuda.device_count()}")
        return 3
    log(f"device: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()} ({time.perf_counter() - t0:.3f} s)")
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t0, bool(args.control))
    # read after the window, so that the set-up does not pay for it
    log(f"power.limit {power_limit()}")
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
