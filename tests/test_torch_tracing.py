"""The port's spans (``voxtracer_torch/utils/timing.py``) and counters
(``engine.pipeline.counters``): the off path builds nothing, a profiled
frame or sequence yields its spans in the profiler's events, nested in
the order it runs them, and the counters follow the kernel wrappers and
never decrease.  The tests marked ``cuda`` hold the sequence driver's
graph spans and counters and the fetch's waits on the card
(``python -m pytest --noconftest -m cuda tests/test_torch_tracing.py``;
chip_smoke runs them too)."""

import json
import sys
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from voxtracer_torch.app import cli, profile
from voxtracer_torch.engine import reload
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.pipeline import Renderer, counters
from voxtracer_torch.engine.scene import load_scene
from voxtracer_torch.ops import trace as trace_op
from voxtracer_torch.utils import timing
from voxtracer_torch.utils.fetch import LookaheadFetch

POSE_A = Camera(position=np.array([2.0, 3.0, -4.0]),
                direction=np.array([0.2, 0.1, 1.0]))
POSE_B = Camera(position=np.array([2.3, 3.0, -4.0]),
                direction=np.array([0.1, 0.1, 1.0]))
STAGES_STILL_R0 = ["vt.render.pack", "vt.stage.trace",
                   "vt.stage.still_epilogue"]
STAGES_MOVING_R2 = ["vt.render.pack", "vt.stage.trace", "vt.stage.temporal",
                    "vt.stage.denoise", "vt.stage.encode"]
SEQUENCE_CUDA = ["vt.sequence.pack", "vt.sequence.rows",
                 "vt.sequence.capture", "vt.sequence.state_in",
                 "vt.sequence.replay", "vt.sequence.state_out"]


def _renderer(device="cpu", radius=0, size=(12, 16)):
    return Renderer(scene=load_scene("8x8x8"), height=size[0], width=size[1],
                    device=device, denoise_radius=radius, lean=True)


def _profiled(fn, device="cpu", outer=None):
    """``fn()`` under the profiler (shapes recorded, so a root span's
    ``args`` are kept), inside a ``record_function(outer)`` where
    given: the host events named ``vt.*`` or ``outer`` as ``(name,
    start, end, args)``, by start."""
    with torch.autograd.profiler.profile(
            use_device="cuda" if device != "cpu" else None,
            use_kineto=True, record_shapes=True) as prof:
        if outer is None:
            fn()
        else:
            with torch.autograd.profiler.record_function(outer):
                fn()
        if device != "cpu":
            torch.cuda.synchronize()
    return sorted(((e.name, e.time_range.start, e.time_range.end,
                    dict(e.kwinputs or {}))
                   for e in prof.function_events
                   if e.device_type == DeviceType.CPU
                   and (e.name.startswith("vt.") or e.name == outer)),
                  key=lambda e: e[1])


def _inside(spans, root):
    """The names of the spans that lie inside ``root`` (not itself), in
    order of start."""
    return [s[0] for s in spans if root[1] <= s[1] and s[2] <= root[2]
            and s[:3] != root[:3]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_span_off_builds_no_record_function(monkeypatch):
    """With no profiler, every span is the one shared no-op, and a whole
    frame, sequence and fetch build no record-function range."""

    def refuse(*args, **kwargs):
        raise AssertionError("a range built with the profiler off")

    monkeypatch.setattr(timing, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(timing._profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    off = timing.span("vt.render", {"frame": 3})
    assert off is timing.span("vt.stage.trace")
    with off, off:  # reusable and reentrant
        pass
    r = _renderer(radius=1)
    r.render(POSE_A)
    r.render(POSE_B)
    r.render_sequence([POSE_A, POSE_B])
    fetch = LookaheadFetch()
    fetch.push(r.render(POSE_B))
    fetch.flush()


@pytest.mark.parametrize("radius, poses, stages", [
    (0, [POSE_A, POSE_A], STAGES_STILL_R0),
    (2, [POSE_A, POSE_B], STAGES_MOVING_R2),
], ids=["still-r0", "moving-r2"])
def test_profiled_frame_spans(radius, poses, stages):
    """A frame under the profiler: one ``vt.render`` carrying its frame
    number, with ``vt.render.pack`` and the stage spans inside it in
    the order the frame runs them, each closed before the next opens."""
    r = _renderer(radius=radius)
    r.render(poses[0])
    launches = counters()
    spans = _profiled(lambda: r.render(poses[1]))
    assert [s[0] for s in spans] == ["vt.render", *stages]
    root, inner = spans[0], spans[1:]
    assert root[3] == {"frame": 2}
    assert _inside(spans, root) == stages
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))
    # the plain stages launch no kernel
    assert counters() == launches


def test_profiled_sequence_spans():
    """``render_sequence`` on the CPU: one ``vt.sequence`` carrying its
    first frame and count, with ``vt.sequence.pack`` first and each
    frame's stage spans after it (the CPU loop has no runner)."""
    r = _renderer(radius=0)
    r.render(POSE_A)
    spans = _profiled(lambda: r.render_sequence([POSE_A, POSE_A, POSE_B]))
    root = spans[0]
    assert root[0] == "vt.sequence"
    assert root[3] == {"frame": 2, "count": 3}
    assert _inside(spans, root) == ["vt.sequence.pack"] + [
        "vt.stage.trace", "vt.stage.still_epilogue"] * 2 + [
        "vt.stage.trace", "vt.stage.temporal", "vt.stage.encode"]


def test_spans_nest_under_the_callers_range():
    """A caller's own range (the benchmark's ``render`` and ``push``)
    holds the frame's and the fetch's spans."""
    r = _renderer(radius=0)
    spans = _profiled(lambda: r.render(POSE_A), outer="render")
    assert spans[0][0] == "render"
    assert _inside(spans, spans[0]) == ["vt.render", *STAGES_STILL_R0]


def test_counters_follow_the_wrappers_and_never_decrease(monkeypatch):
    before = counters()
    assert set(before) == {
        "launches.trace", "launches.temporal", "launches.denoise",
        "launches.resample", "launches.still_epilogue", "launches.encode",
        "graph.captures", "graph.replays", "kernel.builds", "host.waits",
        "frames.direct", "fetch.copies", "fetch.stream_copies",
        "denoise.resident_warps", "denoise.reciprocal_launches",
        "scene.builds", "scene.device_builds", "scene.load_us",
        "scene.tables_us", "scene.upload_us", "scene.table_bytes",
        "scene.per_node"}
    assert all(isinstance(v, int) for v in before.values())
    monkeypatch.setattr(trace_op.render_sample_cuda, "launches",
                        trace_op.render_sample_cuda.launches + 5)
    assert counters()["launches.trace"] == before["launches.trace"] + 5
    r = _renderer(radius=1)
    fetch = LookaheadFetch()
    for pose in (POSE_A, POSE_B, POSE_B):
        fetch.push(r.render(pose))
    fetch.flush()
    r.render_sequence([POSE_A, POSE_B])
    after = counters()
    assert all(after[k] >= before[k] for k in before)
    # on the CPU nothing waits for a device
    assert after["host.waits"] == before["host.waits"]


def test_reload_keeps_the_launch_counts(tmp_path, monkeypatch):
    """A hot-reloaded wrapper module's wrappers go on from their
    predecessors' launches."""
    (tmp_path / "vt_fake_kernels.py").write_text(
        "def kernel_cuda():\n    pass\n\n\nkernel_cuda.launches = 0\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    import vt_fake_kernels as mod

    try:
        old = mod.kernel_cuda
        old.launches = 7
        reload._reload(mod)
        assert mod.kernel_cuda is not old and mod.kernel_cuda.launches == 7
    finally:
        sys.modules.pop("vt_fake_kernels", None)


def test_cli_stats_prints_the_counters(tmp_path, capsys):
    """``--stats`` prints each counter's growth over the run (launches
    also a frame: none on the CPU); ``--profile``'s trace holds the
    program's spans."""
    prof = tmp_path / "prof"
    assert cli.main(["--device", "cpu", "--scene", "8x8x8", "--size",
                     "16x12", "--frames", "3", "--batch", "2", "--stats",
                     "--profile", str(prof),
                     "-o", str(tmp_path / "a.png")]) == 0
    lines = capsys.readouterr().out.splitlines()
    got = {ln.split()[1].rstrip(":"): ln for ln in lines
           if ln.startswith("  counter ")}
    assert set(got) == set(counters())
    assert got["launches.trace"].endswith(": 0 (0.00 a frame)")
    assert got["host.waits"].endswith(": 0")
    with open(prof / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"vt.sequence", "vt.sequence.pack", "vt.render",
            "vt.render.pack", "vt.stage.trace"} <= names


def test_profile_leaves_the_program_spans_out_of_the_device_activities():
    def event(name, device_type, annotation=False):
        return types.SimpleNamespace(name=name, device_type=device_type,
                                     is_user_annotation=annotation)

    events = [event("vt.render", DeviceType.CPU),
              event("vt.stage.denoise", DeviceType.CUDA),
              event("vt.render", DeviceType.CUDA, annotation=True),
              event("denoise_kernel<2>", DeviceType.CUDA)]
    assert [e.name for e in profile.device_activities(events)] == [
        "denoise_kernel<2>"]


def _sequence_names(spans):
    roots = [s for s in spans if s[0] == "vt.sequence"]
    return [[n for n in _inside(spans, root) if n.startswith("vt.sequence.")]
            for root in roots]


@pytest.mark.cuda
def test_sequence_driver_spans_and_counters_on_the_card(cuda):
    """The sequence driver on the card: a graph is captured (and its
    span opens) only on first use; ``graph.replays`` grows by the frames
    replayed and ``host.waits`` by one ``load_rows`` a call; the
    replayed frames' launches count as the loop's."""
    r = _renderer("cuda", radius=2, size=(36, 64))
    r.render(POSE_B)
    # every frame moves (the first from the one before the call), so
    # every frame reprojects: one graph
    for first, path in ((True, [POSE_A, POSE_B, POSE_A]),
                        (False, [POSE_B, POSE_A, POSE_B])):
        before = counters()
        spans = _profiled(lambda: r.render_sequence(path), "cuda")
        moved = {k: v - before[k] for k, v in counters().items()}
        (names,) = _sequence_names(spans)
        want = [n for n in SEQUENCE_CUDA
                if first or n != "vt.sequence.capture"]
        assert names == want
        assert moved["graph.captures"] == int(first)
        assert moved["graph.replays"] == len(path)
        assert moved["host.waits"] == 1
        # trace, temporal, denoise and encode a replayed frame; the
        # capture's eager frame counts its own launches
        for stage in ("trace", "temporal", "denoise", "encode"):
            assert moved[f"launches.{stage}"] == len(path) + int(first)
        assert moved["launches.still_epilogue"] == 0


@pytest.mark.cuda
def test_fetch_counts_a_wait_a_push_and_frame_launches_on_the_card(cuda):
    """``LookaheadFetch`` on the card: one ``vt.fetch.copy`` a push, one
    ``vt.fetch.wait`` and one host wait a push that returns a frame and
    a flush; a still frame at radius 0 launches 2 kernels, a moving one
    3."""
    r = _renderer("cuda", radius=0, size=(36, 64))
    fetch = LookaheadFetch()
    r.render(POSE_A)
    torch.cuda.synchronize()
    before = counters()
    launches = []

    def loop():
        for pose in (POSE_A, POSE_B, POSE_B, POSE_A):
            n = counters()
            out = r.render(pose)
            launches.append(sum(v - n[k] for k, v in counters().items()
                                if k.startswith("launches.")))
            fetch.push(out)
        fetch.flush()

    spans = _profiled(loop, "cuda")
    assert counters()["host.waits"] - before["host.waits"] == 4
    names = [s[0] for s in spans if s[0].startswith("vt.fetch.")]
    assert names.count("vt.fetch.copy") == 4
    assert names.count("vt.fetch.wait") == 4
    assert launches == [2, 3, 2, 3]
