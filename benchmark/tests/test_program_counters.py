"""The reader of the program's counters, and the trace reading with the
program's spans among the profiler's events."""

import types

import pytest
from torch.autograd import DeviceType

from benchmark import profiling
from benchmark.drivers import view
from benchmark.harness import Run
from benchmark.metrics import launches_per_frame
from voxtracer_torch.engine import pipeline


def _run():
    return Run("cell", {}, {}, 1.0, 1.0, {},
               trace=profiling.Trace((0, 1e4), [], []))


def _launches(monkeypatch, **launches):
    """The frame kernels' wrappers stood in by objects with these
    ``launches``; the other counts as they are."""
    wrappers = {stage: types.SimpleNamespace(launches=launches.get(stage, 0))
                for stage in pipeline.counted_kernels()}
    monkeypatch.setattr(pipeline, "counted_kernels", lambda: wrappers)


def test_launches_per_frame_reads_the_counters(monkeypatch):
    # 40 frames: 40 traces, 10 moving (temporal, encode), 30 still
    _launches(monkeypatch, trace=40, temporal=10, encode=10,
              still_epilogue=30)
    assert launches_per_frame.read(_run()) == pytest.approx(90 / 40)
    _launches(monkeypatch, trace=6, temporal=6, denoise=6, encode=6)
    assert launches_per_frame.read(_run()) == pytest.approx(4.0)


def test_launches_per_frame_finds_nothing_without_launches_or_counters(
        monkeypatch):
    _launches(monkeypatch)  # the plain stages (a run on the CPU)
    assert launches_per_frame.read(_run()) is None
    # a program older than its counters: the reader does not raise
    _launches(monkeypatch, trace=3, still_epilogue=3)
    monkeypatch.delattr(pipeline, "counters")
    assert launches_per_frame.read(_run()) is None


def _event(name, device, start, end, annotation=False):
    return types.SimpleNamespace(
        name=name, device_type=device, is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_program_spans_leave_the_device_reading_as_it_was():
    """The program's spans in the profiler's events (host ranges, not
    user annotations, and no device-side copies: chip_smoke phase 25),
    and the harness's own spans' device-side copies, change nothing the
    device metrics read."""
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    base = [
        _event(profiling.RANGE, cpu, 0, 100),
        _event(profiling.RANGE, cuda, 0, 100, annotation=True),
        _event("render", cpu, 0, 40), _event("push", cpu, 40, 50),
        _event("render", cpu, 50, 90), _event("push", cpu, 90, 100),
        _event("trace_kernel<false>", cuda, 5, 20),
        _event("denoise_kernel<2>", cuda, 20, 30),
        _event("Memcpy DtoH", cuda, 42, 46),
        _event("trace_kernel<false>", cuda, 55, 70),
        _event("denoise_kernel<2>", cuda, 70, 80),
    ]
    program = [
        _event("vt.render", cpu, 1, 39), _event("vt.render.pack", cpu, 1, 4),
        _event("vt.stage.trace", cpu, 4, 8),
        _event("vt.stage.denoise", cpu, 8, 12),
        _event("vt.fetch.copy", cpu, 41, 43),
        _event("vt.fetch.wait", cpu, 43, 47),
        _event("render", cuda, 5, 30, annotation=True),
        _event("push", cuda, 42, 46, annotation=True),
    ]
    traces = [profiling.Trace.from_profiler(
        types.SimpleNamespace(function_events=events), view.SPANS)
        for events in (base, base + program)]
    plain, with_spans = traces
    assert with_spans.activities == plain.activities
    assert not [a for a in with_spans.activities if a[0].startswith("vt.")]
    assert with_spans.spans == plain.spans
    assert with_spans.busy_us() == plain.busy_us() == 54
    assert with_spans.kernels("denoise") == plain.kernels("denoise")
    assert len(plain.kernels("denoise")) == 2
    assert with_spans.ops_per_frame() == plain.ops_per_frame() == 3.0
    assert with_spans.top_ops() == plain.top_ops()
    assert with_spans.idle_by_span() == plain.idle_by_span()
