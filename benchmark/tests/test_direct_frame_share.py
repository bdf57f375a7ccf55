"""The reader of the frame driver's ``frames.direct`` counter: the share
of frames that one native call enqueued."""

import types

import pytest

from benchmark import profiling
from benchmark.harness import Run
from benchmark.metrics import direct_frame_share
from voxtracer_torch.engine import pipeline
from voxtracer_torch.utils import timing


def _run():
    return Run("cell", {}, {}, 1.0, 1.0, {},
               trace=profiling.Trace((0, 1e4), [], []))


def _launches(monkeypatch, **launches):
    """The frame kernels' wrappers stood in by objects with these
    ``launches``; the other counts as they are."""
    wrappers = {stage: types.SimpleNamespace(launches=launches.get(stage, 0))
                for stage in pipeline.counted_kernels()}
    monkeypatch.setattr(pipeline, "counted_kernels", lambda: wrappers)


@pytest.mark.parametrize("trace, direct, share", [
    (40, 40, 1.0),  # every frame by the native call
    (40, 30, 0.75),  # ten frames on the eager stages (or the burst's)
    (40, 0, 0.0),
], ids=["all", "a-mix", "none"])
def test_direct_frame_share_reads_the_counters(monkeypatch, trace, direct,
                                               share):
    _launches(monkeypatch, trace=trace, still_epilogue=trace)
    monkeypatch.setitem(timing.COUNTS, "frames.direct", direct)
    assert direct_frame_share.read(_run()) == pytest.approx(share)


def test_direct_frame_share_finds_nothing_without_the_counter(monkeypatch):
    # a program older than the counter (the parent of the direct path)
    _launches(monkeypatch, trace=3, still_epilogue=3)
    monkeypatch.delitem(timing.COUNTS, "frames.direct")
    assert direct_frame_share.read(_run()) is None
    # no frames, or no counters at all
    monkeypatch.setitem(timing.COUNTS, "frames.direct", 0)
    _launches(monkeypatch)
    assert direct_frame_share.read(_run()) is None
    monkeypatch.delattr(pipeline, "counters")
    assert direct_frame_share.read(_run()) is None
