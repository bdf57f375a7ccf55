"""The reader of the lookahead fetch's ``fetch.copies`` and
``fetch.stream_copies`` counters: the share of host copies that ran on
the fetch's own copy stream."""

import pytest

from benchmark import profiling
from benchmark.harness import Run
from benchmark.metrics import fetch_stream_share
from voxtracer_torch.engine import pipeline
from voxtracer_torch.utils import timing


def _run():
    return Run("cell", {}, {}, 1.0, 1.0, {},
               trace=profiling.Trace((0, 1e4), [], []))


@pytest.mark.parametrize("copies, on_stream, share", [
    (40, 40, 1.0),  # every copy on the fetch's stream
    (40, 10, 0.25),
    (40, 0, 0.0),  # every copy behind the frame's kernels
], ids=["all", "a-mix", "none"])
def test_fetch_stream_share_reads_the_counters(monkeypatch, copies,
                                               on_stream, share):
    monkeypatch.setitem(timing.COUNTS, "fetch.copies", copies)
    monkeypatch.setitem(timing.COUNTS, "fetch.stream_copies", on_stream)
    assert fetch_stream_share.read(_run()) == pytest.approx(share)


def test_fetch_stream_share_finds_nothing_without_the_counters(monkeypatch):
    # a program older than the copy stream
    monkeypatch.delitem(timing.COUNTS, "fetch.stream_copies")
    monkeypatch.setitem(timing.COUNTS, "fetch.copies", 3)
    assert fetch_stream_share.read(_run()) is None
    monkeypatch.delitem(timing.COUNTS, "fetch.copies")
    assert fetch_stream_share.read(_run()) is None
    # no copies (the CPU, or a cell that never fetches), or no counters
    monkeypatch.setitem(timing.COUNTS, "fetch.copies", 0)
    monkeypatch.setitem(timing.COUNTS, "fetch.stream_copies", 0)
    assert fetch_stream_share.read(_run()) is None
    monkeypatch.delattr(pipeline, "counters")
    assert fetch_stream_share.read(_run()) is None
