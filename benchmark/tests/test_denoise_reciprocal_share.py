"""The reader of the denoise stage's ``denoise.reciprocal_launches``
counter: the share of denoise launches whose range quotient took one
correction."""

import pytest

from benchmark import profiling
from benchmark.harness import Run, load_json
from benchmark.metrics import denoise_reciprocal_share
from voxtracer_torch.engine import pipeline
from voxtracer_torch.ops import denoise as denoise_op
from voxtracer_torch.utils import timing

from .conftest import ROOT


def _run():
    return Run("cell", {}, {}, 1.0, 1.0, {},
               trace=profiling.Trace((0, 1e4), [], []))


@pytest.mark.parametrize("launches, reciprocal, share", [
    (40, 40, 1.0),  # sigma_range 1.5: every launch takes one correction
    (40, 10, 0.25),  # a sigma_range that takes two, after one that did not
    (40, 0, 0.0),
], ids=["all", "a-mix", "none"])
def test_denoise_reciprocal_share_reads_the_counters(monkeypatch, launches,
                                                     reciprocal, share):
    monkeypatch.setattr(denoise_op.denoise_cuda, "launches", launches)
    monkeypatch.setitem(timing.COUNTS, "denoise.reciprocal_launches",
                        reciprocal)
    assert denoise_reciprocal_share.read(_run()) == pytest.approx(share)


def test_denoise_reciprocal_share_finds_nothing_without_the_counter(
        monkeypatch):
    # a program older than the counter
    monkeypatch.setattr(denoise_op.denoise_cuda, "launches", 10)
    monkeypatch.delitem(timing.COUNTS, "denoise.reciprocal_launches")
    assert denoise_reciprocal_share.read(_run()) is None
    # no denoise launch (radius 0, or the CPU)
    monkeypatch.setitem(timing.COUNTS, "denoise.reciprocal_launches", 0)
    monkeypatch.setattr(denoise_op.denoise_cuda, "launches", 0)
    assert denoise_reciprocal_share.read(_run()) is None
    monkeypatch.delattr(pipeline, "counters")
    assert denoise_reciprocal_share.read(_run()) is None


def test_entry_lists_the_denoising_cells():
    bench = load_json(ROOT, "BENCHMARK.json")
    entry, = [m for m in bench["per_layer"]
              if m["name"] == "denoise_reciprocal_share"]
    assert bench["per_layer"][-1] is entry
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"],
            entry["moves"]) == ("launches/launch", "higher",
                                "program_counter", "denoise stage",
                                "frame_ms")
    assert entry["workloads"] == ["monu9-1080-r2.view",
                                  "monu9-1080-r2.export",
                                  "default1080-r2.view",
                                  "monu9-1080-r8.view"]
