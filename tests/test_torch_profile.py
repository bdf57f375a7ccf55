"""The frame profiler of the port (``voxtracer_torch.app.profile``): its
device-time arithmetic, and a tiny run on the CPU (where the trace holds
no device activity)."""

import types

import pytest
from torch.autograd import DeviceType

from voxtracer_torch.app import profile


@pytest.mark.parametrize(
    "intervals, lo, hi, want",
    [
        ([], 0.0, 10.0, 0.0),
        ([(1.0, 3.0), (5.0, 6.0)], 0.0, 10.0, 3.0),
        ([(1.0, 4.0), (2.0, 3.0), (3.5, 6.0)], 0.0, 10.0, 5.0),  # overlaps
        ([(-2.0, 1.0), (9.0, 12.0)], 0.0, 10.0, 2.0),  # clipped to the range
        ([(11.0, 12.0)], 0.0, 10.0, 0.0),
    ],
    ids=["empty", "disjoint", "overlapping", "clipped", "outside"],
)
def test_union_counts_each_busy_microsecond_once(intervals, lo, hi, want):
    assert profile.union_us(intervals, lo, hi) == want


def test_device_activities_are_the_device_kernels_only():
    def event(name, device_type, annotation=False):
        return types.SimpleNamespace(name=name, device_type=device_type,
                                     is_user_annotation=annotation)

    events = [
        event("aten::mul", DeviceType.CPU),
        event("trace_kernel", DeviceType.CUDA),
        event(profile.RANGE, DeviceType.CUDA),
        event("range", DeviceType.CUDA, annotation=True),
        event("Activity Buffer Request", DeviceType.CUDA),
        event("Memcpy HtoD", DeviceType.CUDA),
    ]
    names = [e.name for e in profile.device_activities(events)]
    assert names == ["trace_kernel", "Memcpy HtoD"]


@pytest.mark.parametrize("batch", [[], ["--batch", "2"]],
                         ids=["render", "render_sequence"])
def test_profile_runs_on_the_cpu(capsys, batch):
    assert profile.main(["--device", "cpu", "--scene", "8x8x8", "--size",
                         "16x12", "--path", "orbit", "--denoise-radius", "1",
                         "--warmup", "1", "--frames", "2", *batch]) == 0
    out = capsys.readouterr().out
    assert "profiled: wall" in out and "busy share 0.0000" in out
    assert "unprofiled:" in out
    assert ("in sequences of 2" in out) == bool(batch)


def test_profile_refuses_frames_that_are_no_whole_batches():
    with pytest.raises(SystemExit, match="no multiple"):
        profile.main(["--device", "cpu", "--frames", "5", "--batch", "2"])


def _activity(name, start):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start))


# a sequence of 3 frames: its rows and state in (4 copies and a fill),
# each frame (its row, the trace, the blend), its state out (2 copies);
# listed out of time order, as the profiler may
_FRAME = ["Memcpy DtoD", "trace_kernel", "still_epilogue_kernel"]
_RANGE = (["Memcpy HtoD"] + ["Memcpy DtoD"] * 3 + ["fill"]
          + _FRAME * 3 + ["Memcpy DtoD"] * 2)


def _range(names):
    return [_activity(n, t) for t, n in reversed(list(enumerate(names)))]


@pytest.mark.parametrize(
    "ranges",
    [
        [_range(_RANGE)],
        [_range(_RANGE[5:])],  # the profiler missed the start of the range
        [_range(["Memcpy DtoD"] * 4 + _RANGE)],  # ... or added to it
        [_range(_RANGE[7:]), _range(_RANGE)],  # a frame's trace missed
    ],
    ids=["whole", "head-dropped", "head-added", "frame-dropped-then-whole"],
)
def test_frame_activities_count_between_the_first_and_last_frames(
        monkeypatch, ranges):
    calls = iter(ranges)
    monkeypatch.setattr(profile, "profile_range",
                        lambda advance, device: (0.0, next(calls), 0.0))
    assert profile.frame_activities(lambda: None, None, 3) == (3.0, 1.0)


def test_frame_activities_refuse_a_range_that_misses_a_frame(monkeypatch):
    monkeypatch.setattr(profile, "profile_range",
                        lambda advance, device: (0.0, _range(_RANGE[7:]), 0.0))
    with pytest.raises(RuntimeError, match=r"launched \*trace_kernel\* "
                                           r"\[2, 2, 2\] times"):
        profile.frame_activities(lambda: None, None, 3)


def test_profile_takes_the_reference_usage_line(capsys, tmp_path,
                                                monkeypatch):
    """The reference's command line (``voxtracer/app/profile.py``'s
    usage: ``--static``, ``--top N``, ``--keep DIR``) parses and runs on
    the CPU: ``--top 3`` prints 3 activity rows (the CPU trace holds no
    device activity, so its host ops stand in for them here) and the
    trace stays in DIR."""
    monkeypatch.setattr(
        profile, "device_activities",
        lambda events: [e for e in events if e.name != profile.RANGE])
    keep = tmp_path / "trace"
    assert profile.main(["--scene", "menger", "--size", "64x36",
                         "--denoise-radius", "0", "--static", "--frames",
                         "2", "--top", "3", "--keep", str(keep),
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "menger 64x36 static r=0, 2 frames profiled" in out
    assert sum(" ms/frame " in ln and ln.startswith("  ")
               for ln in out.splitlines()) == 3
    assert (keep / "trace.json").stat().st_size > 0


def test_profile_defaults_are_the_reference_ones(monkeypatch):
    import argparse

    parse = argparse.ArgumentParser.parse_args
    seen = []

    def parse_and_stop(self, args=None, namespace=None):
        seen.append(parse(self, args, namespace))
        raise KeyboardInterrupt

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_and_stop)
    with pytest.raises(KeyboardInterrupt):
        profile.main([])
    a = seen[0]
    assert (a.scene, a.size, a.denoise_radius, a.frames, a.path, a.static,
            a.top, a.keep, a.device) == (
        "menger", "1280x720", 0, 4, "dolly", False, 20, None, "cuda")
