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


def test_profile_runs_on_the_cpu(capsys):
    assert profile.main(["--device", "cpu", "--scene", "8x8x8", "--size",
                         "16x12", "--path", "orbit", "--denoise-radius", "1",
                         "--warmup", "1", "--frames", "2"]) == 0
    out = capsys.readouterr().out
    assert "profiled: wall" in out and "busy share 0.0000" in out
    assert "unprofiled:" in out
