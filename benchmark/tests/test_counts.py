"""The yardstick's arithmetic against the port's instruments it was
copied from, and the window arithmetic of the end-to-end metrics."""

import numpy as np
import pytest
import torch

from benchmark import counts, profiling
from benchmark.harness import Run
from benchmark.metrics import frame_ms, latency_p95_ms
from voxtracer_torch.app import denoisebench, profile, renderbench, tracebench


def test_union_us_equals_the_programs():
    rng = np.random.default_rng(0)
    iv = [tuple(sorted(rng.uniform(0, 100, 2))) for _ in range(50)]
    for lo, hi in ((0, 100), (10, 60), (55, 56)):
        assert profiling.union_us(iv, lo, hi) == profile.union_us(iv, lo, hi)


def test_idle_gaps_and_busy_cover_the_window():
    iv = [(1, 3), (2, 5), (7, 8), (9.5, 12)]
    gaps = profiling.idle_gaps(iv, 0, 10)
    assert gaps == [(0, 1), (5, 7), (8, 9.5)]
    busy = profiling.union_us(iv, 0, 10)
    assert busy + sum(b - a for a, b in gaps) == 10


def test_trace_frames_and_ops():
    acts = [("trace_kernel<false>", 0, 3), ("encode_kernel", 3, 4),
            ("Memcpy DtoH", 4, 5), ("trace_kernel<false>", 6, 9),
            ("temporal_kernel", 9, 10), ("encode_kernel", 10, 11),
            ("trace_kernel<false>", 12, 15)]
    spans = [("render", 0, 4.5), ("push", 4.5, 6.5), ("render", 6.5, 16)]
    tr = profiling.Trace((0, 16), acts, spans)
    assert len(tr.frames()) == 3
    assert tr.ops_per_frame() == 3.0  # 6 activities over 2 frames
    assert tr.busy_us() == 13
    # idle 5-6 (in push), 11-12 and 15-16 (in render)
    assert dict(tr.idle_by_span()) == pytest.approx(
        {"render": 2e-6, "push": 1e-6})
    assert tr.top_ops(1)[0] == ("trace_kernel<false>", pytest.approx(9e-6))


@pytest.mark.parametrize("rays,steps,hw", [
    ([100, 40, 60, 20, 30, 10], [900, 300, 500, 100, 200, 50], (8, 16)),
    ([921600, 500000, 400000, 100000, 200000, 80000],
     [9e6, 3e6, 5e6, 1e6, 2e6, 5e5], (720, 1280)),
])
def test_trace_counts_equal_tracebench(rays, steps, hw):
    h, w = hw
    assert counts.trace_ops(rays, steps, h * w) == tracebench.trace_ops(
        rays, steps, h, w)
    ms, _ = tracebench.trace_bound(
        {"rays": np.array(rays), "steps": np.array(steps)}, h, w, 512)
    assert counts.trace_least_s(rays, steps, h * w, 1) * 1e3 == \
        pytest.approx(ms, rel=1e-12)


@pytest.mark.parametrize("h,w,r", [(36, 64, 1), (1080, 1920, 2),
                                   (45, 80, 8)])
def test_denoise_count_equals_denoisebench(h, w, r):
    ms, _ = denoisebench.denoise_bound(h, w, r)
    assert counts.denoise_least_s(h, w, r) * 1e3 == pytest.approx(
        ms, rel=1e-12)


def test_epilogue_bytes_equal_renderbench():
    rng = np.random.default_rng(1)
    depth = torch.from_numpy(rng.uniform(-1, 1, (9, 13)).astype(np.float32))
    kept = torch.from_numpy(rng.random((9, 13)) < 0.3)
    for valid in (True, False):
        for albedo in (True, False):
            assert counts.still_bytes(depth, kept, valid, albedo) == \
                renderbench.still_bytes(depth, kept, valid, albedo)
    for albedo in (True, False):
        assert counts.encode_bytes(9, 13, albedo) == \
            renderbench.encode_bytes(9, 13, albedo)
    assert counts.temporal_least_s(1080, 1920) * counts.HBM_BYTES_PER_S == \
        64 * 1080 * 1920


def _run(calls, ready, seconds=1.0, t_start=0.0):
    rec = {"t_start": t_start, "t_end": t_start + seconds, "calls": calls,
           "ready": ready, "frames_per_unit": 1}
    return Run("c", {}, {}, seconds, 0.0, rec)


def test_window_counts_frames_that_reached_the_host_in_it():
    calls = [i * 0.001 for i in range(1000)]
    ready = [c + 0.002 for c in calls]
    steady = _run(calls, ready)
    # 999 of the 1000 reach the host by t = 1.0 s
    assert frame_ms.read(steady) == pytest.approx(1000 / 999)
    assert latency_p95_ms.read(steady) == pytest.approx(2.0)


def test_a_stall_moves_both_metrics():
    calls, ready, t = [], [], 0.0
    for i in range(900):
        if i == 450:
            t += 0.1  # a 100 ms stall on the host
        calls.append(t)
        ready.append(t + 0.002 + (0.1 if 400 <= i < 450 else 0.0))
        t += 0.001
    stalled = _run(calls, ready)
    assert frame_ms.read(stalled) > 1.0
    assert latency_p95_ms.read(stalled) > 50.0


def test_percentile_is_nearest_rank():
    vals = list(range(1, 101))
    assert latency_p95_ms.percentile(vals, 95) == 95
    assert latency_p95_ms.percentile([5.0], 95) == 5.0
    assert latency_p95_ms.percentile(vals[::-1], 50) == 50
