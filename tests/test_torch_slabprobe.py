"""The port's slab probe (``voxtracer_torch/app/slabprobe.py``) on the
CPU with the plain trace: every slab it times traces exactly the rows of
the one-launch frame that the mesh gives its device (bit-equal, and the
slabs' ray and step counters add up to the frame's), the cyclic layout's
launches are ``parallel/mesh.py``'s ``cyclic_plan``, the launch overhead
divides by the launches beyond the frame's one, the cyclic row pads
nothing, and the rows carry the reference's keys."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from voxtracer_torch.app import camera_paths, slabprobe
from voxtracer_torch.engine.params import RenderParams, pack_trace_params
from voxtracer_torch.engine.scene import SceneTables, load_scene
from voxtracer_torch.ops import trace
from voxtracer_torch.ops.noise import white_noise_buffer
from voxtracer_torch.parallel.mesh import cyclic_plan

W, H = 64, 48
# the reference's row keys (voxtracer/app/slabprobe.py:207-216, :254-262)
CONTIGUOUS_KEYS = {"k", "slab_h", "launch_ovh_ms", "slab_ms", "chip_ms",
                   "max_ms", "mean_ms", "skew", "fused_max_ms"}
CYCLIC_KEYS = {"layout", "block", "h_pad", "slab_h", "pad_waste", "chip_ms",
               "max_ms", "mean_ms", "skew"}


def _setup(name, w=W, h=H):
    scene = load_scene(name)
    tables = SceneTables(scene, "cpu")
    noise = torch.from_numpy(white_noise_buffer(seed=7))
    params = pack_trace_params(camera_paths.static(scene)(0.0).rows(w, h),
                               RenderParams())
    full = slabprobe.slab_fn(tables, noise, params, w, h)(0)
    return tables, noise, params, full


def _traced(tables, noise, params, slabs, row_stride, w=W):
    return [slabprobe.slab_fn(tables, noise, params, w, rows, row_stride)(r0)
            for r0, rows in slabs]


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("name", ["8x8x8", "menger"])
def test_contiguous_slabs_equal_the_frames_rows(name, n):
    """Each of n contiguous slabs (48 rows: 24, 16, 12 a slab) traces
    the frame's rows bit for bit; the counters add up."""
    tables, noise, params, full = _setup(name)
    assert (full["depth"] >= 0).any()
    slabs = slabprobe.contiguous_slabs(H, n)
    outs = _traced(tables, noise, params, slabs, 1)
    assert slabprobe.check_slabs(full, outs, slabs)
    assert sum(rows for _, rows in slabs) == H


@pytest.mark.parametrize("n, h", [(2, 48), (3, 40), (4, 72)])
def test_cyclic_launches_are_the_meshs_plan(n, h):
    """Device c's launch (row0 16 c, stride n) traces the image rows that
    ``cyclic_plan`` takes from its planes, and equals the frame's rows."""
    tables, noise, params, full = _setup("menger", h=h)
    slabs = slabprobe.cyclic_slabs(h, n)
    mesh = (torch.device("cpu"),) * n
    for s, plan in enumerate(cyclic_plan(mesh, h)):
        start = -(-h // n) * s
        for c, (local, at) in plan.items():
            r0, rows = slabs[c]
            img = trace.image_rows(rows, r0, n)
            np.testing.assert_array_equal(img[local.numpy()],
                                          start + at.numpy())
    assert sum(rows for _, rows in slabs) == h
    outs = _traced(tables, noise, params, slabs, n)
    assert slabprobe.check_slabs(full, outs, slabs, n)


def test_check_slabs_catches_a_slab_of_other_rows():
    tables, noise, params, full = _setup("menger")
    slabs = slabprobe.contiguous_slabs(H, 2)
    outs = _traced(tables, noise, params, [(r0 + 1, rows) for r0, rows
                                           in slabs[:1]] + slabs[1:], 1)
    with pytest.raises(AssertionError):
        slabprobe.check_slabs(full, outs, slabs)


def test_launch_overhead_divides_by_the_extra_launches():
    """n slabs are n - 1 launches more than the frame's one (the
    reference divides by n, ``slabprobe.py:200``)."""
    assert slabprobe.launch_overhead([1.0, 1.0, 1.0, 1.0], 2.5) == 0.5
    assert slabprobe.launch_overhead([1.0, 2.0], 2.5) == 0.5
    assert slabprobe.launch_overhead([1.0, 1.0], 3.0) == 0.0
    assert slabprobe.launch_overhead([2.0], 1.0) == 0.0


def test_round_robin_deal_and_fused_projection():
    """Device c gets slabs c, c + n, ...; the fused projection takes
    k - 1 launch overheads off each device's sum."""
    ms = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    slabs = slabprobe.contiguous_slabs(H, 6)
    row = slabprobe.contiguous_row(3, 2, W, slabs, ms, 15.0,
                                   torch.device("cpu"))
    assert row["chip_ms"] == [9.0, 12.0]
    assert row["launch_ovh_ms"] == (21.0 - 15.0) / 5
    assert row["fused_max_ms"] == 12.0 - 2 * row["launch_ovh_ms"]
    assert row["skew"] == 12.0 / 10.5
    assert row["slab_blocks"] == [4] * 6 and row["slab_waves"] is None


def test_uneven_heights_are_not_skipped():
    """50 rows in 4 slabs: the mesh's ceil(50 / 4) = 13, the last 11."""
    assert slabprobe.contiguous_slabs(50, 4) == [(0, 13), (13, 13), (26, 13),
                                                 (39, 11)]


def _rows(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert slabprobe.main(argv + ["--json", "--reps", "1", "--chain", "1",
                                      "--device", "cpu"]) == 0
    return [json.loads(ln) for ln in buf.getvalue().splitlines()]


def test_report_rows_carry_the_reference_keys():
    """``--ndev 2 --interleave 2`` on the CPU: the k = 1 and k = 2 rows,
    every slab exact, with the reference's keys."""
    head, *rows = _rows(["--scene", "8x8x8", "--size", "32x40", "--ndev", "2",
                         "--interleave", "2"])
    assert head["full_frame_ms"] > 0 and head["height"] == 40
    assert [r["k"] for r in rows] == [1, 2]
    for r in rows:
        assert CONTIGUOUS_KEYS <= set(r) and r["exact"]
        assert len(r["slab_ms"]) == 2 * r["k"] and len(r["chip_ms"]) == 2
        assert r["skew"] >= 1.0
    assert rows[1]["slab_rows"] == [10, 10, 10, 10]


def test_cyclic_row_pads_nothing():
    """The port's cyclic layout traces no row past the image: at 40 rows
    and 2 devices (bands of 16: 32 + 8 rows) ``h_pad`` is the height and
    ``pad_waste`` 0.0 (the reference pads to 2 x 32 = 64, 0.6)."""
    head, row = _rows(["--scene", "8x8x8", "--size", "32x40", "--ndev", "2",
                       "--cyclic"])
    assert CYCLIC_KEYS <= set(row) and row["exact"]
    assert row["pad_waste"] == 0.0 and row["h_pad"] == 40
    assert row["chip_rows"] == [24, 16] and row["block"] == 16
    assert len(row["chip_ms"]) == 2
