"""The trace's live-lane decay (``phasestats --decay``) on the CPU: the
plain version's per-pixel steps map against its own ``steps`` counters
(exact: the map is the per-ray split of the same count), the per-warp
grouping and k-th-largest glue (``ops/trace.py`` ``warp_decay``) against
a numpy loop over the CUDA kernel's threads, and the report's columns.
The kernel's steps-map instance is held against the plain map on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 23)."""

import contextlib
import io
import math

import numpy as np
import pytest
import torch

from voxtracer_torch.app import camera_paths, phasestats
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.params import RenderParams, pack_trace_params
from voxtracer_torch.engine.scene import (
    GridScene,
    SceneTables,
    VoxelList,
    load_scene,
)
from voxtracer_torch.ops import trace
from voxtracer_torch.ops.noise import white_noise_buffer

W, H = 64, 48
GBUF = ("color", "normal", "depth", "albedo", "node", "rays", "steps")


def _single_voxel():
    return GridScene.from_voxels(VoxelList(
        pos=np.array([[0, 0, 0]], dtype=np.int16),
        mrgb=np.array([[0, 200, 100, 50]], dtype=np.uint8)))


CASES = {
    "single_voxel": (_single_voxel,
                     lambda s: Camera(position=np.array([0.3, 0.2, -1.5]))),
    "8x8x8": (lambda: load_scene("8x8x8"),
              lambda s: camera_paths.static(s)(0.0)),
    "menger": (lambda: load_scene("menger"),
               lambda s: Camera(position=np.array([36.0, 34.0, -5.0]),
                                direction=np.array([-16.0, -14.0, 25.0]))),
}


def _args(name, w=W, h=H):
    scene_fn, cam_fn = CASES[name]
    scene = scene_fn()
    return (SceneTables(scene, "cpu"),
            pack_trace_params(cam_fn(scene).rows(w, h), RenderParams()),
            torch.from_numpy(white_noise_buffer(seed=7, count=32)), 1, h, w)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_steps_map_sums_to_steps(name):
    """Each phase's map sums to the plain ``steps`` counter, and asking
    for the map changes no other output."""
    args = _args(name)
    plain = trace.render_sample_plain(*args)
    out = trace.render_sample_steps(*args)
    smap = out["steps_map"]
    assert smap.shape == (trace.N_PHASES, H, W) and smap.dtype == torch.int32
    assert smap.sum(dim=(1, 2)).tolist() == out["steps"].tolist()
    assert out["steps"][0] > 0 and (smap >= 0).all()
    for key in GBUF:
        assert torch.equal(out[key], plain[key]), key
    # a pixel whose path missed at bounce 0 takes no step after it
    miss = out["depth"] < 0
    assert (smap[1:, miss] == 0).all()


def test_slab_steps_map_is_the_frames_rows():
    """A cyclic slab's map (row0 16, row_stride 2) is the frame's map at
    the slab's image rows: a pixel's steps follow its image row."""
    tables, params, noise, frame, h, w = _args("menger")
    full = trace.render_sample_steps(tables, params, noise, frame, h, w)
    rows = trace.image_rows(16, 16, 2)
    slab = trace.render_sample_steps(tables, params, noise, frame, 16, w,
                                     16, 2)
    assert torch.equal(slab["steps_map"], full["steps_map"][:, rows])


def _numpy_decay_sums(image_map, launch_h, w, row0=0, row_stride=1):
    """Per phase, the sums over the kernel's warps of the largest and the
    k-th largest lane steps, thread by thread as csrc/trace.cu launches
    a slab of ``launch_h`` local rows over ``image_map`` (P, H, W):
    thread (tx, ty) of block (bx, by) is lane (ty * 16 + tx) % 32 of warp
    (ty * 16 + tx) // 32 and renders image row
    by * row_stride * 16 + row0 + ty; lanes outside the launch count 0."""
    p = image_map.shape[0]
    ks = [max(1, math.ceil(f * 32)) for f in trace.DECAY_FRACS]
    sums = np.zeros((p, 1 + len(ks)), np.int64)
    for by in range(-(-launch_h // 16)):
        for bx in range(-(-w // 16)):
            for warp in range(8):
                lanes = np.zeros((p, 32), np.int64)
                for lane in range(32):
                    tid = 32 * warp + lane
                    tx, ty = tid % 16, tid // 16
                    x, y = bx * 16 + tx, by * 16 + ty
                    if x < w and y < launch_h:
                        gy = by * row_stride * 16 + row0 + ty
                        lanes[:, lane] = image_map[:, gy, x]
                ranked = -np.sort(-lanes, axis=1)
                sums[:, 0] += ranked[:, 0]
                for j, k in enumerate(ks):
                    sums[:, 1 + j] += ranked[:, k - 1]
    return sums


@pytest.mark.parametrize(
    "h, w, launch_h, row0, row_stride",
    [(16, 16, 16, 0, 1), (48, 64, 48, 0, 1), (37, 45, 37, 0, 1),
     (5, 70, 5, 0, 1), (64, 40, 32, 16, 2), (82, 33, 18, 32, 3)],
    ids=["one_block", "whole_blocks", "ragged", "short", "stride2",
         "stride3_ragged"],
)
def test_decay_sums_against_numpy(h, w, launch_h, row0, row_stride):
    """The glue on random int maps against the numpy loop: partial
    blocks at the right and bottom edges, and slabs of the cyclic
    layout (row_stride > 1), whose launch groups local rows."""
    rng = np.random.default_rng(h * 1000 + w)
    image_map = rng.integers(0, 40, size=(6, h, w)).astype(np.int32)
    image_map[:, :, ::7] = 0  # lanes without a ray
    rows = trace.image_rows(launch_h, row0, row_stride)
    assert rows.max() < h
    local = torch.from_numpy(image_map[:, rows])
    got = trace.decay_sums(local).numpy()
    ref = _numpy_decay_sums(image_map, launch_h, w, row0, row_stride)
    np.testing.assert_array_equal(got, ref)


def test_decay_of_a_known_warp():
    """One warp whose lanes took 1..32 steps: 32 trips, of which at
    least 24 lanes were live on 9, 16 on 17, 8 on 25, 4 on 29, 1 on 32;
    the other warps of the block took none."""
    smap = torch.zeros((6, 16, 16), dtype=torch.int32)
    smap[0, :2, :] = torch.arange(1, 33, dtype=torch.int32).reshape(2, 16)
    rows = trace.warp_decay(smap)
    assert rows[0] == {"trips": 32, "t75": 9 / 32, "t50": 17 / 32,
                       "t25": 25 / 32, "t12": 29 / 32, "t03": 1.0}
    assert rows[1] == {"trips": 0, "t75": 0.0, "t50": 0.0, "t25": 0.0,
                       "t12": 0.0, "t03": 0.0}


def test_steps_map_kernel_wrapper_refuses_cpu_tensors():
    """The steps-map instance never falls back to the plain version."""
    with pytest.raises(ValueError, match="CUDA kernel"):
        trace.render_sample_steps_cuda(*_args("single_voxel", 8, 8))


def test_phasestats_decay_prints_the_five_columns():
    """``phasestats --decay --device cpu`` prints the reference's five
    columns, each within [0, 1] and non-increasing from t03 to t75 (a
    trip with 3/4 of the lanes live has half of them live too)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert phasestats.main(["--scene", "8x8x8", "--size", "32x24",
                                "--decay", "--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    header = lines[1].split()
    assert header[-5:] == ["t75", "t50", "t25", "t12", "t03"]
    rows = [ln.split() for ln in lines[2:2 + trace.N_PHASES]]
    assert [r[0] for r in rows] == phasestats.PHASES
    for r in rows:
        vals = [float(v.rstrip("%")) / 100 for v in r[-5:]]
        assert all(0.0 <= v <= 1.0 for v in vals), r
        assert vals == sorted(vals), r
    # the rows' figures are phase_stats' own
    stats = phasestats.phase_stats(
        load_scene("8x8x8"), camera_paths.static(load_scene("8x8x8"))(0.0),
        24, 32, torch.device("cpu"), decay=True)
    assert [int(r[-6]) for r in rows] == [s["trips"] for s in stats]
