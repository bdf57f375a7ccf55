"""The CUDA kernels (trace, temporal reprojection, denoise, history
resample, stall microbenchmark) against their plain torch versions and
the golden file, and the Renderer and the BASELINE harness on the
card.  Needs an NVIDIA GPU and nvcc; skips elsewhere.  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: trace node, depth, normal and albedo bit-exact (the kernels
are built without FMA contraction and perform the plain versions' float
operations in their order); trace color: cos/sin/exp/log may round
differently in the two builds, which can turn a secondary ray at a
grazing edge, so at most 0.5% of pixels may differ by more than 1e-3 (0
measured on an H100 with torch 2.11 / CUDA 12.8).  Temporal: validity
and next blend bit-exact, colour within 1e-6 (no transcendental).
Denoise: 1e-6 absolute plus 1e-6 relative (expf/logf may round
differently from torch's).  Resample: bit-equal, NaN where a coordinate
is not finite (no transcendental).  Stall microbenchmark: integer,
equal.
"""

import os

import numpy as np
import pytest
import torch

from voxtracer_torch.app import bench, camera_paths, stallbench
from voxtracer_torch.engine import scene as scene_mod
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.params import (
    DenoiseParams,
    RenderParams,
    TemporalParams,
    pack_denoise_params,
    pack_temporal_params,
    pack_trace_params,
)
from voxtracer_torch.engine.pipeline import Renderer
from voxtracer_torch.engine.scene import (
    GridScene,
    SceneTables,
    VoxelList,
    load_scene,
)
from voxtracer_torch.ops import denoise, reproject, temporal, trace
from voxtracer_torch.ops.noise import blue_noise_buffer, white_noise_buffer

pytestmark = pytest.mark.cuda

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "oracle_8x8x8_32.npz")
MENGER = Camera(position=np.array([36.0, 34.0, -5.0]),
                direction=np.array([-16.0, -14.0, 25.0]))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _np(out):
    res = {k: v.cpu().numpy() for k, v in out.items()}
    for k in ("color", "normal", "albedo"):
        res[k] = np.moveaxis(res[k], 0, -1)
    return res


def _both(scene, cam, w, h, noise, device):
    tables = SceneTables(scene, device)
    args = (tables, pack_trace_params(cam.rows(w, h), RenderParams()),
            noise.to(device), 1, h, w)
    return _np(trace.render_sample_cuda(*args)), _np(
        trace.render_sample_plain(*args)
    )


def _assert_kernel_matches_plain(k, p):
    assert (p["depth"] >= 0).any()
    for key in ("node", "depth", "normal", "albedo"):
        np.testing.assert_array_equal(k[key], p[key], err_msg=key)
    err = np.abs(k["color"] - p["color"]).max(-1)
    assert (err > 1e-3).mean() <= 0.005
    np.testing.assert_array_equal(k["rays"][:3], p["rays"][:3])


def test_kernel_matches_plain_single_voxel(cuda):
    scene = GridScene.from_voxels(VoxelList(
        pos=np.array([[0, 0, 0]], dtype=np.int16),
        mrgb=np.array([[0, 200, 100, 50]], dtype=np.uint8),
    ))
    _assert_kernel_matches_plain(*_both(
        scene, Camera(position=np.array([0.3, 0.2, -1.5])), 32, 32,
        torch.from_numpy(white_noise_buffer(seed=7, count=32)), cuda,
    ))


@pytest.mark.parametrize("dedup_max", [None, 0], ids=["dedup", "per_node"])
def test_kernel_matches_plain_menger(cuda, dedup_max, monkeypatch):
    if dedup_max is not None:
        monkeypatch.setattr(scene_mod.grid, "BRICK_DEDUP_MAX", dedup_max)
    _assert_kernel_matches_plain(*_both(
        load_scene("menger"), MENGER, 160, 96,
        torch.from_numpy(blue_noise_buffer()), cuda,
    ))


def test_kernel_matches_golden(cuda):
    k, _ = _both(
        load_scene("8x8x8"),
        Camera(position=np.array([2.0, 3.0, -4.0]),
               direction=np.array([0.2, 0.1, 1.0])),
        32, 32, torch.from_numpy(white_noise_buffer(seed=7)), cuda,
    )
    g = np.load(GOLDEN)
    for key in ("node", "depth", "normal"):
        np.testing.assert_array_equal(k[key], g[key], err_msg=key)
    np.testing.assert_allclose(k["color"], g["color"], atol=1e-3)
    np.testing.assert_allclose(k["albedo"], g["albedo"], atol=1e-6)


def test_renderer_on_cuda_runs_the_kernel(cuda):
    """Three still frames on the card launch the kernel three times and
    give the CPU renderer's images."""
    scene = load_scene("menger")
    gpu = Renderer(scene=scene, height=48, width=64, device="cuda")
    cpu = Renderer(scene=scene, height=48, width=64, device="cpu")
    before = trace.render_sample_cuda.launches
    for _ in range(3):
        out_gpu = gpu.render(MENGER)
        out_cpu = cpu.render(MENGER)
    assert trace.render_sample_cuda.launches - before == 3
    diff = np.abs(out_gpu["image"].cpu().numpy().astype(int)
                  - out_cpu["image"].numpy().astype(int))
    assert (diff > 1).mean() <= 0.005
    np.testing.assert_array_equal(out_gpu["node"].cpu().numpy(),
                                  out_cpu["node"].numpy())


def _menger_gbuf(cam, device, w=320, h=180):
    tables = SceneTables(load_scene("menger"), device)
    return trace.render_sample_cuda(
        tables, pack_trace_params(cam.rows(w, h), RenderParams()),
        torch.from_numpy(blue_noise_buffer()).to(device), 1, h, w,
    )


@pytest.mark.parametrize(
    "d_pos, tilt",
    [((0.0, 0.0, 0.0), 0.0), ((0.3, -0.2, 0.4), 0.0),
     ((2.0, 1.0, -1.5), 0.0), ((0.0, 0.0, 0.0), 15.0)],
    ids=["still", "small", "large", "whip_pan"],
)
def test_temporal_kernel_matches_plain(cuda, d_pos, tilt):
    """Menger G-buffers from two poses, history from the first; the
    whip pan tilts by 15 degrees (~34 of 180 rows, past the Pallas
    kernel's serve window)."""
    w, h = 320, 180
    old_cam = MENGER
    cam = Camera(position=old_cam.position + np.array(d_pos),
                 direction=old_cam.pitched(tilt).direction)
    old = _menger_gbuf(old_cam, cuda, w, h)
    new = _menger_gbuf(cam, cuda, w, h)
    rng = np.random.default_rng(0)
    old_blend = torch.from_numpy(
        rng.uniform(0.02, 0.9, (h, w)).astype(np.float32)).to(cuda)
    args = (new["color"], new["normal"], new["depth"], old["color"],
            old_blend, old["depth"],
            pack_temporal_params(cam.rows(w, h), old_cam.rows(w, h),
                                 TemporalParams(), True))
    kc, kb = temporal.temporal_blend_reproject_cuda(*args)
    pc, pb = temporal.temporal_blend_reproject_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(kb, pb)
    assert (pb < 0.5).any(), "degenerate comparison: no history kept"
    assert (kc - pc).abs().max().item() <= 1e-6


def test_temporal_kernel_non_finite_reprojection(cuda):
    """Depth 0 at the old camera's origin and infinite depths give NaN
    and inf screen coordinates: the kernel reads in bounds and those
    pixels restart, as in the plain version."""
    w, h = 64, 48
    rows = MENGER.rows(w, h)
    depth = torch.full((h, w), 5.0, device=cuda)
    depth[:4] = float("inf")
    depth[4:8] = 0.0
    color = torch.rand((3, h, w), device=cuda)
    normal = torch.zeros((3, h, w), device=cuda)
    normal[2] = -1.0
    args = (color, normal, depth, torch.rand((3, h, w), device=cuda),
            torch.full((h, w), 0.3, device=cuda), depth.clone(),
            pack_temporal_params(rows, rows, TemporalParams(), True))
    kc, kb = temporal.temporal_blend_reproject_cuda(*args)
    pc, pb = temporal.temporal_blend_reproject_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(kb, pb) and torch.equal(kc[:, :8], color[:, :8])
    assert torch.equal(kc, pc)


@pytest.mark.parametrize("radius", [1, 2, 4, 8])
def test_denoise_kernel_matches_plain(cuda, radius):
    g = _menger_gbuf(MENGER, cuda)
    args = (g["color"], g["normal"], g["depth"], g["albedo"], g["node"],
            pack_denoise_params(MENGER.rows(320, 180), DenoiseParams()),
            radius)
    k = denoise.denoise_cuda(*args)
    p = denoise.denoise_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(p).all()
    assert ((k - p).abs() <= 1e-6 + 1e-6 * p.abs()).all()


def test_renderer_on_cuda_runs_every_kernel_on_a_moving_path(cuda):
    """Four frames along an orbit at denoise radius 2: the trace and
    denoise kernels launch every frame, the temporal kernel on the three
    frames that move with live history; images agree with the CPU
    renderer's."""
    scene = load_scene("chr_knight")
    path = camera_paths.orbit(scene, distance=0.6)
    gpu = Renderer(scene=scene, height=48, width=64, device="cuda",
                   denoise_radius=2)
    cpu = Renderer(scene=scene, height=48, width=64, device="cpu",
                   denoise_radius=2)
    counters = (trace.render_sample_cuda, temporal.temporal_blend_reproject_cuda,
                denoise.denoise_cuda)
    before = [c.launches for c in counters]
    for i in range(4):
        out_gpu = gpu.render(path(i / 30.0))
        out_cpu = cpu.render(path(i / 30.0))
    assert [c.launches - b for c, b in zip(counters, before)] == [4, 3, 4]
    np.testing.assert_array_equal(out_gpu["node"].cpu().numpy(),
                                  out_cpu["node"].numpy())
    diff = np.abs(out_gpu["image"].cpu().numpy().astype(int)
                  - out_cpu["image"].numpy().astype(int))
    assert (diff > 1).any(-1).mean() <= 0.005


def _resample_field(h, w, shift, device):
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    px_f = (xx + shift + 0.3 + 0.01 * yy).to(device)
    py_f = (yy - 1.7 + 0.005 * xx).to(device)
    return px_f, py_f


@pytest.mark.parametrize("shift", [2.0, 500.0, -90.0],
                         ids=["smooth", "far_right", "far_left"])
@pytest.mark.parametrize("channels", [1, 5])
def test_resample_kernel_matches_plain(cuda, shift, channels):
    """Bit-equal to the plain version, off-image coordinates and NaN /
    inf coordinates included (NaN where a coordinate is not finite)."""
    h, w = 96, 200
    hist = torch.rand((channels, h, w), device=cuda)
    px_f, py_f = _resample_field(h, w, shift, cuda)
    px_f[0, :8] = float("nan")
    py_f[1, :8] = float("inf")
    px_f[2, :8] = float("-inf")
    py_f[3, :8] = 1e30
    ks, kok = reproject.resample_cuda(hist, px_f, py_f)
    ps, pok = reproject.resample_plain(hist, px_f, py_f)
    torch.cuda.synchronize()
    assert kok.all() and pok.all()
    assert torch.equal(ks.isnan(), ps.isnan()) and ks[:, :3, :8].isnan().all()
    assert torch.allclose(ks, ps, rtol=0.0, atol=0.0, equal_nan=True)


@pytest.mark.parametrize("d_pos", [(0.3, -0.2, 0.4), (2.0, 1.0, -1.5)],
                         ids=["small", "large"])
def test_temporal_blend_cuda_resampler_equals_plain(cuda, d_pos):
    """The channels-last blend on CUDA tensors runs the resample kernel
    and equals the reprojecting body around the plain resampler, on
    menger G-buffers from two poses."""
    w, h = 320, 180
    cam = Camera(position=MENGER.position + np.array(d_pos),
                 direction=MENGER.direction)
    old, new = _menger_gbuf(MENGER, cuda, w, h), _menger_gbuf(cam, cuda, w, h)
    hwc = lambda a: torch.movedim(a, 0, -1)  # noqa: E731
    args = (hwc(new["color"]), hwc(new["normal"]), new["depth"],
            hwc(old["color"]), torch.full((h, w), 0.3, device=cuda),
            old["depth"], cam.rows(w, h), MENGER.rows(w, h),
            TemporalParams(), True)
    before = reproject.resample_cuda.launches
    kc, kb = temporal.temporal_blend(*args, reproject=True)
    pc, pb = temporal._blend_reproject(
        new["color"], new["normal"], new["depth"], old["color"], args[4],
        old["depth"], pack_temporal_params(*args[6:]),
        reproject.resample_plain)
    torch.cuda.synchronize()
    assert reproject.resample_cuda.launches == before + 1
    assert (pb < 0.5).any(), "degenerate comparison: no history kept"
    assert torch.equal(kc, torch.movedim(pc, 0, -1)) and torch.equal(kb, pb)


@pytest.mark.parametrize(
    "case", ["static:1", "static:2:0:2", "ser:1", "ser:2:0:3", "ser:4:2:1",
             "ind:2", "ind:4:1:2", "ser:1:512", "ser:1:0:256"])
def test_stallbench_kernel_matches_plain(cuda, case):
    mode, h, pre, mid = stallbench.parse_case(case)
    tab, x = stallbench.make_inputs(cuda)
    out, cycles = stallbench.run_cuda(tab, x, 16, mode, h, pre, mid)
    want = stallbench.run_plain(tab, x, 16, mode, h, pre, mid)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert int(cycles.item()) > 0


def test_harness_config4_runs_the_resample_kernel(cuda, monkeypatch, capsys):
    """Config 4 of the BASELINE harness, shrunk, times the channels-last
    blend with the resample kernel."""
    monkeypatch.setattr(bench, "SIZES",
                        {**bench.SIZES, 4: {"hw": (90, 160), "frames": 2}})
    before = reproject.resample_cuda.launches
    assert bench.main(["--only", "4"]) == 0
    assert reproject.resample_cuda.launches - before == 6  # warm + 5 timed
    (line,) = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert "temporal_reproject" in line and "error" not in line
