"""The CUDA kernels (trace, temporal reprojection, denoise, history
resample, stall microbenchmark, the frame epilogue's still epilogue and
encode) against their plain torch versions and the golden file, and the
Renderer and the BASELINE harness on the card.  Needs an NVIDIA GPU and
nvcc; skips elsewhere.  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: trace node, depth, normal and albedo bit-exact (the kernels
are built without FMA contraction and perform the plain versions' float
operations in their order), and so are the rays and DDA steps of the
phases before the first hemisphere sample (b0, s0, b1); trace color:
cos/sin/exp/log may round differently in the two builds, which can turn
a secondary ray at a grazing edge, so at most 0.5% of pixels may differ
by more than 1e-3 (0 measured on an H100 with torch 2.11 / CUDA 12.8).
Temporal: validity and next blend bit-exact, colour within 1e-6 (no
transcendental).
Denoise: 1e-6 absolute plus 1e-6 relative (expf/logf may round
differently from torch's), at every template instance of the kernel,
its runtime-radius instance and the instance for radii whose tile does
not fit shared memory, on sizes that are no multiple of its tile.
Resample: bit-equal, NaN where a coordinate is not finite (no
transcendental).  Stall microbenchmark: integer, equal.  Epilogue and
encode: float32 outputs bit-equal, u8 equal (powf as torch's pow kernel
calls it), NaN and +-inf planes included.  A kernel's
row-reading entry equals its by-value entry, the row-reading still blend
and modulate equal the forms that read Python numbers, and a sequence
replayed from CUDA graphs equals the same frames from ``render()``: all
bit for bit (the same code on the same values).
"""

import os

import numpy as np
import pytest
import torch

from voxtracer_torch.app import bench, camera_paths, stallbench
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.params import (
    ROW_DENOISE,
    ROW_TEMPORAL,
    ROW_TRACE,
    DenoiseParams,
    DeviceRow,
    RenderParams,
    TemporalParams,
    pack_denoise_params,
    pack_frame_rows,
    pack_temporal_params,
    pack_trace_params,
)
from voxtracer_torch.engine.pipeline import STATE_PLANES, Renderer
from voxtracer_torch.engine.scene import (
    GridScene,
    SceneTables,
    VoxelList,
    load_scene,
)
from voxtracer_torch.ops import denoise, epilogue, reproject, temporal, trace
from voxtracer_torch.ops.noise import blue_noise_buffer, white_noise_buffer
from voxtracer_torch.scene import grid

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
    np.testing.assert_array_equal(k["steps"][:3], p["steps"][:3])
    # the traversal's SIMT efficiency is a share
    assert 0 < k["steps"].sum() <= 32 * k["slots"][0]


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
        monkeypatch.setattr(grid, "BRICK_DEDUP_MAX", dedup_max)
    _assert_kernel_matches_plain(*_both(
        load_scene("menger"), MENGER, 160, 96,
        torch.from_numpy(blue_noise_buffer()), cuda,
    ))


def test_kernel_matches_plain_ragged_size(cuda):
    """333x187 is no multiple of the kernel's 16x16 block."""
    _assert_kernel_matches_plain(*_both(
        load_scene("menger"), MENGER, 333, 187,
        torch.from_numpy(blue_noise_buffer()), cuda,
    ))


def test_kernel_info(cuda):
    """The kernel spills nothing and keeps warps resident."""
    info = trace.kernel_info()
    assert info["spill_bytes"] == 0 and info["warps_per_sm"] >= 24, info


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
    still = epilogue.still_epilogue_cuda.launches
    for _ in range(3):
        out_gpu = gpu.render(MENGER)
        out_cpu = cpu.render(MENGER)
    assert trace.render_sample_cuda.launches - before == 3
    assert epilogue.still_epilogue_cuda.launches - still == 3
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


def _denoise_planes(h, w, device, seed=0):
    """Random G-buffer planes with sky pixels (depth -1, normal 2^30,
    the miss node) and nodes whose top bit is set (node >> 24 < 0)."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((3, h, w)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    depth = (rng.random((h, w), np.float32) * 10 + 1).astype(np.float32)
    node = (rng.integers(0, 3, (h, w)) << 24).astype(np.int32)
    sky = rng.random((h, w)) < 0.2
    depth[sky] = -1.0
    n[:, sky] = np.float32(1 << 30)
    node[sky] = 0xFFFFFF
    leaf = ~sky & (rng.random((h, w)) < 0.2)
    node[leaf] = np.int32(-(1 << 31)) | node[leaf]
    planes = (rng.random((3, h, w), np.float32), n, depth,
              rng.random((3, h, w), np.float32), node)
    return tuple(torch.from_numpy(a).to(device) for a in planes)


def _assert_denoise_matches_plain(h, w, radius, device):
    planes = _denoise_planes(h, w, device, seed=radius)
    params = pack_denoise_params(MENGER.rows(w, h), DenoiseParams(
        sigma_distance=1.2, sigma_range=0.7, albedo_factor=0.35))
    before = denoise.denoise_cuda.launches
    k = denoise.denoise_cuda(*planes, params, radius)
    p = denoise.denoise_plain(*planes, params, radius)
    torch.cuda.synchronize()
    assert denoise.denoise_cuda.launches == before + 1
    assert torch.isfinite(p).all()
    assert ((k - p).abs() <= 1e-6 + 1e-6 * p.abs()).all()


@pytest.mark.parametrize("radius", [*range(1, 9), 12])
@pytest.mark.parametrize("h, w", [(1, 1), (3, 5), (19, 37), (187, 333),
                                  (1080, 1920), (2160, 3840)])
def test_denoise_kernel_ragged_sizes(cuda, h, w, radius):
    """Sizes that are no multiple of the kernel's 32x32 tile, at every
    template instance and at r = 12 (the runtime-radius instance), with
    misses and negative node ids."""
    _assert_denoise_matches_plain(h, w, radius, cuda)


def _interior_blocks(h, w, radius):
    """Blocks whose haloed tile lies inside the frame (no bounds test)."""
    plan = denoise.tile_plan(h, w, radius)
    tile_w = plan.block[0]
    tile_h = plan.block[1] * plan.rows_per_thread
    return sum(bx * tile_w >= radius and by * tile_h >= radius
               and (bx + 1) * tile_w + radius <= w
               and (by + 1) * tile_h + radius <= h
               for bx in range(plan.grid[0]) for by in range(plan.grid[1]))


@pytest.mark.parametrize("h, w, radius, interior", [
    (1024, 1024, 2, 900), (24, 40, 8, 0), (64, 64, 26, 0)],
    ids=["interior", "border_only", "largest_radius"])
def test_denoise_kernel_interior_and_border_blocks(cuda, h, w, radius,
                                                   interior):
    """A frame of mostly interior blocks, one of border blocks only, and
    the largest radius whose tile fits a block's shared memory."""
    assert _interior_blocks(h, w, radius) == interior
    _assert_denoise_matches_plain(h, w, radius, cuda)


def test_denoise_kernel_refuses_a_tile_beyond_shared_memory(cuda):
    """r = 27, whose tile no longer fits, is not refused (the test keeps
    the name it had while it was): the plan is the instance that reads
    its taps from global memory, and it matches the plain version."""
    assert denoise.tile_plan(40, 40, 27).instance == denoise.GLOBAL_INSTANCE
    _assert_denoise_matches_plain(40, 40, 27, cuda)


@pytest.mark.parametrize("radius", [27, 32])
@pytest.mark.parametrize("h, w", [(3, 5), (19, 37), (187, 333)])
def test_denoise_kernel_beyond_the_tile(cuda, h, w, radius):
    """Radii above 26 on sizes that are no multiple of the block."""
    _assert_denoise_matches_plain(h, w, radius, cuda)


def _path_rows(device, w, h, cursor, dp=DenoiseParams()):
    """Three frames of a menger path: frame ``cursor``'s row on the
    device, the rows on the host and the cameras."""
    cams = [Camera(position=MENGER.position + np.array([0.2 * i, 0.1 * i, 0]),
                   direction=MENGER.direction).rows(w, h) for i in range(4)]
    rows = pack_frame_rows(cams[1:], cams[0], True, 7, RenderParams(),
                           TemporalParams(), dp)
    device_row = DeviceRow(
        torch.from_numpy(rows).to(device).index_select(
            0, torch.tensor([cursor], device=device))[0], rows[0])
    return device_row, rows, cams


@pytest.mark.parametrize("cursor", [0, 2])
def test_row_entries_equal_by_value_entries(cuda, cursor):
    """Each frame kernel reading a row on the device against the same
    kernel given that row's slice by value: equal bit for bit, counters
    included, at a ragged size and a denoise radius of each kind of
    instance."""
    w, h = 333, 187
    dp = DenoiseParams(sigma_distance=1.2, sigma_range=0.7, albedo_factor=0.35)
    frame_rows, rows, _ = _path_rows(cuda, w, h, cursor, dp)
    row = rows[cursor]
    tables = SceneTables(load_scene("menger"), cuda)
    noise = torch.from_numpy(blue_noise_buffer()).to(cuda)
    before = trace.render_sample_cuda.launches
    g = trace.render_sample_cuda(tables, frame_rows, noise, None, h, w)
    v = trace.render_sample_cuda(tables, row[ROW_TRACE:ROW_TRACE + 32], noise,
                                 7 + cursor, h, w)
    assert trace.render_sample_cuda.launches == before + 2
    assert (v["depth"] >= 0).any()
    for key in v:
        assert torch.equal(g[key], v[key]), key

    old = _menger_gbuf(MENGER, cuda, w, h)
    blend = torch.full((h, w), 0.3, device=cuda)
    args = (g["color"], g["normal"], g["depth"], old["color"], blend,
            old["depth"])
    rc, rb = temporal.temporal_blend_reproject_cuda(*args, frame_rows)
    vc, vb = temporal.temporal_blend_reproject_cuda(
        *args, row[ROW_TEMPORAL:ROW_TEMPORAL + 40])
    assert (vb < 0.5).any(), "degenerate comparison: no history kept"
    assert torch.equal(rc, vc) and torch.equal(rb, vb)

    for radius in (1, 2, 12, 27):
        planes = (vc, g["normal"], g["depth"], g["albedo"], g["node"])
        r = denoise.denoise_cuda(*planes, frame_rows, radius)
        v = denoise.denoise_cuda(*planes, row[ROW_DENOISE:ROW_DENOISE + 16],
                                 radius)
        assert torch.equal(r, v), radius
    torch.cuda.synchronize()


def test_row_reading_still_blend_and_modulate_equal_by_value(cuda):
    """The plain torch stages of a frame reading 0-dim views of the
    device row against the forms reading Python numbers."""
    w, h = 333, 187
    dp = DenoiseParams(albedo_factor=0.35)
    frame_rows, rows, cams = _path_rows(cuda, w, h, 1, dp)
    g = _menger_gbuf(MENGER, cuda, w, h)
    old = _menger_gbuf(MENGER, cuda, w, h)
    blend = torch.full((h, w), 0.3, device=cuda)
    args = (g["color"], g["normal"], g["depth"], old["color"], blend,
            old["depth"])
    rc, rb = temporal.temporal_blend_still_row(*args, frame_rows.row)
    hc, hb = temporal.temporal_blend_still_row(*args, rows[1])
    vc, vb = temporal.temporal_blend_still_planar(
        *args, cams[2], cams[1], TemporalParams(), True)
    assert torch.equal(rc, vc) and torch.equal(rb, vb)
    assert torch.equal(hc, vc) and torch.equal(hb, vb)
    assert torch.equal(
        denoise.modulate_row(vc, g["albedo"], frame_rows.row),
        denoise._modulate(vc, g["albedo"], rows[1][ROW_DENOISE + 14]))
    assert torch.equal(
        denoise.denoise(vc, g["normal"], g["depth"], g["albedo"], g["node"],
                        frame_rows, 0),
        denoise.denoise(vc, g["normal"], g["depth"], g["albedo"], g["node"],
                        rows[1][ROW_DENOISE:ROW_DENOISE + 16], 0))


def _bits_equal(a, b):
    """Equal bit for bit (float32 NaNs included) or, for u8, in value."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _epilogue_planes(h, w, device, seed=0, specials=False):
    """Still-epilogue planes (colour, normal, depth, old colour, old
    blend, old depth) and an albedo plane, seeded; with ``specials`` NaN,
    +-inf, negative and > 1 values in every plane."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.0, 30.0, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < 0.1] = -1.0
    normal = rng.normal(size=(3, h, w)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=0, keepdims=True)
    arrays = [rng.uniform(-0.3, 2.0, (3, h, w)).astype(np.float32),
              normal.astype(np.float32), depth,
              rng.uniform(0.0, 1.5, (3, h, w)).astype(np.float32),
              rng.uniform(0.02, 1.0, (h, w)).astype(np.float32),
              (depth + rng.uniform(-0.01, 0.01, (h, w))).astype(np.float32),
              rng.uniform(0.0, 1.2, (3, h, w)).astype(np.float32)]
    if specials:
        for a in arrays:
            flat = a.reshape(-1)
            for v in (np.nan, np.inf, -np.inf, -2.5, 4.0):
                flat[rng.integers(0, flat.size, max(1, flat.size // 40))] = v
    t = [torch.from_numpy(a).to(device) for a in arrays]
    return tuple(t[:6]), t[6]


def _epilogue_row(w, h, valid=True, factor=0.35):
    rows = MENGER.rows(w, h)
    tp = TemporalParams(blending_distance_cutoff=0.05)
    return pack_frame_rows([rows], rows, valid, 2, RenderParams(), tp,
                           DenoiseParams(albedo_factor=factor))[0]


def _device_row(row, device):
    return DeviceRow(torch.from_numpy(row.copy()).to(device), row)


@pytest.mark.parametrize("valid", [True, False], ids=["history", "none"])
@pytest.mark.parametrize("planes", ["random", "nan_inf", "menger"])
@pytest.mark.parametrize("h, w", [(1, 1), (3, 5), (187, 333), (720, 1280)])
def test_still_epilogue_kernel_matches_plain(cuda, h, w, planes, valid):
    """The still epilogue kernel, by value and by row, with and without
    the linear and without the albedo (the blend alone), against its
    plain version: float32 bit-equal, u8 equal."""
    if planes == "menger":
        if h < 187:
            pytest.skip("menger frames at the ragged size only")
        g = _menger_gbuf(MENGER, cuda, w, h)
        blend = torch.full((h, w), 0.3, device=cuda)
        # the history: the same surface, another colour
        ins = (g["color"], g["normal"], g["depth"], g["color"] * 0.5, blend,
               g["depth"])
        albedo = g["albedo"]
    else:
        ins, albedo = _epilogue_planes(h, w, cuda, specials=planes != "random")
    row = _epilogue_row(w, h, valid)
    want = epilogue.still_epilogue_plain(*ins, albedo, row, True)
    alone = epilogue.still_epilogue_plain(*ins, None, row)
    before = epilogue.still_epilogue_cuda.launches
    for params in (row, _device_row(row, cuda)):
        for keep in (False, True):
            got = epilogue.still_epilogue_cuda(*ins, albedo, params, keep)
            assert (got[2] is None) == (not keep)
            for a, b in zip(got, want):
                assert a is None or _bits_equal(a, b)
        got = epilogue.still_epilogue_cuda(*ins, None, params)
        assert got[2:] == (None, None)
        assert _bits_equal(got[0], alone[0]) and _bits_equal(got[1], alone[1])
    torch.cuda.synchronize()
    assert epilogue.still_epilogue_cuda.launches == before + 6
    if valid and planes != "nan_inf" and h > 1:
        kept = (alone[0] != ins[0]).any(0).float().mean()
        assert 0 < kept < 1, "degenerate comparison: one validity branch"


@pytest.mark.parametrize("albedo", [True, False], ids=["modulated", "plain"])
@pytest.mark.parametrize("specials", [False, True], ids=["random", "nan_inf"])
@pytest.mark.parametrize("h, w, crop", [(1, 1, 0), (3, 5, 0), (187, 333, 0),
                                        (190, 338, 3), (720, 1280, 0),
                                        (1084, 1924, 4)])
def test_encode_kernel_matches_plain(cuda, h, w, crop, specials, albedo):
    """The encode kernel (cropped, modulated or not, by value and by row,
    with and without the linear) against its plain version."""
    ins, alb = _epilogue_planes(h, w, cuda, seed=1, specials=specials)
    lin = ins[0]
    args = (lin, h - crop, w - crop, alb) if albedo else (lin, h - crop,
                                                          w - crop)
    row = _epilogue_row(w - crop, h - crop, factor=0.6)
    want = epilogue.encode_plain(*args, row if albedo else None, True)
    for params in ((row, _device_row(row, cuda)) if albedo else (None,)):
        for keep in (False, True):
            image, out = epilogue.encode_cuda(*args, params, keep)
            assert image.shape == (h - crop, w - crop, 3)
            assert torch.equal(image, want[0])
            if albedo and not keep:
                assert out is None
            else:
                assert _bits_equal(out, want[1])
    torch.cuda.synchronize()


@pytest.mark.parametrize("valid", [True, False], ids=["history", "none"])
@pytest.mark.parametrize("h, w", [(48, 64), (187, 333), (720, 1280),
                                  (2160, 3840)])
def test_still_epilogue_kernel_in_place(cuda, h, w, valid):
    """The still epilogue kernel on menger planes at widths that are (64,
    1280, 3840: four pixels a thread) and are not (333: the scalar path)
    multiples of 4, out of place and in place (into a copy of the
    history: blend, next blend and depth written over it), by value and
    by row, with and without the linear, and the blend alone: float32
    bit-equal and u8 equal to the plain version out of place."""
    g = _menger_gbuf(MENGER, cuda, w, h)
    rng = np.random.default_rng(3)
    blend = torch.from_numpy(
        rng.uniform(0.02, 1.0, (h, w)).astype(np.float32)).to(cuda)
    shift = torch.from_numpy(
        rng.uniform(-0.02, 0.02, (h, w)).astype(np.float32)).to(cuda)
    ins = (g["color"], g["normal"], g["depth"], g["color"] * 0.5, blend,
           torch.where(g["depth"] >= 0, g["depth"] + shift, g["depth"]))
    row = _epilogue_row(w, h, valid)
    for albedo in (g["albedo"], None):
        want = epilogue.still_epilogue_plain(*ins, albedo, row, True)
        for params in (row, _device_row(row, cuda)):
            for keep in (False, True):
                history = [t.clone() for t in ins[3:]]
                got = epilogue.still_epilogue_cuda(
                    *ins[:3], *history, albedo, params, keep, in_place=True)
                out = epilogue.still_epilogue_cuda(*ins, albedo, params, keep)
                assert got[0] is history[0] and got[1] is history[1]
                assert _bits_equal(history[2], ins[2])
                for result in (got, out):
                    for a, b in zip(result, want):
                        assert a is None or _bits_equal(a, b)
    torch.cuda.synchronize()
    if valid:
        kept = (want[0] != ins[0]).any(0).float().mean()
        assert 0 < kept < 1, "degenerate comparison: one validity branch"


def test_encode_kernel_on_every_float_in_the_unit_interval(cuda):
    """Every float32 in [0, 1] (the clamp sends every other value to 0, 1
    or NaN) and the specials: the kernel's u8 equals the plain
    version's, i.e. its powf rounds as torch's pow kernel."""
    top = int(np.float32(1.0).view(np.int32))
    chunk = 3 * 2048 * 4096
    for start in range(0, top + 1, chunk):
        bits = torch.arange(start, start + chunk, dtype=torch.int32,
                            device=cuda).clamp_max_(top)
        lin = bits.view(torch.float32).view(3, 2048, 4096)
        got, _ = epilogue.encode_cuda(lin, 2048, 4096)
        want, _ = epilogue.encode_plain(lin, 2048, 4096)
        assert torch.equal(got, want), start
    special = torch.tensor(
        [np.nan, np.inf, -np.inf, -0.0, -1e-30, -5.0, 1.0000001, 3e38],
        dtype=torch.float32, device=cuda).repeat(3, 1)[:, None].contiguous()
    assert torch.equal(epilogue.encode_cuda(special, 1, 8)[0],
                       epilogue.encode_plain(special, 1, 8)[0])


def test_epilogue_kernels_write_the_device_slot(cuda):
    """Given ``dest = (frames, slot)`` both kernels write frames[slot]
    and nothing else; a slot outside the frames writes nothing."""
    h, w = 37, 53
    ins, albedo = _epilogue_planes(h, w, cuda, seed=2)
    row = _epilogue_row(w, h)
    want = epilogue.still_epilogue_plain(*ins, albedo, row)[3]
    frames = torch.zeros((3, h, w, 3), dtype=torch.uint8, device=cuda)
    slot = torch.tensor([1], device=cuda)
    got = epilogue.still_epilogue_cuda(*ins, albedo, row, dest=(frames, slot))
    assert got[3] is None
    assert torch.equal(frames[1], want) and not frames[0].any()
    assert not frames[2].any()
    slot.fill_(2)
    image, _ = epilogue.encode_cuda(ins[0], h, w, albedo, row,
                                    dest=(frames, slot))
    assert image is None and torch.equal(
        frames[2], epilogue.encode_plain(ins[0], h, w, albedo, row)[0])
    frames.zero_()
    slot.fill_(3)
    epilogue.encode_cuda(ins[0], h, w, dest=(frames, slot))
    epilogue.still_epilogue_cuda(*ins, albedo, row, dest=(frames, slot))
    torch.cuda.synchronize()
    assert not frames.any()
    with pytest.raises(ValueError, match="frames must be"):
        epilogue.encode_cuda(ins[0], h, w, dest=(frames[:, :-1], slot))
    with pytest.raises(ValueError, match="slot must be"):
        epilogue.encode_cuda(ins[0], h, w, dest=(frames, slot.int()))


def _sequence_paths(scene):
    orbit = camera_paths.orbit(scene, distance=0.6)
    return {
        "still": [orbit(0.0)] * 5,
        "orbit": [orbit(i / 30.0) for i in range(5)],
        "mixed": [orbit(t / 30.0) for t in (0, 0, 1, 2, 2, 2, 3)],
    }


@pytest.mark.parametrize("path, radius", [("still", 1), ("orbit", 0),
                                          ("mixed", 2), ("mixed", 0)])
def test_graph_replayed_sequence_equals_the_loop(cuda, path, radius):
    """Frames, state, counters and launch counts of a sequence replayed
    from CUDA graphs, of the same frames run eagerly through the
    row-reading entries, and of ``render()`` calls; twice, so that the
    second sequence replays graphs captured by the first and starts from
    live history; then a ``render()`` that follows."""
    scene = load_scene("chr_knight")
    cams = _sequence_paths(scene)[path]
    kw = dict(scene=scene, height=90, width=123, device="cuda",
              denoise_radius=radius, lean=True)
    loop, graph, eager = Renderer(**kw), Renderer(**kw), Renderer(**kw)
    counters = (trace.render_sample_cuda,
                temporal.temporal_blend_reproject_cuda, denoise.denoise_cuda,
                epilogue.still_epilogue_cuda, epilogue.encode_cuda)

    def counted(fn):
        before = [c.launches for c in counters]
        out = fn()
        return out, [c.launches - b for c, b in zip(counters, before)]

    for again in (False, True):
        kinds = set() if again else set(graph._pack_sequence(cams)[1])
        want, n_loop = counted(
            lambda: torch.stack([loop.render(c)["image"] for c in cams]))
        got, n_graph = counted(lambda: graph.render_sequence(cams))
        got_eager, n_eager = counted(
            lambda: eager.render_sequence(cams, graph=False))
        torch.cuda.synchronize()
        assert got.shape == (len(cams), 90, 123, 3) and got.dtype == torch.uint8
        assert torch.equal(got, want) and torch.equal(got_eager, want)
        for r in (graph, eager):
            for k in STATE_PLANES:
                assert torch.equal(r.state[k], loop.state[k]), k
            np.testing.assert_array_equal(r.state["old_cam"],
                                          loop.state["old_cam"])
            assert r.state["history_valid"]
            assert (r.frame_number, r.still_sample) == (
                loop.frame_number, loop.still_sample)
        assert n_eager == n_loop
        # the first sequence also ran one eager frame before each capture:
        # trace, temporal or still epilogue, denoise at r >= 1, encode
        # unless a still frame at r = 0 encoded in its epilogue
        warm = [0] * 5
        for moving in kinds:
            for i, n in enumerate((1, moving, bool(radius), not moving,
                                   moving or bool(radius))):
                warm[i] += int(n)
        assert n_graph == [a + b for a, b in zip(n_loop, warm)]
    follow = camera_paths.orbit(scene, distance=0.6)(0.5)
    assert torch.equal(graph.render(follow)["image"],
                       loop.render(follow)["image"])


@pytest.mark.parametrize("radius", [0, 2])
def test_replayed_still_frames_blend_into_the_carried_state(cuda, radius):
    """At a width that is a multiple of 4, a mixed path replayed from
    CUDA graphs equals the loop; a replayed still frame copies nothing
    into the carried state (its epilogue blends there): its only copies
    are the rows of the row-reading launches (trace, still epilogue,
    denoise), three fewer than a reprojecting frame's at r = 0 beside
    its rows (trace, temporal, encode)."""
    from voxtracer_torch.app.profile import frame_activities

    scene = load_scene("chr_knight")
    cams = _sequence_paths(scene)["mixed"]
    kw = dict(scene=scene, height=96, width=128, device="cuda",
              denoise_radius=radius, lean=True)
    loop, seq = Renderer(**kw), Renderer(**kw)
    for _ in range(2):
        want = torch.stack([loop.render(c)["image"] for c in cams])
        assert torch.equal(seq.render_sequence(cams), want)
        for k in STATE_PLANES:
            assert torch.equal(seq.state[k], loop.state[k]), k

    def copies(path):  # a graph's copy shows as Memcpy or memcpy32_*
        return frame_activities(lambda: seq.render_sequence(path), cuda,
                                len(path))[1]

    # per frame, within 4 frames of one kind
    still, moving = [cams[4]] * 4, [cams[i % 2 + 2] for i in range(4)]
    seq.render_sequence(still)
    per_still = copies(still)
    seq.render_sequence(moving)
    per_moving = copies(moving)
    rows = 3 if radius else 2  # trace, still epilogue (, denoise)
    assert per_still == rows, per_still
    if not radius:
        assert per_moving == 3 + 3, per_moving


def test_burst_on_cuda_returns_the_last_frame_of_any_length(cuda):
    """A burst equals as many ``render()`` calls and holds one image;
    a longer one afterwards only needs more rows."""
    scene = load_scene("menger")
    kw = dict(scene=scene, height=48, width=64, device="cuda", lean=True)
    loop, burst = Renderer(**kw), Renderer(**kw)
    for n in (3, 9):
        for _ in range(n):
            want = loop.render(MENGER)["image"]
        got = burst.render_burst(MENGER, n)
        assert got.shape == (48, 64, 3) and torch.equal(got, want)
        assert burst._runner.frames.shape[0] == 1
        assert burst.still_sample == loop.still_sample
    assert burst.frame_number == 12


def test_graphs_are_dropped_with_what_they_froze(cuda):
    """A changed radius, size or scene gets a new runner; the sequence
    after it still equals the loop."""
    scene = load_scene("menger")
    kw = dict(scene=scene, height=48, width=64, device="cuda", lean=True)
    loop, seq = Renderer(**kw), Renderer(**kw)
    cams = [MENGER] * 3

    def check():
        want = torch.stack([loop.render(c)["image"] for c in cams])
        assert torch.equal(seq.render_sequence(cams), want)

    check()
    first = seq._runner
    check()
    assert seq._runner is first and len(first.graphs) == 1
    for r in (loop, seq):
        r.denoise_radius = 2
    check()
    assert seq._runner is not first
    for r in (loop, seq):
        r.resize(40, 56)
    assert seq._runner is None
    check()
    for r in (loop, seq):
        r.set_scene(load_scene("chr_knight"))
    assert seq._runner is None
    check()


def test_renderer_on_cuda_runs_every_kernel_on_a_moving_path(cuda):
    """Four frames along an orbit at denoise radius 2: the trace, denoise
    and encode kernels launch every frame, the temporal kernel on the
    three frames that move with live history, the still epilogue on the
    first; images agree with the CPU renderer's."""
    scene = load_scene("chr_knight")
    path = camera_paths.orbit(scene, distance=0.6)
    gpu = Renderer(scene=scene, height=48, width=64, device="cuda",
                   denoise_radius=2)
    cpu = Renderer(scene=scene, height=48, width=64, device="cpu",
                   denoise_radius=2)
    counters = (trace.render_sample_cuda, temporal.temporal_blend_reproject_cuda,
                denoise.denoise_cuda, epilogue.still_epilogue_cuda,
                epilogue.encode_cuda)
    before = [c.launches for c in counters]
    for i in range(4):
        out_gpu = gpu.render(path(i / 30.0))
        out_cpu = cpu.render(path(i / 30.0))
    # the first frame blends in the still epilogue; every frame encodes
    assert [c.launches - b for c, b in zip(counters, before)] == [
        4, 3, 4, 1, 4]
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


@pytest.mark.parametrize("trips", [16, 37])
@pytest.mark.parametrize(
    "case", ["static:1", "static:2:0:2", "ser:1", "ser:2:0:3", "ser:4:2:1",
             "ind:2", "ind:4:1:2", "ser:1:512", "ser:1:0:256", "static:8",
             "ser:8", "ind:8", "ind:4:512:256", "ser:3:1:2", "ind:5:2:1"])
def test_stallbench_kernel_matches_plain(cuda, case, trips):
    """Every mode at MAX_H, odd trip and sweep counts (the handoff's
    buffers cycle by two; the static bases by the trip count mod 232)
    and the longest chains."""
    mode, h, pre, mid = stallbench.parse_case(case)
    tab, x = stallbench.make_inputs(cuda)
    out, cycles = stallbench.run_cuda(tab, x, trips, mode, h, pre, mid)
    want = stallbench.run_plain(tab, x, trips, mode, h, pre, mid)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert int(cycles.item()) > 0


@pytest.mark.parametrize("mode", ["ser", "static"])
def test_stallbench_kernel_matches_plain_at_the_cli_trips(cuda, mode):
    tab, x = stallbench.make_inputs(cuda)
    out, _ = stallbench.run_cuda(tab, x, 16384, mode, 1, 0, 0)
    want = stallbench.run_plain(tab, x, 16384, mode, 1, 0, 0)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


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


_STEPS_CASES = {
    "single_voxel": (lambda: GridScene.from_voxels(VoxelList(
        pos=np.array([[0, 0, 0]], dtype=np.int16),
        mrgb=np.array([[0, 200, 100, 50]], dtype=np.uint8))),
        Camera(position=np.array([0.3, 0.2, -1.5])), 32, 32),
    "menger": (lambda: load_scene("menger"), MENGER, 160, 96),
    "ragged": (lambda: load_scene("menger"), MENGER, 333, 187),
}


@pytest.mark.parametrize("case", list(_STEPS_CASES))
def test_steps_map_kernel_matches_plain(cuda, case):
    """The steps-map instance: the shipped instance's outputs and
    counters, each phase's map summing to its ``steps``, the map equal
    to the plain version's, and so the decay curve too."""
    scene_fn, cam, w, h = _STEPS_CASES[case]
    args = (SceneTables(scene_fn(), cuda),
            pack_trace_params(cam.rows(w, h), RenderParams()),
            torch.from_numpy(blue_noise_buffer()).to(cuda), 1, h, w)
    before = trace.render_sample_steps_cuda.launches
    k = trace.render_sample_steps(*args)
    assert trace.render_sample_steps_cuda.launches - before == 1
    s = trace.render_sample_cuda(*args)
    p = trace.render_sample_plain(*args, steps_map=True)
    torch.cuda.synchronize()
    for key in ("color", "normal", "depth", "albedo", "node", "rays", "steps",
                "slots"):
        assert torch.equal(k[key], s[key]), key
    assert torch.equal(k["steps_map"].sum(dim=(1, 2)).long(), k["steps"])
    assert torch.equal(k["steps_map"], p["steps_map"])
    assert trace.warp_decay(k["steps_map"]) == trace.warp_decay(
        p["steps_map"])


def test_slabprobe_on_the_card(cuda):
    """Slabs of menger 320x180 in 2 x k and the cyclic layout: every slab
    exact against the frame's rows, timed, with its waves."""
    from voxtracer_torch.app import slabprobe

    scene = load_scene("menger")
    rows = slabprobe.probe(scene, 320, 180, 2, [1, 2], cuda, reps=2, chain=4)
    assert [r.get("k") for r in rows[1:]] == [1, 2]
    for r in rows[1:]:
        assert r["exact"] and all(v > 0 for v in r["slab_ms"])
        assert len(r["slab_waves"]) == 2 * r["k"]
    (_, cyc) = slabprobe.probe(scene, 320, 180, 2, [], cuda, reps=2, chain=4,
                               cyclic=True)
    assert cyc["exact"] and cyc["pad_waste"] == 0.0 and cyc["h_pad"] == 180


def test_scaleprobe_node_agreement_is_exact_on_the_card(cuda):
    """The kernel is bit-equal to its plain version, so the shell's node
    agreement is 1.0 exactly."""
    from voxtracer_torch.app import scaleprobe

    res = scaleprobe.probe(64, 128, 72, 2, cuda, plain=True, say=lambda s: 0)
    assert res["node_agreement"] == 1.0 and res["disagreements"] == 0
    assert res["hit_fraction"] > 0 and 0 < res["trace_share"] <= 1.0
    assert res["l2_bytes"] > 0


def test_bluenoise_bakes_on_the_card(cuda):
    """The baker on the card meets the JAX test's bar."""
    from voxtracer_torch.ops import bluenoise

    noise = bluenoise.generate(count=2, size=16, seed=1, device=cuda)
    n = 16 * 16
    for s in range(2):
        np.testing.assert_allclose(np.sort(noise[s].reshape(-1)),
                                   (np.arange(n) + 0.5) / n, atol=1e-6)
    pat = (noise[0] < 0.25).astype(np.float64)
    pat -= pat.mean()
    spec = np.abs(np.fft.fft2(pat)) ** 2
    freq = np.fft.fftfreq(16)
    fy, fx = np.meshgrid(freq, freq, indexing="ij")
    rad = np.sqrt(fy**2 + fx**2)
    assert spec[rad > 0.3].mean() > 2.0 * spec[(rad < 0.15) & (rad > 0)].mean()
