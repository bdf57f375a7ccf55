"""The CUDA trace kernel against its plain torch version and the golden
file.  Needs an NVIDIA GPU and nvcc; skips elsewhere.  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: node, depth, normal and albedo bit-exact (the kernel is
built without FMA contraction and performs the plain version's float
operations in its order); color: cos/sin/exp/log may round differently
in the two builds, which can turn a secondary ray at a grazing edge, so
at most 0.5% of pixels may differ by more than 1e-3 (0 measured on an
H100 with torch 2.11 / CUDA 12.8).
"""

import os

import numpy as np
import pytest
import torch

from voxtracer_torch.engine import scene as scene_mod
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.params import RenderParams, pack_trace_params
from voxtracer_torch.engine.pipeline import Renderer
from voxtracer_torch.engine.scene import (
    GridScene,
    SceneTables,
    VoxelList,
    load_scene,
)
from voxtracer_torch.ops import trace
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
