"""The frame's elementwise stages (still blend, radius-0 modulate, u8
encode) against the JAX package's functions, on seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.engine import params as jparams
from voxtracer.ops import denoise_pallas
from voxtracer.ops import temporal as jtemporal
from voxtracer.ops import tonemap as jtonemap
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.params import (
    DenoiseParams,
    TemporalParams,
    pack_denoise_params,
)
from voxtracer_torch.ops import denoise, temporal, tonemap

H, W = 24, 40


def _still_inputs(seed):
    """A plausible frame: depths along the camera's rays, a history that
    is the same surface for most pixels and another for the rest, some
    sky pixels (depth -1) in both."""
    rng = np.random.default_rng(seed)
    cam = Camera(position=np.array([1.0, 2.0, -6.0]),
                 direction=np.array([0.1, -0.2, 1.0])).rows(W, H)
    depth = rng.uniform(2.0, 9.0, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.1] = -1.0
    old_depth = depth.copy()
    moved = rng.random((H, W)) < 0.3
    old_depth[moved] += rng.uniform(-0.5, 0.5, moved.sum()).astype(np.float32)
    old_depth[rng.random((H, W)) < 0.05] = -1.0
    normal = rng.normal(size=(3, H, W)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=0, keepdims=True)
    return dict(
        sampled_color=rng.random((3, H, W), dtype=np.float32) * 2,
        normal=normal.astype(np.float32),
        depth=depth,
        old_color=rng.random((3, H, W), dtype=np.float32),
        old_blend=rng.uniform(0.02, 1.0, (H, W)).astype(np.float32),
        old_depth=old_depth,
        cam=cam,
    )


@pytest.mark.parametrize("history_valid", [True, False])
@pytest.mark.parametrize(
    "tp",
    [TemporalParams(),
     TemporalParams(sample_blending=0.2, maximum_blending=0.9,
                    blending_distance_cutoff=0.3)],
    ids=["default", "custom"],
)
def test_still_blend_matches_reference(history_valid, tp):
    x = _still_inputs(seed=1)
    cam = x.pop("cam")
    jtp = jparams.TemporalParams(
        **{k: jnp.float32(v) for k, v in vars(tp).items()}
    )
    want_c, want_b = jtemporal.temporal_blend_still_planar(
        *(jnp.asarray(v) for v in x.values()),
        tuple(jnp.asarray(r) for r in cam), tuple(jnp.asarray(r) for r in cam),
        jtp, jnp.asarray(history_valid),
    )
    got_c, got_b = temporal.temporal_blend_still_planar(
        *(torch.from_numpy(v) for v in x.values()), cam, cam, tp,
        history_valid,
    )
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    if history_valid:
        # both branches of the validity test were exercised
        used = (got_c.numpy() != x["sampled_color"]).any(axis=0)
        assert 0 < used.mean() < 1


def test_still_blend_without_history_is_the_sample():
    """Frame 1: with history invalid the blend is the fresh sample, bit
    for bit — what the reference's moving-camera kernel returns there."""
    x = _still_inputs(seed=2)
    cam = x.pop("cam")
    got_c, got_b = temporal.temporal_blend_still_planar(
        *(torch.from_numpy(v) for v in x.values()), cam,
        np.zeros((4, 3), np.float32), TemporalParams(), False,
    )
    np.testing.assert_array_equal(got_c.numpy(), x["sampled_color"])
    np.testing.assert_array_equal(got_b.numpy(), np.full((H, W), 0.5))


@pytest.mark.parametrize("factor", [1.0, 0.0, 0.35])
def test_radius0_modulate_matches_reference(factor):
    rng = np.random.default_rng(4)
    colors = rng.random((3, H, W), dtype=np.float32) * 3
    albedo = rng.random((3, H, W), dtype=np.float32)
    dp = DenoiseParams(albedo_factor=factor)
    zeros = jnp.zeros((3, H, W), jnp.float32)
    want = denoise_pallas.denoise(
        jnp.asarray(colors), zeros, jnp.zeros((H, W), jnp.float32),
        jnp.asarray(albedo), jnp.zeros((H, W), jnp.int32),
        (jnp.zeros(3),) * 4,
        jparams.DenoiseParams(albedo_factor=jnp.float32(factor)), radius=0,
    )
    got = denoise.denoise(
        torch.from_numpy(colors), torch.zeros((3, H, W)),
        torch.zeros((H, W)), torch.from_numpy(albedo),
        torch.zeros((H, W), dtype=torch.int32),
        pack_denoise_params(np.zeros((4, 3), np.float32), dp), radius=0,
    )
    # 1 ulp: XLA's CPU backend contracts factor * albedo + (1 - factor)
    # into an FMA; the port rounds the product first
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.5e-7,
                               atol=0)


def test_tonemap_matches_reference():
    """u8 sRGB encode, cropped planar -> (H, W, 3).  torch and XLA round
    pow differently by an ulp, which may move a value across a .5
    boundary: at most 1 code value, at under 0.1% of samples."""
    rng = np.random.default_rng(6)
    lin = rng.uniform(-0.2, 1.3, (3, H + 3, W + 5)).astype(np.float32)
    lin[0, 0, :8] = [0.0, 0.0031308, 0.003, 1.0, 1.5, -1.0, 0.5, 0.25]
    want = np.asarray(jtonemap.to_u8_planar_cropped(jnp.asarray(lin), H, W))
    got = tonemap.to_u8_planar_cropped(torch.from_numpy(lin), H, W).numpy()
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(
        tonemap.srgb_encode(torch.from_numpy(lin)).numpy(),
        np.asarray(jtonemap.srgb_encode(jnp.asarray(lin))), atol=1e-6,
    )
