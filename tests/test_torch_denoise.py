"""The port's cross-bilateral denoiser (its plain torch version, the
reference the CUDA kernel is held against) vs the JAX package: the XLA
stencil ``denoise.denoise`` and the Pallas kernel in interpret mode.

Inputs are made from a seed with numpy at 64x128, as in
tests/test_denoise_pallas.py.  Tolerance: atol 2e-5, the JAX suite's own
bar between its two implementations (exp/log and the modulation's
operation order round differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.engine import params as jparams
from voxtracer.ops import denoise as jdenoise
from voxtracer.ops import denoise_pallas
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.params import DenoiseParams, pack_denoise_params
from voxtracer_torch.ops import denoise

H, W = 64, 128
CAM = Camera().rows(W, H)


def _inputs(seed=0, misses=False):
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    depth = (rng.random((H, W), np.float32) * 10 + 1).astype(np.float32)
    node = (rng.integers(0, 3, (H, W)) << 24).astype(np.int32)
    if misses:
        # sky pixels as the trace writes them: depth -1, normal 2^30,
        # the miss node; and leaf / emissive nodes, whose top bit makes
        # the id negative
        sky = rng.random((H, W)) < 0.2
        depth[sky] = -1.0
        n[:, sky] = np.float32(1 << 30)
        node[sky] = 0xFFFFFF
        leaf = ~sky & (rng.random((H, W)) < 0.2)
        node[leaf] = np.int32(-(1 << 31)) | node[leaf]
    return dict(
        colors=rng.random((3, H, W), np.float32),
        normal=n,
        depth=depth,
        albedo=rng.random((3, H, W), np.float32),
        node=node,
    )


def _plain(x, radius, dp=DenoiseParams()):
    return denoise.denoise_plain(
        *(torch.from_numpy(v) for v in x.values()),
        pack_denoise_params(CAM, dp), radius,
    ).numpy()


def _jcam():
    return tuple(jnp.asarray(r) for r in CAM)


def _jparams(dp):
    return jparams.DenoiseParams(
        **{k: jnp.float32(v) for k, v in vars(dp).items()}
    )


def _xla(x, radius, dp=DenoiseParams()):
    def hwc(a):
        return jnp.asarray(np.moveaxis(a, 0, -1))

    out = jdenoise.denoise(
        hwc(x["colors"]), hwc(x["normal"]), jnp.asarray(x["depth"]),
        hwc(x["albedo"]), jnp.asarray(x["node"]), _jcam(), _jparams(dp),
        radius,
    )
    return np.moveaxis(np.asarray(out), -1, 0)


@pytest.mark.parametrize("radius", [1, 2, 3, 4, 8])
def test_plain_matches_xla_stencil(radius):
    x = _inputs()
    np.testing.assert_allclose(_plain(x, radius), _xla(x, radius), atol=2e-5)


@pytest.mark.parametrize("radius", [2, 3], ids=["unrolled", "rolled"])
def test_plain_matches_pallas_interpret(radius):
    """r = 2 runs the kernel's unrolled taps, r = 3 its rolled rows."""
    x = _inputs(seed=1)
    want = denoise_pallas.denoise(
        *(jnp.asarray(x[k]) for k in ("colors", "normal", "depth", "albedo",
                                      "node")),
        _jcam(), _jparams(DenoiseParams()), radius=radius, interpret=True,
    )
    np.testing.assert_allclose(_plain(x, radius), np.asarray(want),
                               atol=2e-5)


@pytest.mark.parametrize("radius", [1, 2])
def test_misses_and_negative_node_ids(radius):
    """Sky pixels (depth -1, normal 2^30) and nodes with the top bit set
    (node >> 24 is negative) against the XLA stencil, with other sigmas
    and a partial albedo factor."""
    x = _inputs(seed=2, misses=True)
    dp = DenoiseParams(sigma_distance=1.2, sigma_range=0.7, albedo_factor=0.35)
    assert (x["node"] >> 24).min() < 0
    out = _plain(x, radius, dp)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, _xla(x, radius, dp), atol=2e-5)


def test_radius_zero_is_the_modulate():
    """The dispatcher at radius 0 runs no stencil (any device)."""
    x = _inputs(seed=3)
    params = pack_denoise_params(CAM, DenoiseParams(albedo_factor=0.5))
    got = denoise.denoise(*(torch.from_numpy(v) for v in x.values()),
                          params, 0).numpy()
    np.testing.assert_array_equal(
        got, x["colors"] * (np.float32(0.5) + np.float32(0.5) * x["albedo"])
    )
    with pytest.raises(ValueError, match="radius"):
        denoise.denoise_plain(*(torch.from_numpy(v) for v in x.values()),
                              params, 0)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: CPU tensors are an error."""
    x = _inputs()
    with pytest.raises(ValueError, match="CUDA kernel"):
        denoise.denoise_cuda(*(torch.from_numpy(v) for v in x.values()),
                             pack_denoise_params(CAM, DenoiseParams()), 2)
