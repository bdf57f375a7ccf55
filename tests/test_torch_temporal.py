"""The port's reprojecting temporal blend (its plain torch version, the
reference the CUDA kernel is held against) vs the JAX package: the
any-offset XLA path ``temporal.temporal_blend(reproject=True,
resample_impl="xla")`` and the fused Pallas kernel in interpret mode.

Inputs are made from a seed with numpy: a plane at z = 0 seen from two
cameras, so the history is geometrically consistent, with occluders
(history depth moved by 1.0) and sky pixels in both frames.  A pixel's
history is valid where its next blend factor is below the restart
value 1 - sample_blending.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.engine import params as jparams
from voxtracer.ops import temporal as jtemporal
from voxtracer.ops import temporal_pallas
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.params import TemporalParams, pack_temporal_params
from voxtracer_torch.ops import temporal

H, W = 64, 128
OLD_POS = (0.0, 0.0, -10.0)
# the cutoff scales with the pixel footprint: at 64 rows a pixel is
# ~0.22 world units wide at depth 10, so the default 1e-2 would reject
# reprojections on lattice quantisation alone (as tests/test_temporal_
# pallas.py notes); 0.05 keeps that out of the comparison
TP = TemporalParams(blending_distance_cutoff=0.05)
RESTART = np.float32(1.0) - np.float32(TP.sample_blending)

SMOOTH = [(0.0, 0.0, 0.0), (0.05, -0.02, 0.1), (0.3, 0.2, -0.4)]
# tilting up by 32 degrees moves every pixel ~28 rows in the old
# image, beyond the fused kernel's serve window (MARGIN = 24 rows)
WHIP_DIR = (0.0, float(np.tan(np.radians(32.0))), 1.0)


def _rows(pos, direction=(0.0, 0.0, 1.0)):
    return Camera(position=np.array(pos),
                  direction=np.array(direction)).rows(W, H)


def _plane_depth(rows, sky):
    """Distance along each pixel's ray to the plane z = 0 (-1 on sky)."""
    o, r, u, f = rows.astype(np.float64)
    py, px = np.mgrid[0:H, 0:W].astype(np.float64)
    ray = px[..., None] * r - py[..., None] * u + f
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    depth = (0.0 - o[2]) / ray[..., 2]
    return np.where(sky | (depth <= 0), -1.0, depth).astype(np.float32)


def _inputs(cam, old_cam, seed=0):
    rng = np.random.default_rng(seed)
    depth = _plane_depth(cam, rng.random((H, W)) < 0.05)
    old_depth = _plane_depth(old_cam, rng.random((H, W)) < 0.05)
    occluded = (rng.random((H, W)) < 0.1) & (old_depth >= 0)
    old_depth[occluded] += np.float32(1.0)
    normal = np.zeros((3, H, W), np.float32)
    normal[2] = -1.0
    return dict(
        sampled_color=rng.random((3, H, W), dtype=np.float32),
        normal=normal,
        depth=depth,
        old_color=rng.random((3, H, W), dtype=np.float32),
        old_blend=rng.uniform(0.02, 0.9, (H, W)).astype(np.float32),
        old_depth=old_depth,
    )


def _plain(x, cam, old_cam, history_valid=True):
    c, b = temporal.temporal_blend_reproject_plain(
        *(torch.from_numpy(v) for v in x.values()),
        pack_temporal_params(cam, old_cam, TP, history_valid),
    )
    return c.numpy(), b.numpy()


def _jtuple(rows):
    return tuple(jnp.asarray(r) for r in rows)


def _jparams():
    return jparams.TemporalParams(
        **{k: jnp.float32(v) for k, v in vars(TP).items()}
    )


def _xla(x, cam, old_cam):
    c, b = jtemporal.temporal_blend(
        jnp.asarray(np.moveaxis(x["sampled_color"], 0, -1)),
        jnp.asarray(np.moveaxis(x["normal"], 0, -1)),
        jnp.asarray(x["depth"]),
        jnp.asarray(np.moveaxis(x["old_color"], 0, -1)),
        jnp.asarray(x["old_blend"]), jnp.asarray(x["old_depth"]),
        _jtuple(cam), _jtuple(old_cam), _jparams(), jnp.asarray(True),
        reproject=True, resample_impl="xla",
    )
    return np.moveaxis(np.asarray(c), -1, 0), np.asarray(b)


def _fused(x, cam, old_cam):
    hist = np.concatenate(
        [x["old_color"], x["old_blend"][None], x["old_depth"][None]]
    )
    c, b = temporal_pallas.temporal_blend_fused(
        jnp.asarray(x["sampled_color"]), jnp.asarray(x["normal"]),
        jnp.asarray(x["depth"]), jnp.asarray(hist), _jtuple(cam),
        _jtuple(old_cam), _jparams(), jnp.asarray(True), interpret=True,
    )
    return np.asarray(c), np.asarray(b)


def _valid(nb):
    return nb < RESTART - 1e-6


def _assert_close(got, want, max_flips):
    """Colour rtol 1e-4 / atol 1e-5 and next blend 1e-5 where both agree
    on validity; validity flips at most ``max_flips`` (each one ulp of
    the reprojected coordinate across a pixel or validity boundary)."""
    (gc, gb), (wc, wb) = got, want
    agree = _valid(gb) == _valid(wb)
    flips = int((~agree).sum())
    assert flips <= max_flips, f"{flips} validity flips (pinned <={max_flips})"
    np.testing.assert_allclose(gc[:, agree], wc[:, agree], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gb[agree], wb[agree], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "d_pos, direction",
    [(p, (0.0, 0.0, 1.0)) for p in SMOOTH] + [((0.0, 0.0, 0.0), WHIP_DIR)],
    ids=["still", "small", "large", "whip_pan"],
)
def test_plain_matches_xla_any_offset(d_pos, direction):
    """Measured: 0 validity flips in all four motions."""
    old_cam = _rows(OLD_POS)
    cam = _rows(np.add(OLD_POS, d_pos), direction)
    x = _inputs(cam, old_cam)
    got = _plain(x, cam, old_cam)
    valid = _valid(got[1])
    # both branches of the validity test are exercised
    assert 0.3 < valid.mean() < 0.95, valid.mean()
    _assert_close(got, _xla(x, cam, old_cam), max_flips=0)


@pytest.mark.parametrize("d_pos", SMOOTH, ids=["still", "small", "large"])
def test_plain_matches_fused_pallas_where_it_serves(d_pos):
    """Smooth motion stays inside the fused kernel's serve window, where
    its semantics are the any-offset path's.  Measured: 0 flips."""
    old_cam = _rows(OLD_POS)
    cam = _rows(np.add(OLD_POS, d_pos))
    x = _inputs(cam, old_cam, seed=1)
    _assert_close(_plain(x, cam, old_cam), _fused(x, cam, old_cam),
                  max_flips=0)


def test_whip_pan_keeps_history_the_fused_kernel_drops():
    """Past MARGIN rows the fused kernel cannot serve a tap and restarts
    accumulation; the port gathers at any offset and keeps the history,
    as the reference's any-offset fallback does."""
    old_cam = _rows(OLD_POS)
    cam = _rows(OLD_POS, WHIP_DIR)
    x = _inputs(cam, old_cam, seed=2)
    _, plain_nb = _plain(x, cam, old_cam)
    fused_c, fused_nb = _fused(x, cam, old_cam)
    assert _valid(plain_nb).mean() > 0.3
    assert not _valid(fused_nb).any()
    np.testing.assert_array_equal(fused_c, x["sampled_color"])


def test_history_invalid_passes_the_sample_through():
    """With history invalid the blend is the fresh sample, bit for bit,
    and every pixel restarts."""
    old_cam = _rows(OLD_POS)
    cam = _rows(np.add(OLD_POS, SMOOTH[1]))
    x = _inputs(cam, old_cam, seed=3)
    c, b = _plain(x, cam, old_cam, history_valid=False)
    np.testing.assert_array_equal(c, x["sampled_color"])
    np.testing.assert_array_equal(b, np.full((H, W), RESTART))


def test_non_finite_reprojection_is_never_valid():
    """Points beside or behind the old camera give s2 = 0 and inf/NaN
    screen coordinates; their taps clamp to the image and the pixels
    restart."""
    old_cam = _rows(OLD_POS)
    cam = _rows(OLD_POS)
    x = _inputs(cam, old_cam, seed=4)
    x["depth"][:4] = np.float32(np.inf)  # world points at infinity
    x["depth"][4:8, :8] = np.float32(0.0)  # the old camera's origin
    c, b = _plain(x, cam, old_cam)
    bad = np.zeros((H, W), bool)
    bad[:4] = True
    bad[4:8, :8] = True
    assert not _valid(b[bad]).any()
    np.testing.assert_array_equal(c[:, bad], x["sampled_color"][:, bad])
    assert _valid(b[~bad]).mean() > 0.5


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: CPU tensors are an error."""
    old_cam = _rows(OLD_POS)
    x = _inputs(old_cam, old_cam)
    with pytest.raises(ValueError, match="CUDA kernel"):
        temporal.temporal_blend_reproject_cuda(
            *(torch.from_numpy(v) for v in x.values()),
            pack_temporal_params(old_cam, old_cam, TP, True),
        )
