"""The port's history resampler and channels-last temporal blend (their
plain torch versions, the references the CUDA kernel is held against) vs
the JAX package: ``reproject_pallas.resample`` in interpret mode, the XLA
``temporal._bilinear`` and ``temporal.temporal_blend``.

Inputs are made from a seed with numpy.  Tolerances: the resample is
1e-6 against both JAX versions (the same float32 operations); the blends
use the tolerances of tests/test_torch_temporal.py, because the JAX side
inverts the old camera basis traced and the port on the host.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.engine import params as jparams
from voxtracer.ops import reproject_pallas
from voxtracer.ops import temporal as jtemporal
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.params import TemporalParams, pack_temporal_params
from voxtracer_torch.ops import reproject, temporal

RH, RW = 96, 384  # the resample fields of tests/test_temporal.py


def _hist(channels, seed=3):
    rng = np.random.default_rng(seed)
    return rng.random((channels, RH, RW), dtype=np.float32)


def _smooth_field():
    """Translation, slight shear and sub-pixel parts
    (tests/test_temporal.py:180-186)."""
    yy, xx = np.mgrid[0:RH, 0:RW].astype(np.float32)
    return xx + 2.3 + 0.01 * yy, yy - 1.7 + 0.005 * xx


def _plain(hist, px_f, py_f):
    s, ok = reproject.resample_plain(
        torch.from_numpy(hist), torch.from_numpy(px_f), torch.from_numpy(py_f)
    )
    return s.numpy(), ok.numpy()


def _bilinear(hist, px_f, py_f):
    out = jtemporal._bilinear(jnp.asarray(np.moveaxis(hist, 0, -1)),
                              jnp.asarray(px_f), jnp.asarray(py_f))
    return np.moveaxis(np.asarray(out), -1, 0)


def _pallas(hist, px_f, py_f):
    s, ok = reproject_pallas.resample(
        jnp.asarray(hist), jnp.asarray(px_f), jnp.asarray(py_f),
        interpret=True,
    )
    return np.asarray(s), np.asarray(ok)


def test_plain_matches_pallas_where_it_serves():
    hist = _hist(5)
    px_f, py_f = _smooth_field()
    got, ok = _plain(hist, px_f, py_f)
    want, want_ok = _pallas(hist, px_f, py_f)
    assert ok.all()
    assert want_ok[4:-4, 4:-4].mean() > 0.999
    np.testing.assert_allclose(got[:, want_ok], want[:, want_ok], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("channels", [1, 3, 5])
def test_plain_matches_xla_bilinear(channels):
    """Everywhere, with coordinates off every edge of the image."""
    rng = np.random.default_rng(channels)
    hist = _hist(channels, seed=channels)
    px_f, py_f = _smooth_field()
    px_f = px_f + rng.uniform(-40.0, 40.0, (RH, RW)).astype(np.float32)
    py_f = py_f * np.float32(1.3) - np.float32(10.0)
    assert (px_f < 0).any() and (px_f > RW).any()
    assert (py_f < 0).any() and (py_f > RH).any()
    got, ok = _plain(hist, px_f, py_f)
    assert got.shape == (channels, RH, RW) and ok.all()
    np.testing.assert_allclose(got, _bilinear(hist, px_f, py_f), rtol=1e-6,
                               atol=1e-6)


def test_large_motion_port_keeps_what_pallas_drops():
    """Offsets past the Pallas serve window (tests/test_temporal.py:202-
    221): the Pallas kernel reports not ok there; the port gathers at any
    offset, reports ok everywhere and equals the XLA bilinear."""
    hist = _hist(5, seed=4)
    yy, xx = np.mgrid[0:RH, 0:RW].astype(np.float32)
    px_f, py_f = xx + 500.0, yy
    got, ok = _plain(hist, px_f, py_f)
    _, pallas_ok = _pallas(hist, px_f, py_f)
    assert not pallas_ok[:, : RW - 160].any()
    assert ok.all()
    dropped = ~pallas_ok
    np.testing.assert_allclose(got[:, dropped],
                               _bilinear(hist, px_f, py_f)[:, dropped],
                               rtol=1e-6, atol=1e-6)


def test_non_finite_coordinates_give_nan():
    hist = _hist(5)
    px_f, py_f = _smooth_field()
    bad = np.zeros((RH, RW), bool)
    px_f[0, :8] = np.nan
    py_f[1, :8] = np.inf
    px_f[2, :8] = -np.inf
    py_f[3, :8] = np.nan
    bad[:4, :8] = True
    got, ok = _plain(hist, px_f, py_f)
    assert ok.all()
    assert np.isnan(got[:, bad]).all()
    assert np.isfinite(got[:, ~bad]).all()


def test_resample_dispatch_and_refusals():
    hist = torch.from_numpy(_hist(2))
    px_f, py_f = (torch.from_numpy(a) for a in _smooth_field())
    got, _ = reproject.resample(hist, px_f, py_f)
    assert torch.equal(got, reproject.resample_plain(hist, px_f, py_f)[0])
    with pytest.raises(ValueError, match="CUDA kernel"):
        reproject.resample_cuda(hist, px_f, py_f)
    with pytest.raises(ValueError, match="px_f"):
        reproject.resample_plain(hist, px_f[:, :8], py_f)


# the channels-last blend: a plane at z = 0 seen from two cameras
H, W = 48, 96
OLD_POS = (0.0, 0.0, -10.0)
# the cutoff scales with the pixel footprint (tests/test_torch_temporal.py)
TP = TemporalParams(blending_distance_cutoff=0.05)
RESTART = np.float32(1.0) - np.float32(TP.sample_blending)


def _rows(pos, direction=(0.0, 0.0, 1.0)):
    return Camera(position=np.array(pos),
                  direction=np.array(direction)).rows(W, H)


def _plane_depth(rows, sky):
    o, r, u, f = rows.astype(np.float64)
    py, px = np.mgrid[0:H, 0:W].astype(np.float64)
    ray = px[..., None] * r - py[..., None] * u + f
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    depth = (0.0 - o[2]) / ray[..., 2]
    return np.where(sky | (depth <= 0), -1.0, depth).astype(np.float32)


def _inputs(cam, old_cam, seed):
    """Channels-last inputs: (H, W, 3) colours and normals."""
    rng = np.random.default_rng(seed)
    depth = _plane_depth(cam, rng.random((H, W)) < 0.05)
    old_depth = _plane_depth(old_cam, rng.random((H, W)) < 0.05)
    occluded = (rng.random((H, W)) < 0.1) & (old_depth >= 0)
    old_depth[occluded] += np.float32(1.0)
    normal = np.zeros((H, W, 3), np.float32)
    normal[..., 2] = -1.0
    return [
        rng.random((H, W, 3), dtype=np.float32),
        normal,
        depth,
        rng.random((H, W, 3), dtype=np.float32),
        rng.uniform(0.02, 0.9, (H, W)).astype(np.float32),
        old_depth,
    ]


def _port(x, cam, old_cam, reproject_, history_valid=True):
    return temporal.temporal_blend(
        *(torch.from_numpy(v) for v in x), cam, old_cam, TP, history_valid,
        reproject=reproject_,
    )


def _jax(x, cam, old_cam, reproject_):
    jp = jparams.TemporalParams(**{k: jnp.float32(v) for k, v in vars(TP).items()})
    c, b = jtemporal.temporal_blend(
        *(jnp.asarray(v) for v in x),
        tuple(jnp.asarray(r) for r in cam), tuple(jnp.asarray(r) for r in old_cam),
        jp, jnp.asarray(True), reproject=reproject_, resample_impl="xla",
    )
    return np.asarray(c), np.asarray(b)


@pytest.mark.parametrize("reproject_", [False, True], ids=["still", "reproject"])
def test_temporal_blend_matches_jax(reproject_):
    """Colour rtol 1e-4 / atol 1e-5 and next blend 1e-5 where both agree
    on validity; measured: 0 validity flips."""
    old_cam = _rows(OLD_POS)
    cam = _rows((0.05, -0.02, -9.9)) if reproject_ else old_cam
    x = _inputs(cam, old_cam, seed=5)
    gc, gb = (t.numpy() for t in _port(x, cam, old_cam, reproject_))
    wc, wb = _jax(x, cam, old_cam, reproject_)
    assert gc.shape == (H, W, 3) and gb.shape == (H, W)
    valid, want_valid = gb < RESTART - 1e-6, wb < RESTART - 1e-6
    assert 0.3 < valid.mean() < 0.95, valid.mean()
    assert int((valid != want_valid).sum()) == 0
    np.testing.assert_allclose(gc, wc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gb, wb, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("history_valid", [True, False])
def test_temporal_blend_is_the_planar_reprojecting_blend(history_valid):
    """The channels-last wrapper computes exactly what the planar plain
    blend does: a layout change, not a second copy of the math."""
    old_cam = _rows(OLD_POS)
    cam = _rows((0.3, 0.2, -10.4))
    x = _inputs(cam, old_cam, seed=6)
    c, b = _port(x, cam, old_cam, True, history_valid)
    planar = [torch.from_numpy(np.ascontiguousarray(np.moveaxis(v, -1, 0)))
              if v.ndim == 3 else torch.from_numpy(v) for v in x]
    pc, pb = temporal.temporal_blend_reproject_plain(
        *planar, pack_temporal_params(cam, old_cam, TP, history_valid))
    assert torch.equal(torch.movedim(c, -1, 0), pc) and torch.equal(b, pb)


def test_temporal_blend_refuses_an_unknown_resampler():
    """The resampler follows the tensors' device; a device with neither
    version is refused, never served by a fallback."""
    cam = _rows(OLD_POS)
    with pytest.raises(ValueError, match="no resample implementation"):
        temporal.temporal_blend(
            *(torch.from_numpy(v).to("meta") for v in _inputs(cam, cam, 7)),
            cam, cam, TP, True, reproject=True)
