"""The frame epilogue of the port (``voxtracer_torch.ops.epilogue``) on
the CPU: the plain still epilogue and encode against the JAX package's
still blend, radius-0 modulate and u8 encode, by value and by row; the
renderer's frames against the same frames with the stages forced to the
composition the port ran before the epilogue kernel; the CUDA wrappers'
refusals and the kernel source's parameter layout.

Tolerances: blend within 1e-6 and next blend bit-exact
(``tests/test_torch_stages.py``); modulated linear within 2.5e-7
relative (XLA's CPU backend contracts ``f * albedo + (1 - f)`` into an
FMA, the port rounds the product first); u8 equal (where the linear
value is no NaN: the u8 of a NaN is each backend's conversion).  The
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``, chip_smoke phase 19).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.engine import params as jparams
from voxtracer.ops import denoise_pallas
from voxtracer.ops import temporal as jtemporal
from voxtracer.ops import tonemap as jtonemap
from voxtracer_torch.app.renderbench import eager_render
from voxtracer_torch.engine import params as P
from voxtracer_torch.engine import pipeline, reload
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.pipeline import STATE_PLANES, Renderer
from voxtracer_torch.ops import _build, denoise, epilogue, temporal, tonemap
from voxtracer_torch.scene import GridScene, VoxelList

H, W = 24, 40
CAM = Camera(position=np.array([1.0, 2.0, -6.0]),
             direction=np.array([0.1, -0.2, 1.0]))


def _planes(seed, specials=False):
    """A plausible still frame (depths along the camera's rays, a history
    that is the same surface for most pixels, some sky), or with
    ``specials`` NaN, +-inf, negative and > 1 values in every plane."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(2.0, 9.0, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.1] = -1.0
    old_depth = depth.copy()
    moved = rng.random((H, W)) < 0.3
    old_depth[moved] += rng.uniform(-0.5, 0.5, moved.sum()).astype(np.float32)
    normal = rng.normal(size=(3, H, W)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=0, keepdims=True)
    x = dict(
        sampled_color=rng.uniform(-0.3, 2.0, (3, H, W)).astype(np.float32),
        normal=normal.astype(np.float32),
        depth=depth,
        old_color=rng.random((3, H, W), dtype=np.float32),
        old_blend=rng.uniform(0.02, 1.0, (H, W)).astype(np.float32),
        old_depth=old_depth,
    )
    albedo = rng.uniform(0.0, 1.2, (3, H, W)).astype(np.float32)
    if specials:
        for a in (*x.values(), albedo):
            flat = a.reshape(-1)
            for v in (np.nan, np.inf, -np.inf, -2.5, 4.0):
                flat[rng.integers(0, flat.size, 6)] = v
    return x, albedo


def _row(history_valid, factor, tp=P.TemporalParams()):
    rows = CAM.rows(W, H)
    return P.pack_frame_rows([rows], rows, history_valid, 3,
                             P.RenderParams(), tp,
                             P.DenoiseParams(albedo_factor=factor))[0]


def _jax_tail(x, albedo, history_valid, factor, tp=P.TemporalParams()):
    """The JAX package's still blend, radius-0 modulate and u8 encode."""
    cam = tuple(jnp.asarray(r) for r in CAM.rows(W, H))
    jtp = jparams.TemporalParams(
        **{k: jnp.float32(v) for k, v in vars(tp).items()})
    blended, next_blend = jtemporal.temporal_blend_still_planar(
        *(jnp.asarray(v) for v in x.values()), cam, cam, jtp,
        jnp.asarray(history_valid))
    out = denoise_pallas.denoise(
        blended, jnp.zeros((3, H, W)), jnp.zeros((H, W)), jnp.asarray(albedo),
        jnp.zeros((H, W), jnp.int32), (jnp.zeros(3),) * 4,
        jparams.DenoiseParams(albedo_factor=jnp.float32(factor)), radius=0)
    image = jtonemap.to_u8_planar_cropped(out, H, W)
    return [np.asarray(a) for a in (blended, next_blend, out, image)]


def _torch(x, albedo):
    return ([torch.from_numpy(v) for v in x.values()],
            torch.from_numpy(albedo))


def _by(row, how):
    """The host row, or the row as a tensor the plain stages read."""
    return row if how == "value" else P.DeviceRow(torch.from_numpy(row), row)


def _same(a, b):
    """Equal bit for bit (float32 NaNs included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _assert_u8_equal(got, want, finite):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[finite], want[finite])


@pytest.mark.parametrize("how", ["value", "row"])
@pytest.mark.parametrize("factor", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("history_valid", [True, False])
def test_still_epilogue_matches_reference(history_valid, factor, how):
    x, albedo = _planes(seed=1)
    want = _jax_tail(x, albedo, history_valid, factor)
    planes, alb = _torch(x, albedo)
    row = _by(_row(history_valid, factor), how)
    blended, next_blend, out, image = epilogue.still_epilogue_plain(
        *planes, alb, row, keep_linear=True)
    np.testing.assert_allclose(blended.numpy(), want[0], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(next_blend.numpy(), want[1])
    np.testing.assert_allclose(out.numpy(), want[2], rtol=2.5e-7, atol=1e-7)
    assert image.shape == (H, W, 3) and image.dtype == torch.uint8
    _assert_u8_equal(image.numpy(), want[3], np.ones((H, W, 3), bool))
    if history_valid:  # both branches of the validity test ran
        used = (blended.numpy() != x["sampled_color"]).any(axis=0)
        assert 0 < used.mean() < 1


@pytest.mark.parametrize("how", ["value", "row"])
def test_still_epilogue_on_nan_and_out_of_range_planes(how):
    """NaN, +-inf, negative and > 1 planes: the blend keeps NaN where the
    reference does, and the u8 image agrees wherever its linear value is
    no NaN (u8 of NaN is left to each backend's conversion)."""
    tp = P.TemporalParams(sample_blending=0.3, maximum_blending=0.9,
                          blending_distance_cutoff=0.2)
    x, albedo = _planes(seed=5, specials=True)
    want = _jax_tail(x, albedo, True, 0.5, tp)
    planes, alb = _torch(x, albedo)
    blended, next_blend, out, image = epilogue.still_epilogue_plain(
        *planes, alb, _by(_row(True, 0.5, tp), how), keep_linear=True)
    assert np.isnan(want[2]).any() and np.isinf(want[2]).any()
    np.testing.assert_allclose(blended.numpy(), want[0], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(next_blend.numpy(), want[1])
    np.testing.assert_allclose(out.numpy(), want[2], rtol=2.5e-7, atol=1e-7)
    finite = ~np.isnan(np.moveaxis(want[2], 0, -1))
    _assert_u8_equal(image.numpy(), want[3], finite)


@pytest.mark.parametrize("how", ["value", "row"])
def test_still_epilogue_is_the_composition_it_replaces(how):
    """Bit for bit the still blend, ``denoise(radius=0)`` and
    ``to_u8_planar_cropped`` that the frame ran before; without an
    albedo plane the blend alone."""
    x, albedo = _planes(seed=2, specials=True)
    planes, alb = _torch(x, albedo)
    host = _row(True, 0.35)
    blended, next_blend = temporal.temporal_blend_still_row(*planes, host)
    out = denoise.denoise(blended, planes[1], planes[2], alb,
                          torch.zeros((H, W), dtype=torch.int32),
                          host[P.ROW_DENOISE:P.ROW_DENOISE + 16], 0)
    image = tonemap.to_u8_planar_cropped(out, H, W)
    got = epilogue.still_epilogue_plain(*planes, alb, _by(host, how), True)
    for a, b in zip(got, (blended, next_blend, out, image)):
        assert _same(a, b)
    assert epilogue.still_epilogue_plain(*planes, alb, host)[2] is None
    alone = epilogue.still_epilogue_plain(*planes, None, host)
    assert alone[2:] == (None, None)
    assert _same(alone[0], blended) and _same(alone[1], next_blend)


@pytest.mark.parametrize("how", ["value", "row"])
@pytest.mark.parametrize("albedo", [True, False], ids=["r0", "blend_alone"])
@pytest.mark.parametrize("specials", [False, True], ids=["random", "nan_inf"])
@pytest.mark.parametrize("history_valid", [True, False])
def test_still_epilogue_in_place_equals_out_of_place(history_valid, specials,
                                                     albedo, how):
    """``in_place=True`` overwrites the history it reads (blend over the
    old colour, next blend over the old blend, depth over the old depth)
    with the values the out-of-place call returns, bit for bit, and
    returns the history's tensors."""
    x, alb = _planes(seed=6, specials=specials)
    planes, alb = _torch(x, alb)
    alb = alb if albedo else None
    row = _by(_row(history_valid, 0.5), how)
    want = epilogue.still_epilogue_plain(*planes, alb, row, keep_linear=True)
    history = [t.clone() for t in planes[3:]]
    got = epilogue.still_epilogue_plain(*planes[:3], *history, alb, row,
                                        keep_linear=True, in_place=True)
    assert got[0] is history[0] and got[1] is history[1]
    assert _same(history[0], want[0]) and _same(history[1], want[1])
    assert _same(history[2], planes[2])
    for a, b in zip(got[2:], want[2:]):
        assert (a is None and b is None) or _same(a, b)
    if history_valid and not specials:  # both branches of the test ran
        used = (want[0] != planes[0]).any(0).float().mean()
        assert 0 < used < 1


@pytest.mark.parametrize("history_valid", [True, False])
def test_still_kept_marks_the_pixels_that_read_their_history(history_valid):
    """``renderbench.still_kept`` (what the timed bound counts a pixel's
    history reads by) is true exactly where the still blend's output
    changes with the old colour, and ``still_bytes`` counts 47 B a pixel
    that misses or has no history, 63 a hit that drops it and 79 one
    that keeps it (r = 0; 12 more with the linear, 15 fewer without the
    albedo)."""
    from voxtracer_torch.app.renderbench import still_bytes, still_kept

    x, _ = _planes(seed=8)
    planes, _ = _torch(x, x["sampled_color"])
    row = _row(history_valid, 0.5)
    kept = still_kept(planes, row)
    blended = epilogue.still_epilogue_plain(*planes, None, row)[0]
    moved = list(planes)
    moved[3] = planes[3] + 0.25
    changed = (epilogue.still_epilogue_plain(*moved, None, row)[0]
               != blended).any(0)
    assert torch.equal(kept, changed)
    hit = planes[2] >= 0
    n, n_hit, n_kept = hit.numel(), int(hit.sum()), int(kept.sum())
    if history_valid:
        assert 0 < n_kept < n_hit
        want = 47 * n + 16 * n_hit + 16 * n_kept
    else:
        assert n_kept == 0
        want = 47 * n
    assert still_bytes(planes[2], kept, history_valid) == want
    assert still_bytes(planes[2], kept, history_valid, linear=True) == (
        want + 12 * n)
    assert still_bytes(planes[2], kept, history_valid, albedo=False) == (
        want - 15 * n)


@pytest.mark.parametrize("how", ["value", "row"])
@pytest.mark.parametrize("factor", [0.0, 0.5])
def test_encode_matches_reference(factor, how):
    """The encode of a (3, H + 3, W + 5) plane cropped to (H, W), with
    the radius-0 modulate, against the JAX package's."""
    rng = np.random.default_rng(7)
    lin = rng.uniform(-0.2, 1.3, (3, H + 3, W + 5)).astype(np.float32)
    lin[0, 0, :8] = [0.0, 0.0031308, 0.003, 1.0, 1.5, -1.0, 0.5, 0.25]
    albedo = rng.uniform(0.0, 1.0, lin.shape).astype(np.float32)
    row = P.pack_frame_rows([CAM.rows(W, H)], CAM.rows(W, H), True, 1,
                            P.RenderParams(), P.TemporalParams(),
                            P.DenoiseParams(albedo_factor=factor))[0]
    zeros = jnp.zeros(lin.shape[1:])
    out = denoise_pallas.denoise(
        jnp.asarray(lin), jnp.zeros(lin.shape), zeros, jnp.asarray(albedo),
        zeros.astype(jnp.int32), (jnp.zeros(3),) * 4,
        jparams.DenoiseParams(albedo_factor=jnp.float32(factor)), radius=0)
    want = np.asarray(jtonemap.to_u8_planar_cropped(out, H, W))
    image, got = epilogue.encode_plain(
        torch.from_numpy(lin), H, W, torch.from_numpy(albedo), _by(row, how),
        keep_linear=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=2.5e-7,
                               atol=1e-7)
    assert image.shape == (H, W, 3)
    _assert_u8_equal(image.numpy(), want, np.ones((H, W, 3), bool))
    # without the albedo: the tonemap alone, and the input comes back
    plain_img, same = epilogue.encode_plain(torch.from_numpy(lin), H, W)
    assert same.data_ptr() == lin.ctypes.data or torch.equal(
        same, torch.from_numpy(lin))
    assert torch.equal(plain_img,
                       tonemap.to_u8_planar_cropped(torch.from_numpy(lin),
                                                    H, W))


def test_encode_writes_the_slot_of_its_destination():
    """With ``dest = (frames, slot)`` the image lands in frames[slot]
    (a device slot, as the sequence path's graphs advance it)."""
    x, albedo = _planes(seed=3)
    planes, alb = _torch(x, albedo)
    row = _row(True, 1.0)
    frames = torch.zeros((3, H, W, 3), dtype=torch.uint8)
    want = epilogue.still_epilogue_plain(*planes, alb, row)[3]
    got = epilogue.still_epilogue_plain(
        *planes, alb, row, dest=(frames, torch.tensor([2])))
    assert got[3] is None and torch.equal(frames[2], want)
    assert not frames[:2].any()
    image, _ = epilogue.encode_plain(planes[0], H, W, alb, row,
                                     dest=(frames, torch.tensor([0])))
    assert image is None
    assert torch.equal(frames[0],
                       epilogue.encode_plain(planes[0], H, W, alb, row)[0])


def test_dispatchers_take_the_plain_versions_on_the_cpu():
    x, albedo = _planes(seed=4)
    planes, alb = _torch(x, albedo)
    row = _row(True, 0.5)
    for a, b in zip(epilogue.still_epilogue(*planes, alb, row, True),
                    epilogue.still_epilogue_plain(*planes, alb, row, True)):
        assert torch.equal(a, b)
    for a, b in zip(epilogue.encode(planes[0], H, W, alb, row),
                    epilogue.encode_plain(planes[0], H, W, alb, row)):
        assert (a is None and b is None) or torch.equal(a, b)
    meta = [t.to("meta") for t in planes]
    with pytest.raises(ValueError, match="no still epilogue"):
        epilogue.still_epilogue(*meta, alb.to("meta"), row)
    with pytest.raises(ValueError, match="no encode"):
        epilogue.encode(meta[0], H, W)


def test_cuda_wrappers_refuse_cpu_tensors():
    x, albedo = _planes(seed=4)
    planes, alb = _torch(x, albedo)
    row = _row(True, 0.5)
    before = (epilogue.still_epilogue_cuda.launches,
              epilogue.encode_cuda.launches)
    with pytest.raises(ValueError, match="CUDA kernel given tensors on cpu"):
        epilogue.still_epilogue_cuda(*planes, alb, row)
    with pytest.raises(ValueError, match="CUDA kernel given tensors on cpu"):
        epilogue.still_epilogue_cuda(*planes, None, row)
    with pytest.raises(ValueError, match="CUDA kernel given tensors on cpu"):
        epilogue.encode_cuda(planes[0], H, W, alb, row)
    with pytest.raises(ValueError, match="CUDA kernel given tensors on cpu"):
        epilogue.encode_cuda(planes[0], H, W)
    assert (epilogue.still_epilogue_cuda.launches,
            epilogue.encode_cuda.launches) == before


def test_cuda_wrappers_check_their_inputs():
    """Shapes, types and crops are refused before any device is asked."""
    x, albedo = _planes(seed=4)
    planes, alb = _torch(x, albedo)
    row = _row(True, 0.5)
    with pytest.raises(ValueError, match="albedo must be"):
        epilogue.still_epilogue_cuda(*planes, alb[:, :-1], row)
    with pytest.raises(ValueError, match="old_blend must be"):
        epilogue.still_epilogue_cuda(*planes[:4], planes[4].double(),
                                     planes[5], alb, row)
    with pytest.raises(ValueError, match="linear must be"):
        epilogue.encode_cuda(planes[0][:2], H, W)
    with pytest.raises(ValueError, match="crop"):
        epilogue.encode_cuda(planes[0], H + 1, W)
    with pytest.raises(ValueError, match="albedo must be"):
        epilogue.encode_cuda(planes[0], H, W, alb[:, 1:], row)


def test_kernel_params_are_the_rows_slice():
    """csrc/epilogue.cu reads row[33:92] with the offsets the row layout
    gives (engine/params.py)."""
    with open(os.path.join(_build.CSRC_DIR, "epilogue.cu")) as f:
        src = f.read()
    const = {k: v for k, v in re.findall(r"constexpr int (\w+) = ([\w +]+);",
                                        src)}
    value = {k: eval(v) for k, v in const.items()}  # small sums of ints
    assert epilogue.ROW_EPILOGUE == P.ROW_TEMPORAL
    assert value["N_PARAMS"] == epilogue.EPILOGUE_PARAMS_LEN == 59
    assert P.ROW_TEMPORAL + value["N_PARAMS"] <= P.ROW_LEN
    base = epilogue.ROW_EPILOGUE
    assert value["P_ALBEDO_FACTOR"] == P.ROW_DENOISE + 14 - base
    assert value["P_KEEP_SAMPLE"] == P.ROW_KEEP_SAMPLE - base
    assert value["P_KEEP_FLOOR"] == P.ROW_KEEP_FLOOR - base
    assert value["P_KEEP_ALBEDO"] == P.ROW_KEEP_ALBEDO - base
    assert (value["P_CUTOFF"], value["P_HISTORY_VALID"],
            value["P_OLD_CAM"]) == (35, 36, 12)
    for name in ("vt_still_epilogue_launch", "vt_encode_launch"):
        assert f'extern "C" int {name}(' in src


def test_pipeline_counts_and_reloads_the_epilogue(monkeypatch):
    """Replays count the epilogue kernels; hot-reload watches their
    module, and the renderer reads their stages from it at each frame."""
    kernels = pipeline.counted_kernels().values()
    assert epilogue.still_epilogue_cuda in kernels
    assert epilogue.encode_cuda in kernels
    assert "voxtracer_torch.ops.epilogue" in reload.WATCHED_MODULES
    r = Renderer(scene=_scene(), height=8, width=8, device="cpu")
    assert r._stages()[3:] == (epilogue.still_epilogue, epilogue.encode)
    reloaded = lambda *a: epilogue.encode_plain(*a)  # noqa: E731
    monkeypatch.setattr(epilogue, "encode", reloaded)
    assert r._stages()[4] is reloaded


# the composition each frame ran before the epilogue kernel: the still
# blend reading the row, denoise(radius=0) for the modulate, and
# to_u8_planar_cropped


def _today_encode(linear, height, width, albedo=None, row=None,
                  keep_linear=False, dest=None):
    assert dest is None
    out = linear
    if albedo is not None:
        out = denoise.denoise(linear, None, None, albedo, None,
                              row[P.ROW_DENOISE:P.ROW_DENOISE + 16], 0)
    return tonemap.to_u8_planar_cropped(out, height, width), out


def _today_still(color, normal, depth, old_color, old_blend, old_depth,
                 albedo, row, keep_linear=False, dest=None, in_place=False):
    assert not in_place  # only the card's sequence path blends in place
    blended, next_blend = temporal.temporal_blend_still_row(
        color, normal, depth, old_color, old_blend, old_depth, row)
    if albedo is None:
        return blended, next_blend, None, None
    image, out = _today_encode(blended, *depth.shape, albedo, row)
    return blended, next_blend, out, image


def _scene():
    return GridScene.from_voxels(VoxelList(
        pos=np.array([[0, 0, 0], [1, 1, 1], [2, 0, 1]], dtype=np.int16),
        mrgb=np.array([[0, 200, 0, 0], [0, 0, 200, 0], [0, 90, 90, 250]],
                      dtype=np.uint8),
    ))


def _cameras(path):
    still = Camera(position=np.array([1.0, 1.5, -3.5]),
                   direction=np.array([0.1, -0.2, 1.0]))
    if path == "still":
        return [still] * 4
    return [Camera(position=still.position + np.array([0.15 * i, 0, 0.1 * i]),
                   direction=still.direction) for i in range(4)]


@pytest.mark.parametrize("lean", [True, False])
@pytest.mark.parametrize("radius", [0, 2])
@pytest.mark.parametrize("path", ["still", "moving"])
def test_cpu_frames_equal_the_composition_before(path, radius, lean):
    """``Renderer(device="cpu")`` frames, state and outputs bit-equal to
    the same frames through ``render_frame`` with the still epilogue and
    encode stages given as the composition the port ran before."""
    kw = dict(scene=_scene(), height=20, width=28, device="cpu",
              denoise_radius=radius, lean=lean)
    now, before = Renderer(**kw), Renderer(**kw)
    for cam in _cameras(path):
        got, want = now.render(cam), _before(before, [cam])[0]
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        for k in STATE_PLANES:
            assert torch.equal(now.state[k], before.state[k]), k
    assert (got["image"].numpy() > 0).any()


def _before(r, cams):
    """Renderer ``r``'s next frames at ``cams`` through ``render_frame``
    with the composition before the epilogue kernel: their outputs."""
    return [eager_render(r, cam, still_epilogue=_today_still,
                         encode=_today_encode) for cam in cams]


@pytest.mark.parametrize("radius", [0, 2])
def test_cpu_sequence_equals_the_composition_before(radius):
    """A CPU sequence and burst equal as many frames of the composition
    before the epilogue kernel."""
    kw = dict(scene=_scene(), height=20, width=28, device="cpu",
              denoise_radius=radius)
    now, before = Renderer(**kw), Renderer(**kw)
    cams = _cameras("still")[:2] + _cameras("moving")[1:]
    assert torch.equal(now.render_sequence(cams), torch.stack(
        [out["image"] for out in _before(before, cams)]))
    assert torch.equal(now.render_burst(cams[-1], 3),
                       _before(before, [cams[-1]] * 3)[-1]["image"])
