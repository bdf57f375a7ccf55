"""The port's row-slab mesh (``voxtracer_torch.parallel``) on the CPU:
slab frames on ``["cpu"] * n`` bit-equal to the one-device frame
(``engine.pipeline.render_frame``), both layouts, uneven slabs and a
halo taller than a slab; the cyclic resort against numpy; each plain
stage with a slab offset against the JAX package's function with its
``row0``; and the slab frame against the JAX package's own mesh frame.
The JAX package is imported only inside the tests that compare with it,
so the card tests (``cuda`` marker, skipped here) collect without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel.py

Bars: the port against itself bit for bit (every stage computes a pixel
from the same inputs in the same operations); against the JAX package
the bars of ``tests/test_torch_pipeline.py`` (a frame: node ids exact,
depth and colour 1e-5, u8 at most 1 code value at 3 pixels) and of
``tests/test_torch_temporal.py`` (a blend: colour rtol 1e-4 / atol 1e-5,
next blend 1e-5, no validity flip).
"""

import functools

import numpy as np
import pytest
import torch

from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.params import (
    DENOISE_PARAMS_LEN,
    ROW_DENOISE,
    DenoiseParams,
    RenderParams,
    TemporalParams,
    pack_frame_rows,
    pack_temporal_params,
    pack_trace_params,
)
from voxtracer_torch.engine.pipeline import (
    STATE_PLANES,
    init_state,
    render_frame,
    state_to_numpy,
)
from voxtracer_torch.engine.scene import GridScene, SceneTables, default_scene
from voxtracer_torch.ops import denoise, epilogue, temporal, trace
from voxtracer_torch.ops.noise import white_noise_buffer
from voxtracer_torch.parallel import (
    gather_state,
    make_mesh,
    scene_device_args,
    sharded_render_frame,
)
from voxtracer_torch.parallel import mesh as mesh_mod

PARAMS = (RenderParams(), TemporalParams(), DenoiseParams())
# tests/test_parallel.py:103-111: a few pixels of reprojection offset
# between the two poses, crossing the slab edges
CAM_A = Camera(position=np.array([0.0, 2.0, -8.0]),
               direction=np.array([0.0, -0.3, 1.0]))
CAM_B = Camera(position=np.array([0.15, 2.2, -8.1]),
               direction=np.array([0.02, -0.32, 1.0]))
# frame 1 without history, frame 2 moved (the reprojecting blend over
# the whole history), frame 3 still (the still blend with history)
FRAMES = (CAM_A, CAM_B, CAM_B)


@functools.lru_cache(maxsize=None)
def _scene():
    return GridScene.from_voxels(default_scene(radius=10, seed=2))


@functools.lru_cache(maxsize=None)
def _noise():
    return white_noise_buffer(seed=1, count=32)


@functools.lru_cache(maxsize=None)
def _one_device(height, width, radius, n_frames=len(FRAMES)):
    """The one-device frames (outputs, numpy state) along ``FRAMES``."""
    tables = SceneTables(_scene(), "cpu")
    noise = torch.from_numpy(_noise())
    state = init_state(height, width, "cpu")
    frames = []
    for f, cam in enumerate(FRAMES[:n_frames]):
        state, out = render_frame(state, tables, noise,
                                  cam.rows(width, height), *PARAMS, f + 1,
                                  height, width, radius=radius)
        frames.append((out, state_to_numpy(state)))
    return frames


def _slab_frames(devices, height, width, radius, cams, layout="contiguous"):
    mesh = make_mesh(devices)
    fn, place = sharded_render_frame(mesh, height=height, width=width,
                                     radius=radius, layout=layout)
    tables, noise = scene_device_args(_scene(), mesh, _noise())
    state = place(init_state(height, width, mesh[0]))
    frames = []
    for f, cam in enumerate(cams):
        state, out = fn(state, tables, noise, cam.rows(width, height),
                        *PARAMS, f + 1)
        frames.append((out, state_to_numpy(gather_state(state, "cpu"))))
    return frames, fn


def _assert_bit_equal(want, got):
    for f, ((wo, ws), (go, gs)) in enumerate(zip(want, got)):
        assert set(wo) == set(go)
        for k in wo:
            assert torch.equal(wo[k].cpu(), go[k].cpu()), (f, k)
        for k in ws:
            np.testing.assert_array_equal(ws[k], gs[k], err_msg=f"{f} {k}")


def _check_scene_is_seen(frames):
    out, state = frames[-1]
    hit = state["old_depth"] >= 0
    assert 0.2 < hit.mean() < 1.0
    # frame 3 kept the history of frames 1-2 on most hit pixels
    assert (state["accum_blend"][hit] < 0.5).mean() > 0.5


@pytest.mark.parametrize("radius", [0, 2])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_slab_frames_equal_the_one_device_frames(n, radius):
    """37 rows: no n divides them, so the last slab is shorter (5 rows
    of 8 slabs: 5 x 7 + 2)."""
    h, w = 37, 32
    want = _one_device(h, w, radius)
    got, fn = _slab_frames(["cpu"] * n, h, w, radius, FRAMES)
    _assert_bit_equal(want, got)
    _check_scene_is_seen(got)
    assert fn.count.peer == 0 and fn.count.copies > 0


def test_a_halo_taller_than_a_slab():
    """16 slabs of 2 rows and a denoise halo of 3: each window takes its
    rows from as many slabs as it spans."""
    want = _one_device(32, 16, 3, 2)
    got, _ = _slab_frames(["cpu"] * 16, 32, 16, 3, FRAMES[:2])
    _assert_bit_equal(want, got)


@pytest.mark.parametrize("height", [256, 250], ids=["even", "ragged"])
def test_cyclic_slab_frames_equal_the_one_device_frames(height):
    """8 devices, 16-row bands: 256 rows are 2 bands a device; at 250
    the last device's second band has 10 rows, and nothing is padded."""
    want = _one_device(height, 32, 2, 2)
    got, fn = _slab_frames(["cpu"] * 8, height, 32, 2, FRAMES[:2],
                           layout="cyclic")
    _assert_bit_equal(want, got)
    assert mesh_mod.cyclic_heights(height, 8) == (
        (32,) * 8 if height == 256 else (32,) * 7 + (26,))


@pytest.mark.parametrize("nbl", [2, 17])
@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_cyclic_resort_matches_numpy(nbl, planar, ragged):
    """The cyclic -> contiguous resort (``mesh.cyclic_to_contig``) gives
    the plain row order for any band count (nbl bands a device, as the
    reference's ``tests/test_parallel.py`` test; 17 is castle 4K's shape
    at 16-row bands over 8 devices), and for a height that n bands do not
    divide."""
    n, block, width = 8, trace.BLOCK_ROWS, 6
    rows = n * nbl * block - (5 if ragged else 0)
    rng = np.random.default_rng(3)
    whole = rng.integers(0, 1000, (3, rows, width)).astype(np.float32)
    if not planar:
        whole = whole[0]
    # device c's planes: its bands c, c + n, ... in order
    bands = [np.arange(b * block, min((b + 1) * block, rows))
             for b in range(-(-rows // block))]
    traced = [torch.from_numpy(np.take(
        whole, np.concatenate(bands[c::n]), axis=-2)) for c in range(n)]
    assert tuple(t.shape[-2] for t in traced) == mesh_mod.cyclic_heights(
        rows, n)
    mesh = make_mesh(["cpu"] * n)
    count = mesh_mod.CopyCount()
    slabs = mesh_mod.cyclic_to_contig(traced, mesh, rows,
                                      mesh_mod.cyclic_plan(mesh, rows), count)
    bounds = mesh_mod.slab_bounds(rows, n)
    for (s, e), slab in zip(bounds, slabs):
        np.testing.assert_array_equal(slab.numpy(), whole[..., s:e, :])
    assert count.peer == 0 and count.bytes == whole.nbytes


def test_slab_bounds_and_refusals():
    assert mesh_mod.slab_bounds(37, 8) == tuple(
        (5 * i, min(5 * i + 5, 37)) for i in range(8))
    with pytest.raises(ValueError, match="empty"):
        mesh_mod.slab_bounds(9, 4)  # 3 rows a slab: the fourth gets none
    with pytest.raises(ValueError, match="no band"):
        mesh_mod.cyclic_heights(32, 8)
    with pytest.raises(ValueError, match="layout"):
        sharded_render_frame(make_mesh(["cpu"]), height=8, width=8,
                             layout="rows")


def test_state_round_trip_and_replicas():
    mesh = make_mesh(["cpu"] * 3)
    state = init_state(10, 4, "cpu")
    state["accum_color"].uniform_()
    _, place = sharded_render_frame(mesh, height=10, width=4)
    sharded = place(state)
    assert [t.shape[-2] for t in sharded["old_depth"]] == [4, 4, 2]
    assert all(t.is_contiguous() for t in sharded["accum_color"])
    back = gather_state(sharded, "cpu")
    for k in STATE_PLANES:
        assert torch.equal(back[k], state[k])
        assert back[k].data_ptr() != state[k].data_ptr()
    tables, noise = scene_device_args(_scene(), mesh, _noise())
    # one copy per distinct device, shared by its slabs
    assert tables[0] is tables[1] is tables[2]
    assert noise[0] is noise[2]


def test_plain_trace_rows_are_the_one_device_rows():
    """A slab's trace (``row0``) and a cyclic device's trace (``row0 =
    c * 16``, ``row_stride = n``) are the one-device trace's rows: ray
    generation and the noise row read the image row (the JAX package's
    param slot 30, ``trace_pallas.py:279``)."""
    h, w = 72, 24
    tables = SceneTables(_scene(), "cpu")
    noise = torch.from_numpy(_noise())
    params = pack_trace_params(CAM_A.rows(w, h), RenderParams())
    whole = trace.render_sample(tables, params, noise, 3, h, w)
    for row0, rows, stride in ((13, 19, 1), (0, 8, 1), (16, 20, 3),
                               (32, 24, 2)):
        part = trace.render_sample(tables, params, noise, 3, rows, w,
                                   row0=row0, row_stride=stride)
        idx = torch.from_numpy(trace.image_rows(rows, row0, stride))
        for k in ("color", "normal", "depth", "albedo", "node"):
            assert torch.equal(part[k], whole[k].index_select(-2, idx)), k
    with pytest.raises(ValueError, match="invalid rows"):
        trace.render_sample(tables, params, noise, 3, 4, w, row0=-1)


def _planes(rng, h, w, sky=0.2):
    depth = rng.uniform(3.0, 12.0, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < sky] = -1.0
    normal = rng.normal(size=(3, h, w)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=0)
    return (rng.random((3, h, w), dtype=np.float32), normal, depth)


def test_still_blend_with_row0_matches_jax_and_the_whole_frame():
    """``temporal_blend_still_planar(row0=)`` of a slab: the JAX
    package's function with its ``row0`` at the blend bar, and the
    port's whole-frame blend's rows bit for bit."""
    import jax.numpy as jnp

    from voxtracer.engine import params as jparams
    from voxtracer.ops import temporal as jtemporal

    h, w, row0, rows = 48, 40, 17, 11
    rng = np.random.default_rng(11)
    cur = _planes(rng, h, w)
    old = (rng.random((3, h, w), dtype=np.float32),
           rng.uniform(0.02, 0.9, (h, w)).astype(np.float32),
           cur[2] + rng.normal(0, 1e-3, (h, w)).astype(np.float32))
    cam = CAM_A.rows(w, h)
    old_cam = (cam + np.float32(1e-4)).astype(np.float32)
    tp = TemporalParams(blending_distance_cutoff=0.05)
    sl = slice(row0, row0 + rows)
    slab = [torch.from_numpy(np.ascontiguousarray(a[..., sl, :]))
            for a in (*cur, *old)]
    got = temporal.temporal_blend_still_planar(*slab, cam, old_cam, tp, True,
                                               row0=row0)
    whole = temporal.temporal_blend_still_planar(
        *(torch.from_numpy(a) for a in (*cur, *old)), cam, old_cam, tp, True)
    assert torch.equal(got[0], whole[0][:, sl])
    assert torch.equal(got[1], whole[1][sl])
    want = jtemporal.temporal_blend_still_planar(
        *(jnp.asarray(t.numpy()) for t in slab),
        tuple(jnp.asarray(r) for r in cam),
        tuple(jnp.asarray(r) for r in old_cam),
        jparams.TemporalParams(**vars(tp)), jnp.asarray(True),
        row0=jnp.float32(row0))
    kept = np.asarray(want[1]) < 0.5
    assert kept.mean() > 0.3
    np.testing.assert_array_equal(got[1].numpy() < 0.5, kept)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)


def test_reprojecting_blend_with_row0_matches_jax_and_the_whole_frame():
    """The channels-last ``temporal_blend(..., reproject=True, row0=)``
    of a slab against the whole history: the JAX package's any-offset
    ``temporal_blend(..., resample_impl="xla", row0=)`` at the blend
    bar; the planar plain version's slab, the whole frame's rows bit
    for bit."""
    import jax.numpy as jnp

    from voxtracer.engine import params as jparams
    from voxtracer.ops import temporal as jtemporal

    h, w, row0, rows = 48, 40, 9, 23
    rng = np.random.default_rng(12)
    cur = _planes(rng, h, w)
    hist = (rng.random((3, h, w), dtype=np.float32),
            rng.uniform(0.02, 0.9, (h, w)).astype(np.float32),
            cur[2].copy())
    cam = CAM_B.rows(w, h)
    old_cam = CAM_A.rows(w, h)
    tp = TemporalParams(blending_distance_cutoff=0.5)
    sl = slice(row0, row0 + rows)
    hwc = lambda a: np.ascontiguousarray(np.moveaxis(a, 0, -1))  # noqa: E731
    cur_slab = [np.ascontiguousarray(a[..., sl, :]) for a in cur]
    got = temporal.temporal_blend(
        torch.from_numpy(hwc(cur_slab[0])), torch.from_numpy(hwc(cur_slab[1])),
        torch.from_numpy(cur_slab[2]), torch.from_numpy(hwc(hist[0])),
        torch.from_numpy(hist[1]), torch.from_numpy(hist[2]), cam, old_cam,
        tp, True, reproject=True, row0=row0)
    want = jtemporal.temporal_blend(
        jnp.asarray(hwc(cur_slab[0])), jnp.asarray(hwc(cur_slab[1])),
        jnp.asarray(cur_slab[2]), jnp.asarray(hwc(hist[0])),
        jnp.asarray(hist[1]), jnp.asarray(hist[2]),
        tuple(jnp.asarray(r) for r in cam),
        tuple(jnp.asarray(r) for r in old_cam),
        jparams.TemporalParams(**vars(tp)), jnp.asarray(True),
        reproject=True, resample_impl="xla", row0=jnp.float32(row0))
    restart = np.float32(1.0) - np.float32(tp.sample_blending)
    kept = np.asarray(want[1]) < restart - 1e-6
    assert kept.mean() > 0.05
    np.testing.assert_array_equal(got[1].numpy() < restart - 1e-6, kept)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
    # the planar plain version: the slab is the whole frame's rows
    p = pack_temporal_params(cam, old_cam, tp, True)
    t_hist = [torch.from_numpy(a) for a in hist]
    slab = temporal.temporal_blend_reproject(
        *(torch.from_numpy(a) for a in cur_slab), *t_hist, p, row0=row0)
    whole = temporal.temporal_blend_reproject(
        *(torch.from_numpy(a) for a in cur), *t_hist, p)
    assert torch.equal(slab[0], whole[0][:, sl])
    assert torch.equal(slab[1], whole[1][sl])
    assert torch.equal(slab[0], torch.movedim(got[0], -1, 0))
    with pytest.raises(ValueError, match="outside the history"):
        temporal.temporal_blend_reproject(
            *(torch.from_numpy(a) for a in cur_slab), *t_hist, p,
            row0=h - rows + 1)


def test_denoise_window_rows_are_the_whole_frame_rows():
    """A slab's denoise over its window (``row0`` the window's first
    row, halos of r rows from its neighbours) keeps the whole frame's
    rows bit for bit, at the image's edges too."""
    h, w, r = 30, 20, 2
    rng = np.random.default_rng(13)
    colors, normal, depth = _planes(rng, h, w)
    albedo = rng.random((3, h, w), dtype=np.float32)
    node = rng.integers(0, 4, (h, w)).astype(np.int32) << 24
    planes = [torch.from_numpy(a) for a in (colors, normal, depth, albedo,
                                            node)]
    params = np.zeros(16, np.float32)
    params[:12] = CAM_A.rows(w, h).reshape(-1)
    params[12:15] = (2.0, 1.5, 1.0)
    whole = denoise.denoise(*planes, params, r)
    for s, e in ((0, 7), (7, 14), (14, 30), (9, 10)):
        lo, hi = max(0, s - r), min(h, e + r)
        win = denoise.denoise(*(p[..., lo:hi, :].contiguous() for p in planes),
                              params, r, row0=lo)
        assert torch.equal(win[:, s - lo:e - lo], whole[:, s:e]), (s, e)


# Pinned per frame, each measured: node flips, pixels whose colour is
# beyond 1e-5 (+1e-5 relative) and u8 pixels more than 1 code apart.
# All lie on the image's centre row or column, whose rays run in an axis
# plane through the scene's centre, where the XLA twin's dense-grid DDA
# and the port's table DDA part (the one-device frames differ from the
# JAX package's at the same pixels; tests/test_torch_pipeline.py pins
# such pixels as MOVING_PINS); frame 2 reprojects one of them.
JAX_MESH_PINS = dict(flips=(1, 0), colour=(5, 1), u8=(5, 0))


def test_matches_the_jax_mesh_frame():
    """The slab frame on 8 CPU slabs against the JAX package's
    ``sharded_render_frame`` on its 8 virtual devices (XLA trace path,
    32x32, r = 0), frame 1 and a moved frame 2, at the one-device
    frame's bar (``tests/test_torch_pipeline.py``): node ids exact,
    depth and colour 1e-5, u8 within 1, but at the pinned pixels."""
    import jax.numpy as jnp

    from voxtracer.engine import params as jparams
    from voxtracer.engine import pipeline as jpipeline
    from voxtracer.parallel import make_mesh as jmake_mesh
    from voxtracer.parallel import sharded_render_frame as jsharded
    from voxtracer.parallel.mesh import scene_device_args as jscene_args
    from voxtracer.scene import GridScene as JGridScene
    from voxtracer.scene import default_scene as jdefault_scene

    h = w = 32
    meta, arrays = jscene_args(
        JGridScene.from_voxels(jdefault_scene(radius=10, seed=2)))
    jfn, jplace = jsharded(jmake_mesh(), scene_meta=meta, height=h, width=w,
                           radius=0, reproject=True)
    jstate = jplace(jpipeline.init_state(h, w))
    jp = (jparams.RenderParams(), jparams.TemporalParams(),
          jparams.DenoiseParams())
    got, _ = _slab_frames(["cpu"] * 8, h, w, 0, FRAMES[:2])
    centre = np.zeros((h, w), bool)
    centre[h // 2] = centre[:, w // 2] = True
    for f, cam in enumerate(FRAMES[:2]):
        jstate, jout = jfn(jstate, arrays, jnp.asarray(cam.rows(w, h)), *jp,
                           jnp.asarray(_noise()), jnp.int32(f + 1))
        out, state = got[f]
        want = {k: np.asarray(v) for k, v in jstate.items()}
        flips = out["node"].numpy() != np.asarray(jout["node"])
        assert int(flips.sum()) <= JAX_MESH_PINS["flips"][f]
        assert not (flips & ~centre).any()
        hit = want["old_depth"] >= 0
        assert hit.mean() > 0.2
        np.testing.assert_array_equal(state["old_depth"] >= 0, hit)
        np.testing.assert_allclose(state["old_depth"][hit],
                                   want["old_depth"][hit], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(state["accum_blend"],
                                      want["accum_blend"])
        err = np.abs(state["accum_color"] - want["accum_color"])
        far = (err > 1e-5 + 1e-5 * np.abs(want["accum_color"])).any(0)
        assert int(far.sum()) <= JAX_MESH_PINS["colour"][f]
        diff = np.abs(out["image"].numpy().astype(int)
                      - np.asarray(jout["image"]).astype(int)).max(-1)
        assert int((diff > 1).sum()) <= JAX_MESH_PINS["u8"][f]
        assert int((diff > 0).sum()) <= 3 + JAX_MESH_PINS["u8"][f]


@pytest.mark.slow
def test_plain_trace_row0_matches_the_pallas_kernel_with_slot_30():
    """The plain trace of a slab (``row0``) against the JAX package's
    Pallas kernel with the slab's first row in param slot 30 and the
    noise rolled by it (``pipeline.py:261-277``), interpreted, at the
    bar of ``tests/test_torch_trace.py``'s interpret comparison (about
    40 s)."""
    import jax.numpy as jnp

    from voxtracer.ops import trace_pallas

    h, w, row0, rows = 32, 32, 8, 16
    t = _scene().device_tables()
    cam = CAM_A.rows(w, h)
    pv = jnp.asarray(trace_pallas.pack_params(cam, RenderParams()))
    pv = pv.at[0, 30].set(jnp.float32(row0))
    ref = trace_pallas.render_sample(
        jnp.asarray(t["packed_idx"]), jnp.asarray(t["meta_idx"]),
        jnp.asarray(t["brick_idx"]), jnp.asarray(t["palette"]), pv,
        trace_pallas.noise_quads(jnp.asarray(_noise()), jnp.int32(1),
                                 roll=row0),
        dims=_scene().values.shape, zw=t["zw"],
        origin=tuple(int(v) for v in _scene().origin),
        n_rows=t["packed_idx"].shape[0], l3_dims=t["l3_dims"],
        m_rows=t["meta_idx"].shape[0], b_rows=t["brick_idx"].shape[1],
        height=rows, width=w, interpret=True,
    )
    got = trace.render_sample(SceneTables(_scene(), "cpu"),
                              pack_trace_params(cam, RenderParams()),
                              torch.from_numpy(_noise()), 1, rows, w,
                              row0=row0)
    node = np.asarray(ref["node"])
    agree = node == got["node"].numpy()
    assert (node != 0xFFFFFF).any()
    # pinned, measured: one flip, image pixel (16, 26) on the centre row,
    # where the one-device frames part from the JAX package's too
    # (test_matches_the_jax_mesh_frame)
    assert [tuple(p) for p in np.argwhere(~agree)] in ([], [(h // 2 - row0,
                                                          26)])
    depth = np.asarray(ref["depth"])
    hit = (depth >= 0) & agree
    np.testing.assert_allclose(got["depth"].numpy()[hit], depth[hit],
                               rtol=1e-5, atol=1e-5)
    err = np.abs(got["color"].numpy() - np.asarray(ref["color"])).max(0)
    assert (err[agree] < 1e-3).mean() > 0.995


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("n, radius, layout, height",
                         [(4, 0, "contiguous", 96), (3, 2, "contiguous", 97),
                          (16, 8, "contiguous", 64), (4, 2, "cyclic", 100)])
def test_slab_frames_on_one_card(cuda, n, radius, layout, height):
    """The slab frame on ``["cuda:0"] * n`` with the kernels == the
    one-device frame on the card, and each kernel launched once a slab
    and stage."""
    from voxtracer_torch.engine.pipeline import counted_kernels

    w = 64
    tables = SceneTables(_scene(), cuda)
    noise = torch.from_numpy(_noise()).to(cuda)
    state = init_state(height, w, cuda)
    want = []
    for f, cam in enumerate(FRAMES):
        state, out = render_frame(state, tables, noise, cam.rows(w, height),
                                  *PARAMS, f + 1, height, w, radius=radius)
        want.append((out, state_to_numpy(state)))
    kernels = counted_kernels()
    for k in kernels:
        k.launches = 0
    got, _ = _slab_frames([cuda] * n, height, w, radius, FRAMES, layout)
    _assert_bit_equal(want, got)
    launches = [k.launches for k in kernels]
    # trace, temporal, denoise, resample, still epilogue, encode
    assert launches == [3 * n, n, 3 * n if radius else 0, 0, 2 * n,
                        3 * n if radius else n], launches


@pytest.mark.cuda
def test_kernels_with_row0_equal_their_plain_versions(cuda):
    """Each kernel's slab arguments against its plain version on the
    card: the trace (``row0``, ``row_stride``), the
    reprojecting blend against the whole history (``row0``), the still
    epilogue (``row0``) and the denoise window (``row0``)."""
    h, w = 40, 64
    rng = np.random.default_rng(21)
    tables = SceneTables(_scene(), cuda)
    noise = torch.from_numpy(_noise()).to(cuda)
    params = pack_trace_params(CAM_A.rows(w, h), RenderParams())
    for row0, rows, stride in ((13, 19, 1), (16, 20, 2)):
        args = (tables, params, noise, 2, rows, w, row0, stride)
        k = trace.render_sample_cuda(*args)
        p = trace.render_sample_plain(*args)
        for key in ("normal", "depth", "albedo", "node"):
            assert torch.equal(k[key], p[key]), key
        assert (k["color"] - p["color"]).abs().max().item() < 1e-3
        assert torch.equal(k["rays"][:3], p["rays"][:3])
    cur = [torch.from_numpy(a).to(cuda) for a in _planes(rng, h, w)]
    hist = [torch.from_numpy(a).to(cuda) for a in (
        rng.random((3, h, w), dtype=np.float32),
        rng.uniform(0.02, 0.9, (h, w)).astype(np.float32),
        cur[2].cpu().numpy())]
    tp = TemporalParams(blending_distance_cutoff=0.5)
    p = pack_temporal_params(CAM_B.rows(w, h), CAM_A.rows(w, h), tp, True)
    slab = [t[..., 9:30, :].contiguous() for t in cur]
    kb, kn = temporal.temporal_blend_reproject_cuda(*slab, *hist, p, row0=9)
    pb, pn = temporal.temporal_blend_reproject_plain(*slab, *hist, p,
                                                     row0=9)
    assert torch.equal(kn, pn)
    assert (kb - pb).abs().max().item() <= 1e-6
    row = pack_frame_rows([CAM_B.rows(w, h)], CAM_A.rows(w, h), True, 3,
                          RenderParams(), tp, DenoiseParams())[0]
    albedo = torch.rand((3, 21, w), device=cuda)
    hist_slab = [t[..., 9:30, :].contiguous() for t in hist]
    k = epilogue.still_epilogue_cuda(*slab, *hist_slab, albedo, row, True,
                                     row0=9)
    q = epilogue.still_epilogue_plain(*slab, *hist_slab, albedo, row, True,
                                      row0=9)
    for a, b in zip(k, q):
        assert torch.equal(a, b)
    node = torch.from_numpy(rng.integers(0, 4, (21, w)).astype(np.int32)
                            << 24).to(cuda)
    dp = row[ROW_DENOISE:ROW_DENOISE + DENOISE_PARAMS_LEN]
    kd = denoise.denoise_cuda(*slab, albedo, node, dp, 2, row0=9)
    pd = denoise.denoise_plain(*slab, albedo, node, dp, 2, row0=9)
    assert ((kd - pd).abs() <= 1e-6 + 1e-6 * pd.abs()).all()
