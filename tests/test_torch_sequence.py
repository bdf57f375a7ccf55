"""The offline export path of the port on the CPU:
``Renderer.render_sequence`` / ``render_burst`` against as many
``render()`` calls (bit for bit: the same stages read the same row),
against the JAX package's ``render_sequence``, and the per-frame rows
they read (``pack_frame_rows``) against the per-stage vectors and the
JAX package's ``pack_kernel_rows``.  The CUDA-graph replay of the same
path is held against the loop in ``tests/test_torch_cuda.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

from voxtracer.engine import params as jparams
from voxtracer.engine.camera import Camera as JCamera
from voxtracer.engine.pipeline import Renderer as JRenderer
from voxtracer_torch.engine import params as P
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine import pipeline
from voxtracer_torch.engine.pipeline import STATE_PLANES, Renderer
from voxtracer_torch.ops import denoise, epilogue, temporal
from voxtracer_torch.ops import trace as trace_op
from voxtracer_torch.scene import GridScene, VoxelList, default_scene
from voxtracer_torch.utils.timing import COUNTS

STILL = dict(position=np.array([0.3, 0.2, -2.0]))


def _tiny_scene():
    return GridScene.from_voxels(VoxelList(
        pos=np.array([[0, 0, 0], [1, 1, 1]], dtype=np.int16),
        mrgb=np.array([[0, 200, 0, 0], [0, 0, 200, 0]], dtype=np.uint8),
    ))


def _orbit(n, step=0.3, camera=Camera):
    return [camera(position=np.array([4.0 * np.sin(a), 1.5, -4.0 * np.cos(a)]),
                   direction=np.array([-np.sin(a), -0.3, np.cos(a)]))
            for a in (step * i for i in range(n))]


def _mixed(camera=Camera):
    """still, still, pan, pan, still, still, pan"""
    o = _orbit(3, camera=camera)
    return [o[0], o[0], o[1], o[2], o[2], o[2], o[0]]


def _segments(camera=Camera):
    """Still and moving segments of odd and even lengths: still x3, pan
    x2, still x2, pan x1, still x1 (from a fresh renderer)."""
    o = _orbit(4, camera=camera)
    return [o[0], o[0], o[0], o[1], o[2], o[2], o[2], o[3], o[3]]


def _pair(scene, **kw):
    kw = dict(scene=scene, height=16, width=16, device="cpu", **kw)
    return Renderer(**kw), Renderer(**kw)


def _assert_same_state(a, b):
    for k in STATE_PLANES:
        assert torch.equal(a.state[k], b.state[k]), k
    np.testing.assert_array_equal(a.state["old_cam"], b.state["old_cam"])
    assert a.state["history_valid"] and b.state["history_valid"]
    assert (a.frame_number, a.still_sample) == (b.frame_number,
                                                b.still_sample)


PATHS = {
    # name: (scene, cameras, denoise radius)
    "still-r1": (_tiny_scene, lambda: [Camera(**STILL)] * 4, 1),
    "orbit-r0": (lambda: GridScene.from_voxels(default_scene(radius=6, seed=3)),
                 lambda: _orbit(5), 0),
    "mixed-r0": (lambda: GridScene.from_voxels(default_scene(radius=6, seed=3)),
                 _mixed, 0),
    "mixed-r2": (_tiny_scene, _mixed, 2),
    "segments-r0": (
        lambda: GridScene.from_voxels(default_scene(radius=6, seed=3)),
        _segments, 0),
    "segments-r1": (_tiny_scene, _segments, 1),
}


@pytest.mark.parametrize("case", list(PATHS))
def test_sequence_matches_sequential_renders(case):
    """Frames, state and counters of a sequence equal N ``render()``
    calls bit for bit, on still, moving and mixed paths; and so does
    the ``render()`` that follows."""
    scene, cams, radius = PATHS[case]
    seq, bat = _pair(scene(), denoise_radius=radius)
    cams = cams()
    outs = [seq.render(c)["image"].numpy() for c in cams]
    frames = bat.render_sequence(cams)
    assert frames.shape == (len(cams), 16, 16, 3)
    assert frames.dtype == torch.uint8
    for i, want in enumerate(outs):
        np.testing.assert_array_equal(frames[i].numpy(), want, err_msg=str(i))
    assert np.std(outs[-1]) > 0
    assert bat.frame_number == len(cams)
    _assert_same_state(seq, bat)
    np.testing.assert_array_equal(seq.render(cams[1])["image"].numpy(),
                                  bat.render(cams[1])["image"].numpy())
    _assert_same_state(seq, bat)


def test_segment_rle():
    segs = Renderer._segments([False, False, True, True, False, True])
    assert segs == [(0, 2, False), (2, 4, True), (4, 5, False),
                    (5, 6, True)]
    assert Renderer._segments([True]) == [(0, 1, True)]
    assert segs == JRenderer._segments(
        [False, False, True, True, False, True])


def test_pack_sequence_flags_follow_the_history():
    """A frame reprojects where a moved camera meets live history: never
    on a first frame, nor at rest."""
    r = Renderer(scene=_tiny_scene(), height=16, width=16, device="cpu")
    cams = _mixed()
    rows, flags, still, last = r._pack_sequence(cams)
    assert rows.shape == (7, P.ROW_LEN) and rows.dtype == np.float32
    assert flags == [False, False, True, True, False, False, True]
    assert still == 1
    np.testing.assert_array_equal(last, cams[-1].rows(16, 16))
    r.render(cams[0])
    assert r._pack_sequence(cams)[1] == [False, False, True, True, False,
                                         False, True]
    assert r._pack_sequence(cams[2:5])[1:3] == ([True, True, False], 2)
    r.reset_accumulation()
    assert r._pack_sequence(cams[2:5])[1] == [False, True, False]


def test_burst_returns_final_frame():
    scene = _tiny_scene()
    cam = Camera(**STILL)
    a, b = _pair(scene)
    final = a.render_burst(cam, 3)
    for _ in range(3):
        out = b.render(cam)
    assert final.shape == (16, 16, 3) and final.dtype == torch.uint8
    np.testing.assert_array_equal(final.numpy(), out["image"].numpy())
    _assert_same_state(a, b)
    assert a.still_sample == 3


@pytest.mark.parametrize("n", [3, 4])
def test_burst_after_a_moving_sequence_equals_renders(n):
    """A burst of odd or even length that follows a moving sequence
    equals as many ``render()`` calls: frame and state."""
    scene = GridScene.from_voxels(default_scene(radius=6, seed=3))
    a, b = _pair(scene)
    moving = _orbit(3)
    a.render_sequence(moving)
    for c in moving:
        b.render(c)
    final = a.render_burst(moving[-1], n)
    for _ in range(n):
        out = b.render(moving[-1])
    np.testing.assert_array_equal(final.numpy(), out["image"].numpy())
    _assert_same_state(a, b)
    assert a.still_sample == n + 1


def _host(p):  # the plain trace and temporal blend read numpy rows
    return p.row.numpy()


def _trace_stage(tables, p, noise, frame, h, w):
    row = _host(p)
    return trace_op.render_sample_plain(
        tables, row[P.ROW_TRACE:P.ROW_FRAME], noise,
        int(row[P.ROW_FRAME:P.ROW_FRAME + 1].view(np.int32)[0]), h, w)


def _temporal_stage(*args):
    row = _host(args[-1])
    return temporal.temporal_blend_reproject(
        *args[:-1], row[P.ROW_TEMPORAL:P.ROW_DENOISE])


def _denoise_stage(colors, normal, depth, albedo, node, p, r):
    row = _host(p)
    return denoise.denoise(colors, normal, depth, albedo, node,
                           row[P.ROW_DENOISE:P.ROW_KEEP_SAMPLE], r)


@pytest.mark.parametrize("radius", [0, 1])
def test_sequence_runner_blends_still_frames_into_its_state(radius):
    """The card's sequence path (``SequenceRunner``), run eagerly on CPU
    tensors: a still frame's epilogue blends straight into the carried
    state (its tensors stay where they are, the still stage is asked to
    work in place), a reprojecting frame's blend is copied there; frames
    and state equal ``render()`` calls on a path of still and moving
    segments of odd and even lengths."""
    scene = GridScene.from_voxels(default_scene(radius=6, seed=3))
    seq, loop = _pair(scene, denoise_radius=radius)
    cams = _segments()
    rows, flags, _, _ = seq._pack_sequence(cams)
    assert flags == [False] * 3 + [True] * 2 + [False] * 2 + [True, False]

    asked = []

    def still_stage(*args, in_place=False):
        asked.append(in_place)
        return epilogue.still_epilogue_plain(*args, in_place=in_place)

    stages = (_trace_stage, _temporal_stage, _denoise_stage, still_stage,
              epilogue.encode_plain)
    runner = pipeline.SequenceRunner(None, seq.tables, seq.noise, 16, 16,
                                     radius, stages)
    runner.load_rows(rows, len(rows))
    runner.load_state(seq.state, True)
    where = {k: runner.state[k] for k in STATE_PLANES}
    runner.run(Renderer._segments(flags), graph=False)
    assert asked == [True] * flags.count(False)
    assert all(runner.state[k] is where[k] for k in STATE_PLANES)
    want = [loop.render(c)["image"] for c in cams]
    assert torch.equal(runner.frames, torch.stack(want))
    for k in STATE_PLANES:
        assert torch.equal(runner.state[k], loop.state[k]), k


def test_a_replay_adds_the_denoise_warps_its_capture_counted(monkeypatch):
    """The card's sequence path on CPU tensors, through stand-ins for
    CUDA graphs (a capture runs the frame, a replay nothing) and a
    denoise stage that counts as its wrapper does: a capture leaves the
    counts as its eager frame left them, and each replay adds to
    ``denoise.resident_warps`` and ``denoise.reciprocal_launches`` what
    its frame's denoise launch added, once for each ``launches.denoise``
    it adds."""
    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)

    def denoise_stage(*args):
        denoise.denoise_cuda.launches += 1
        COUNTS["denoise.resident_warps"] += 24
        COUNTS["denoise.reciprocal_launches"] += 1
        return _denoise_stage(*args)

    seq, _ = _pair(_tiny_scene(), denoise_radius=2)
    cams = _segments()
    rows, flags, _, _ = seq._pack_sequence(cams)
    runner = pipeline.SequenceRunner(
        None, seq.tables, seq.noise, 16, 16, 2,
        (_trace_stage, _temporal_stage, denoise_stage,
         epilogue.still_epilogue_plain, epilogue.encode_plain))
    runner.load_rows(rows, len(rows))
    for reproject in (False, True):
        before = pipeline.counters()
        runner.capture(reproject)
        grown = {k: v - before[k] for k, v in pipeline.counters().items()}
        assert grown["launches.denoise"] == 1  # the eager frame's
        assert grown["denoise.resident_warps"] == 24
        assert grown["denoise.reciprocal_launches"] == 1
    runner.load_state(seq.state, True)
    before = pipeline.counters()
    runner.run(Renderer._segments(flags), graph=True)
    grown = {k: v - before[k] for k, v in pipeline.counters().items()}
    assert grown["graph.replays"] == grown["launches.denoise"] == len(cams)
    assert grown["denoise.resident_warps"] == 24 * len(cams)
    assert grown["denoise.reciprocal_launches"] == len(cams)


def test_sequence_after_realtime_frames_continues_accumulation():
    """A batch appended to live realtime history consumes the existing
    state (history_valid rides in frame 0's row)."""
    seq, bat = _pair(_tiny_scene())
    cam = Camera(**STILL)
    for r in (seq, bat):
        r.render(cam)
        r.render(cam)
    outs = [seq.render(cam)["image"].numpy() for _ in range(3)]
    frames = bat.render_sequence([cam] * 3).numpy()
    for i in range(3):
        np.testing.assert_array_equal(frames[i], outs[i])
    assert bat.frame_number == seq.frame_number == 5
    assert bat.still_sample == seq.still_sample == 5


def test_empty_sequence_rejected():
    r = Renderer(scene=_tiny_scene(), height=16, width=16, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        r.render_sequence([])
    with pytest.raises(ValueError, match="at least one"):
        r.render_burst(Camera(**STILL), 0)


@pytest.mark.parametrize("case, radius, pins", [
    ("orbit", 0, (0, 0, 0, 0, 0)),
    ("mixed", 0, (0, 0, 0, 0, 0, 0, 0)),
    ("mixed", 1, (0, 0, 0, 0, 0, 0, 0)),
    ("segments", 0, (0,) * 9),
])
def test_sequence_matches_jax_render_sequence(case, radius, pins):
    """The same cameras through the JAX package's ``render_sequence``
    (XLA trace) and the port's.  The bar of the moving frames in
    ``tests/test_torch_pipeline.py`` (its ``MOVING_PINS``): u8 frames
    within 1 code value except at a pinned count of pixels per frame,
    here 0 measured on every frame; accumulated colour within 1e-5
    (+1e-5 relative), blend and validity as there."""
    scene = GridScene.from_voxels(default_scene(radius=6, seed=3))
    rng = np.random.default_rng(11)
    jitter = rng.uniform(-0.05, 0.05, 3)

    def cams(camera):
        base = {"orbit": lambda c: _orbit(5, camera=c), "mixed": _mixed,
                "segments": _segments}[case](camera)
        return [camera(position=c.position + jitter, direction=c.direction)
                for c in base]

    jr = JRenderer(scene=scene, height=16, width=16, trace_impl="xla",
                   denoise_radius=radius)
    want = np.asarray(jr.render_sequence(cams(JCamera)))
    r = Renderer(scene=scene, height=16, width=16, device="cpu",
                 denoise_radius=radius)
    got = r.render_sequence(cams(Camera)).numpy()
    assert got.shape == want.shape and got.std() > 0
    diff = np.abs(got.astype(int) - want.astype(int))
    for f, pin in enumerate(pins):
        assert int((diff[f] > 1).any(-1).sum()) <= pin, f
    assert (r.frame_number, r.still_sample) == (jr.frame_number,
                                                jr.still_sample)
    jstate = {k: np.asarray(v) for k, v in jr.state.items()}
    np.testing.assert_array_equal(r.state["old_cam"], jstate["old_cam"])
    np.testing.assert_array_equal(r.state["old_depth"].numpy() >= 0,
                                  jstate["old_depth"] >= 0)
    np.testing.assert_allclose(r.state["accum_blend"].numpy(),
                               jstate["accum_blend"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r.state["accum_color"].numpy(),
                               jstate["accum_color"], rtol=1e-5, atol=1e-5)


def _row_inputs():
    rp = P.RenderParams(sun_strength=3.0, specularity=0.25,
                        sky_color=(0.2, 0.3, 0.9))
    tp = P.TemporalParams(sample_blending=0.3, maximum_blending=0.9,
                          blending_distance_cutoff=0.02)
    dp = P.DenoiseParams(sigma_distance=1.2, sigma_range=0.7,
                         albedo_factor=0.35)
    cams = [c.rows(48, 32) for c in _mixed()]
    prev = Camera(**STILL).rows(48, 32)
    return cams, prev, rp, tp, dp


@pytest.mark.parametrize("history_valid", [False, True])
def test_frame_rows_hold_the_stage_vectors(history_valid):
    """Each slice of a row is bit-equal to the stage's own vector for
    that frame; the frame number is an int32 bit pattern; the blending
    complements are formed in float32 on the host."""
    cams, prev, rp, tp, dp = _row_inputs()
    rows = P.pack_frame_rows(cams, prev, history_valid, 41, rp, tp, dp)
    assert rows.shape == (len(cams), P.ROW_LEN) and rows.dtype == np.float32
    assert P.ROW_LEN >= P.ROW_KEEP_ALBEDO + 1
    old = prev if history_valid else cams[0]
    for i, (row, cam) in enumerate(zip(rows, cams)):
        def same(lo, want):
            np.testing.assert_array_equal(
                row[lo:lo + len(want)].view(np.int32), want.view(np.int32),
                err_msg=f"frame {i} slot {lo}")

        same(P.ROW_TRACE, P.pack_trace_params(cam, rp))
        same(P.ROW_TEMPORAL, P.pack_temporal_params(
            cam, old, tp, history_valid or i > 0))
        same(P.ROW_DENOISE, P.pack_denoise_params(cam, dp))
        assert row[P.ROW_FRAME:P.ROW_FRAME + 1].view(np.int32)[0] == 41 + i
        one = np.float32(1.0)
        assert row[P.ROW_KEEP_SAMPLE] == one - np.float32(0.3)
        assert row[P.ROW_KEEP_FLOOR] == one - np.float32(0.9)
        assert row[P.ROW_KEEP_ALBEDO] == one - np.float32(0.35)
        old = cam


def test_frame_rows_match_the_jax_kernel_rows():
    """Field by field against the JAX package's ``pack_kernel_rows``
    where the layouts share a field: the trace vector (its row 0), the
    temporal row's cameras, inverse, blending scalars and validity
    (slots 0-36; 37-39 are its lane-window slots), the denoise row's
    camera and scalars (slots 0-14), the frame number (an int32 bit
    pattern in both)."""
    cams, prev, rp, tp, dp = _row_inputs()
    rows = P.pack_frame_rows(cams, prev, True, 41, rp, tp, dp)
    old = prev
    for i, (row, cam) in enumerate(zip(rows, cams)):
        ref = jparams.pack_kernel_rows(
            cam, old, jparams.RenderParams(**vars(rp)),
            jparams.TemporalParams(**vars(tp)),
            jparams.DenoiseParams(**vars(dp)), 41 + i, True, 32)

        def same(got, want):
            np.testing.assert_array_equal(
                np.ascontiguousarray(got).view(np.int32),
                np.ascontiguousarray(want, np.float32).view(np.int32),
                err_msg=f"frame {i}")

        assert ref.shape == (4, 128)
        same(row[P.ROW_TRACE:P.ROW_TRACE + 32], ref[0, :32])
        same(row[P.ROW_TEMPORAL:P.ROW_TEMPORAL + 37], ref[1, :37])
        same(row[P.ROW_DENOISE:P.ROW_DENOISE + 15], ref[2, :15])
        same(row[P.ROW_FRAME:P.ROW_FRAME + 1], ref[3, 30:31])
        assert ref[3, 30:31].view(np.int32)[0] == 41 + i
        old = cam


def _planes(h, w, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.random(s, np.float32))  # noqa: E731
    normal = rng.standard_normal((3, h, w)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=0, keepdims=True)
    depth = (rng.random((h, w), np.float32) * 6 + 1).astype(np.float32)
    depth[rng.random((h, w)) < 0.2] = -1.0
    return (f(3, h, w), torch.from_numpy(normal), torch.from_numpy(depth),
            f(3, h, w), f(h, w), torch.from_numpy(depth.copy()))


@pytest.mark.parametrize("frame", [0, 1, 4])
@pytest.mark.parametrize("history_valid", [False, True])
def test_row_reading_still_blend_equals_the_by_value_form(frame,
                                                          history_valid):
    """The still blend reading 0-dim views of a row tensor, and the one
    reading the numpy row, against ``temporal_blend_still_planar`` on the
    row's cameras and constants: ``torch.equal``."""
    cams, prev, rp, tp, dp = _row_inputs()
    rows = P.pack_frame_rows(cams, prev, history_valid, 1, rp, tp, dp)
    planes = _planes(32, 48, seed=frame)
    valid = history_valid or frame > 0
    old = cams[frame - 1] if frame else (prev if history_valid else cams[0])
    want = temporal.temporal_blend_still_planar(
        *planes, cams[frame], old, tp, valid)
    for row in (rows[frame], torch.from_numpy(rows)[frame]):
        got = temporal.temporal_blend_still_row(*planes, row)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # at rest on live history some of it is kept; without history none
    if frame:
        assert not torch.equal(want[0], planes[0])
    elif not history_valid:
        assert torch.equal(want[0], planes[0])


def test_row_reading_modulate_equals_the_by_value_form():
    cams, prev, rp, tp, dp = _row_inputs()
    rows = P.pack_frame_rows(cams, prev, True, 1, rp, tp, dp)
    color, _, _, albedo, _, _ = _planes(32, 48)
    want = denoise._modulate(color, albedo, rows[2][P.ROW_DENOISE + 14])
    assert torch.equal(
        denoise.modulate_row(color, albedo, torch.from_numpy(rows)[2]), want)
    device_row = P.DeviceRow(torch.from_numpy(rows)[2], rows[0])
    planes = _planes(32, 48)
    node = torch.zeros((32, 48), dtype=torch.int32)
    assert torch.equal(
        denoise.denoise(color, planes[1], planes[2], albedo, node,
                        device_row, 0), want)


def test_device_row_pointer_checks_what_the_kernels_read():
    """A kernel's row-reading entry gets the address of its slice of a
    contiguous float32 row on the card, or nothing."""
    rows = torch.zeros((3, P.ROW_LEN))
    for bad in (rows[1], rows[1].double(), rows[1, :40], rows[:, 0],
                rows.t().contiguous().t()[1]):
        with pytest.raises(ValueError, match="CUDA tensor"):
            P.DeviceRow(bad, rows[0].numpy()).pointer(P.ROW_TEMPORAL)
    assert (P.ROW_TRACE, P.ROW_FRAME, P.ROW_TEMPORAL, P.ROW_DENOISE) == (
        0, 32, 33, 73)


@pytest.mark.parametrize("n", [1, 3])
def test_pack_frame_rows_with_changed_and_unhashable_params(n):
    """The slots no camera changes are packed once per parameter set:
    another set gives other rows, and colours given as lists (which do
    not hash) pack as their tuples do."""
    rng = np.random.default_rng(5)
    cams = rng.normal(size=(n, 4, 3)).astype(np.float32)
    tp, dp = P.TemporalParams(sample_blending=0.25), P.DenoiseParams()
    listed = P.RenderParams(sun_color=[0.9, 0.8, 0.7], sun_yaw=0.3)
    tupled = P.RenderParams(sun_color=(0.9, 0.8, 0.7), sun_yaw=0.3)
    rows = P.pack_frame_rows(cams, cams[0], True, 4, tupled, tp, dp)
    assert np.array_equal(
        P.pack_frame_rows(cams, cams[0], True, 4, listed, tp, dp), rows)
    for i in range(n):
        assert np.array_equal(
            rows[i, P.ROW_TRACE:P.ROW_FRAME],
            P.pack_trace_params(cams[i], tupled))
        assert np.array_equal(
            rows[i, P.ROW_TEMPORAL:P.ROW_DENOISE],
            P.pack_temporal_params(cams[i], cams[max(i - 1, 0)], tp, True))
    other = P.pack_frame_rows(cams, cams[0], True, 4, P.RenderParams(), tp, dp)
    assert not np.array_equal(other, rows)
    # a caller's writes into its rows leave the next packing alone
    rows[:] = 7.0
    assert np.array_equal(
        P.pack_frame_rows(cams, cams[0], True, 4, P.RenderParams(), tp, dp),
        other)
