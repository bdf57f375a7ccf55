"""The frame driver's direct path (``voxtracer_torch/engine/direct.py``,
``csrc/frame.cu``): on the CPU with a stand-in for the kernel library
that records each native call, the frame plan launches the stages
``frame_stages`` runs, by the same rows, counts them as the eager path
would, gives every frame new memory and is rebuilt where its
configuration changes; it engages by the device alone.  The test marked
``cuda`` holds it bit-equal to the eager stages on the card
(``python -m pytest --noconftest -m cuda tests/test_torch_direct.py``;
chip_smoke phase 26 runs the same comparison)."""

import collections
import ctypes
import os
import re

import numpy as np
import pytest
import torch

from voxtracer_torch.app.renderbench import eager_render
from voxtracer_torch.engine import direct, params, pipeline, reload
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.pipeline import Renderer, counters
from voxtracer_torch.engine.scene import load_scene
from voxtracer_torch.ops import _build
from voxtracer_torch.ops import denoise as denoise_op
from voxtracer_torch.ops import epilogue as epilogue_op
from voxtracer_torch.ops import temporal as temporal_op
from voxtracer_torch.ops import trace as trace_op

POSE_A = Camera(position=np.array([2.0, 3.0, -4.0]),
                direction=np.array([0.2, 0.1, 1.0]))
POSE_B = Camera(position=np.array([2.3, 3.0, -4.0]),
                direction=np.array([0.1, 0.1, 1.0]))
# the first frame, a still one, a reprojecting one, a still one
POSES = (POSE_A, POSE_A, POSE_B, POSE_B)
FRAME_CU = os.path.join(_build.CSRC_DIR, "frame.cu")


class FakeLibrary:
    """Stands in for the kernel library: each ``vt_frame_launch`` is
    recorded with its ``reproject`` flag, the kernels that flag and the
    plan's radius give, the row the plan holds then and its arena, which
    it fills with the call's number."""

    def __init__(self):
        self.calls = []
        self.asked = []  # each occupancy query's arguments

    def vt_frame_slots(self):
        return len(direct.SLOTS)

    def vt_denoise_resident_warps(self, instance, row, steps, shared):
        self.asked.append((instance, row, steps, shared))
        return resident(shared)

    def vt_frame_launch(self, plan, arena, old_color, old_blend, old_depth,
                        reproject, keep_linear, stream):
        block = np.ctypeslib.as_array(
            (ctypes.c_int64 * len(direct.SLOTS)).from_address(plan))
        slot = dict(zip(direct.SLOTS, block.tolist()))
        row = np.ctypeslib.as_array(
            (ctypes.c_float * params.ROW_LEN).from_address(slot["row"]))
        size = slot["at_linear"] + (
            3 * 4 * slot["height"] * slot["width"]
            if keep_linear or slot["radius"] else 0)
        ctypes.memset(arena, len(self.calls) + 1, size)
        self.calls.append({
            "reproject": reproject,
            "stages": list(direct.frame_launches(bool(reproject),
                                                 slot["radius"])),
            "row": row.copy(), "arena": arena, "keep_linear": keep_linear,
            "history": (old_color, old_blend, old_depth)})
        return 0


def resident(shared: int) -> int:
    """The stand-in's resident warps: fewer blocks of 8 warps for a
    larger tile, as on the card."""
    return 8 * min(8, 228 * 1024 // (shared + 1024))


@pytest.fixture
def fake(monkeypatch):
    """The direct path on CPU tensors, by the stand-in library."""
    lib = FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(denoise_op, "_RESIDENT", {})
    monkeypatch.setattr(direct, "engages", lambda device: True)
    monkeypatch.setattr(direct, "_stream", lambda index: 0)
    return lib


def _renderer(radius=0):
    return Renderer(scene=load_scene("8x8x8"), height=12, width=16,
                    device="cpu", denoise_radius=radius, lean=True)


def _recording_stages(log):
    """The package's stages, each logging its name and the row slice (or
    row) it was given by value."""

    def trace(tables, p, noise, frame, h, w):
        log.append(("trace", np.array(p), frame))
        return trace_op.render_sample(tables, p, noise, frame, h, w)

    def temporal(*a):
        log.append(("temporal", np.array(a[-1])))
        return temporal_op.temporal_blend_reproject(*a)

    def denoise(*a):
        log.append(("denoise", np.array(a[-2])))
        return denoise_op.denoise(*a)

    def still(*a, **k):
        log.append(("still_epilogue", np.array(a[7])))
        return epilogue_op.still_epilogue(*a, **k)

    def encode(*a):
        log.append(("encode", np.array(a[4])))
        return epilogue_op.encode(*a)

    return dict(trace=trace, temporal=temporal, denoise=denoise,
                still_epilogue=still, encode=encode)


@pytest.mark.parametrize("radius", [0, 2, 8])
def test_plan_launches_frame_stages_by_the_same_rows(fake, radius):
    """First frame, still, reprojecting and still again: the native
    call's flag gives the kernels ``frame_stages`` runs with recording
    stages, in order, and the plan's row holds each stage's slice, bit
    for bit; the wrappers' launches and ``frames.direct`` grow by
    them, and ``denoise.resident_warps`` by the plan's warps a denoise
    launch."""
    log = []
    stages = _recording_stages(log)
    eager = _renderer(radius)
    fast = _renderer(radius)
    for i, pose in enumerate(POSES):
        log.clear()
        eager_render(eager, pose, **stages)
        before = counters()
        fast.render(pose)
        grown = {k: v - before[k] for k, v in counters().items()}
        call = fake.calls[i]
        assert call["reproject"] == (i == 2)
        assert call["stages"] == [entry[0] for entry in log]
        assert call["stages"] == list(direct.frame_launches(
            i == 2, radius))
        assert grown["frames.direct"] == 1
        want = collections.Counter(entry[0] for entry in log)
        assert {k.split(".")[1]: n for k, n in grown.items()
                if k.startswith("launches.") and n} == dict(want)
        assert grown["denoise.resident_warps"] == want["denoise"] * (
            fast._plan.dn_warps)
        row = call["row"]
        for name, got, *rest in log:
            if name == "trace":
                want_p = row[params.ROW_TRACE:params.ROW_FRAME]
                assert rest[0] == row[params.ROW_FRAME:].view(np.int32)[0]
            elif name == "temporal":
                want_p = row[params.ROW_TEMPORAL:params.ROW_DENOISE]
            elif name == "denoise":
                want_p = row[params.ROW_DENOISE:params.ROW_KEEP_SAMPLE]
            else:
                want_p = row
            assert got.tobytes() == want_p.tobytes(), name
        assert fast.frame_number == eager.frame_number
        assert fast.still_sample == eager.still_sample


def test_pack_is_pack_frame_rows():
    """The plan's one-camera row, with its kept constant row and old
    inverse, is ``pack_frame_rows``' row bit for bit, frame after
    frame, history or none."""
    plan = direct.FramePlan.__new__(direct.FramePlan)
    plan.row = np.zeros(params.ROW_LEN, np.float32)
    plan._params, plan._inverse = None, (None, None)
    rp, tp, dp = (params.RenderParams(), params.TemporalParams(),
                  params.DenoiseParams(sigma_distance=3.0))
    rng = np.random.default_rng(15)
    state = {"old_cam": np.zeros((4, 3), np.float32), "history_valid": False}
    cam = POSE_A.rows(16, 12)
    for frame in range(1, 40):
        if rng.random() < 0.5:
            cam = Camera(position=rng.normal(size=3) * 4,
                         direction=rng.normal(size=3)).rows(16, 12)
        plan.pack(cam, state, frame, rp, tp, dp)
        want = params.pack_frame_rows([cam], state["old_cam"],
                                      state["history_valid"], frame, rp, tp,
                                      dp)[0]
        assert plan.row.tobytes() == want.tobytes()
        state = {"old_cam": cam, "history_valid": rng.random() < 0.9}


@pytest.mark.parametrize("radius", [0, 2, 8])
@pytest.mark.parametrize("lean", [True, False])
def test_outputs_and_state_are_new_views_laid_out_as_the_eager_ones(
        fake, radius, lean):
    """Outputs and state have the eager frame's keys, shapes, types and
    strides (the image those of the CUDA encode's fresh (H, W, 3) tensor;
    the plain encode returns a view of planar bytes); each frame's arena
    is new, its views lie inside it, and a state held from one frame
    keeps its values through the next (the stand-in fills each arena
    with its call's number)."""
    eager = _renderer(radius)
    fast = _renderer(radius)
    held = []
    for i, pose in enumerate(POSES):
        want = eager_render(eager, pose, lean)
        got = fast.render(pose, lean=lean)

        def layout(d):
            return {k: (tuple(v.shape), v.dtype, v.stride())
                    if torch.is_tensor(v) else type(v) for k, v in d.items()}

        assert got["image"].is_contiguous()
        got_layout, want_layout = layout(got), layout(want)
        assert got_layout.pop("image")[:2] == want_layout.pop("image")[:2]
        assert got_layout == want_layout
        assert layout(fast.state) == layout(eager.state)
        assert fast.state.keys() == eager.state.keys()
        np.testing.assert_array_equal(fast.state["old_cam"],
                                      eager.state["old_cam"])
        assert fast.state["history_valid"] is True
        call = fake.calls[i]
        assert bool(call["keep_linear"]) == (not lean)
        base = call["arena"]
        storages = {v.untyped_storage().data_ptr()
                    for v in (*got.values(), fast.state["accum_color"],
                              fast.state["accum_blend"])}
        assert storages == {base}
        assert all(v.data_ptr() >= base for v in got.values())
        held.append((i + 1, dict(fast.state), got["image"]))
        if i:  # the history read is the previous frame's state
            prev = held[-2][1]
            assert call["history"] == tuple(
                prev[k].data_ptr() for k in pipeline.STATE_PLANES)
    assert len({c["arena"] for c in fake.calls}) == len(POSES)
    for number, state, image in held:
        for k in pipeline.STATE_PLANES:
            assert (state[k].contiguous().view(torch.uint8) == number).all()
        assert (image == number).all()


def test_a_plan_is_built_again_where_its_configuration_changes(
        fake, monkeypatch):
    """Resize, a scene swap, new denoise parameters, a hot-reload's hook
    (which drops the plan) and a reloaded library each give a new plan;
    nothing else does."""
    r = _renderer(2)
    r.render(POSE_A)
    plans = [r._plan]

    def step(change):
        change()
        r.render(POSE_B)
        plans.append(r._plan)
        return plans[-1] is not plans[-2]

    assert not step(lambda: None)
    assert not step(r.reset_accumulation)
    assert step(lambda: r.resize(10, 20))
    assert step(lambda: r.set_scene(load_scene("3x3x3")))
    assert step(lambda: setattr(r, "denoise_params",
                                params.DenoiseParams(sigma_distance=3.0)))
    assert not step(lambda: setattr(r, "render_params",
                                    params.RenderParams(sun_yaw=0.5)))

    assert step(reload.renderer_hook(r))
    other = FakeLibrary()
    assert step(lambda: monkeypatch.setattr(_build, "load", lambda: other))
    assert other.calls and r._plan.lib is other
    assert plans[-1].height == 10 and plans[-1].width == 20


def test_the_plan_engages_by_device_alone(fake, monkeypatch):
    """A CUDA device always takes the direct path and the CPU never
    does; ``frames.direct`` grows only where it is taken."""
    r = _renderer(0)
    before = counters()["frames.direct"]
    r.render(POSE_A)  # the stand-in engages on these CPU tensors
    assert len(fake.calls) == 1
    assert counters()["frames.direct"] == before + 1
    monkeypatch.undo()  # the real engages()
    assert direct.engages(torch.device("cuda"))
    assert direct.engages(torch.device("cuda", 1))
    assert not direct.engages(torch.device("cpu"))
    r.render(POSE_B)
    plain = _renderer(0)
    plain.render(POSE_A)
    assert len(fake.calls) == 1 and plain._plan is None
    assert counters()["frames.direct"] == before + 1


def test_a_profiled_direct_frame_opens_its_spans(fake):
    """Under the profiler a direct frame opens ``vt.render``, then
    ``vt.render.pack`` and ``vt.render.launch`` inside it, in turn, and
    no stage span."""
    from torch.autograd import DeviceType

    r = _renderer(2)
    r.render(POSE_A)
    with torch.autograd.profiler.profile(use_kineto=True) as prof:
        r.render(POSE_B)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.function_events
                   if e.device_type == DeviceType.CPU
                   and e.name.startswith("vt."))
    assert [n for *_, n in spans] == ["vt.render", "vt.render.pack",
                                      "vt.render.launch"]
    (r0, r1, _), (p0, p1, _), (l0, l1, _) = spans
    assert r0 <= p0 <= p1 <= l0 <= l1 <= r1


def test_the_plan_refuses_what_the_wrappers_refuse(fake):
    r = _renderer(0)
    r.render(POSE_A)
    r.state["accum_blend"] = torch.ones((12, 17))
    with pytest.raises(ValueError, match="accum_blend"):
        r.render(POSE_B)
    r.reset_accumulation()
    r.noise = r.noise.to(torch.float64)
    with pytest.raises(ValueError, match="noise"):
        r.render(POSE_A)


def test_resident_warps_are_asked_once_a_plan(fake):
    """The occupancy query's wrapper asks the library once for each
    (instance, row, shared bytes) and remembers the answer; a frame
    plan asks when it is built, for the by-value entry, and never
    again per frame; each frame's denoise launch adds the plan's warps
    to ``denoise.resident_warps``, once for each ``launches.denoise``
    it adds."""
    r8 = denoise_op.tile_plan(1080, 1920, 8)
    assert (r8.instance, r8.shared_bytes) == (8, 73_728)
    r2 = denoise_op.tile_plan(1080, 1920, 2)
    for _ in range(3):
        assert denoise_op.resident_warps(8, False, 73_728) == resident(73_728)
        assert denoise_op.resident_warps(8, True, 73_728) == resident(73_728)
        assert denoise_op.resident_warps(2, False, r2.shared_bytes) == 40
    assert fake.asked == [(8, 0, 1, 73_728), (8, 1, 1, 73_728),
                          (2, 0, 1, r2.shared_bytes)]
    assert resident(73_728) == 24

    fake.asked.clear()
    r = _renderer(8)  # 12x16 at r = 8: one tile, r8's shared bytes
    before = counters()
    for pose in POSES * 3:
        r.render(pose)
    grown = {k: v - before[k] for k, v in counters().items()}
    assert fake.asked == []  # the plan's key was asked above
    assert r._plan.dn_warps == 24
    assert grown["launches.denoise"] == len(POSES) * 3
    assert grown["denoise.resident_warps"] == 24 * grown["launches.denoise"]

    r0 = _renderer(0)
    before = counters()
    r0.render(POSE_A)
    grown = {k: v - before[k] for k, v in counters().items()}
    assert grown["denoise.resident_warps"] == grown["launches.denoise"] == 0
    r.resize(40, 70)  # a new plan with r8's tile: nothing asked
    r.render(POSE_A)
    assert fake.asked == []


@pytest.mark.parametrize("sigma, radius, steps, counted", [
    (1.5, 8, 1, 1), (1.5, 2, 1, 1), (2.75, 2, 2, 0), (1.5, 0, 0, 0)])
def test_plan_passes_the_range_reciprocal_and_counts_it(
        fake, sigma, radius, steps, counted):
    """The plan block holds ``range_reciprocal``'s float32 bits and steps,
    and each frame adds its denoise launch to
    ``denoise.reciprocal_launches`` where that takes one correction."""
    r = Renderer(scene=load_scene("8x8x8"), height=12, width=16,
                 device="cpu", denoise_radius=radius, lean=True,
                 denoise_params=params.DenoiseParams(sigma_range=sigma))
    before = counters()
    for pose in POSES:
        r.render(pose)
    grown = {k: v - before[k] for k, v in counters().items()}
    slot = dict(zip(direct.SLOTS, r._plan.block.tolist()))
    assert slot["dn_steps"] == steps
    if radius:
        y = denoise_op.range_reciprocal(sigma).y
        assert slot["dn_recip"] == int(np.float32(y).view(np.uint32))
    assert r._plan.dn_reciprocal == counted
    assert grown["launches.denoise"] == (len(POSES) if radius else 0)
    assert grown["denoise.reciprocal_launches"] == len(POSES) * counted


def test_frame_cu_reads_the_plan_and_stages_in_this_order():
    """``csrc/frame.cu``'s ``Slot`` enum is ``direct.SLOTS``, and its
    frame calls the kernels' entries in ``direct.frame_launches`` order
    for every flag and radius."""
    with open(FRAME_CU) as f:
        src = f.read()
    slots = re.search(r"enum Slot \{([^}]*)\}", src).group(1)
    names = [s.strip().lower() for s in slots.split(",") if s.strip()]
    assert names == [*direct.SLOTS, "n_slots"]
    body = src[src.index("int frame("):src.index('extern "C" int vt_frame')]
    calls = re.findall(r"rc = vt_(\w+)_launch\(", body)
    assert calls == ["trace", "still_epilogue", "temporal", "denoise",
                     "encode"]
    for reproject in (False, True):
        for radius in (0, 2, 8):
            want = direct.frame_launches(reproject, radius)
            assert [c for c in calls if c in want] == list(want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scene, width, height, radius", [
    ("menger", 1280, 720, 0), ("monu9", 1920, 1080, 2),
    ("monu9", 1920, 1080, 8)])
def test_direct_and_eager_frames_are_bit_equal_on_the_card(
        cuda, scene, width, height, radius):
    """A seeded 64-frame orbit with holds and moves: every output and
    state plane of the direct path is the eager stages' (a
    ``render_frame`` loop), bit for bit, and both launch the same
    kernels; only the direct path counts ``frames.direct``."""
    from voxtracer_torch.app.renderbench import direct_against_eager

    got = direct_against_eager(scene, width, height, radius, turns=1)
    assert got["n_differ"] == 0, got["differ"]
    fast, eager = got["counts"]["direct"], got["counts"]["eager"]
    assert fast["frames.direct"] == 64 and "frames.direct" not in eager

    def launches(counts):
        return {k: n for k, n in counts.items() if k.startswith("launches.")}

    assert launches(fast) == launches(eager)
    assert fast["launches.trace"] == 64


@pytest.mark.cuda
def test_resident_warps_on_the_card(cuda):
    """The occupancy query on the card: whole blocks of 8 warps, no more
    than an SM's 64; r = 8's 73,728-byte tile leaves room for 3 blocks
    at most, and r = 2's 41,472 bytes for at least as many; an eager
    launch adds its plan's warps to ``denoise.resident_warps``."""
    warps = {}
    for radius in (1, 2, 4, 8, 12, 30):
        plan = denoise_op.tile_plan(1080, 1920, radius)
        for row in (False, True):
            n = denoise_op.resident_warps(plan.instance, row,
                                          plan.shared_bytes)
            assert 0 < n <= 64 and n % 8 == 0, (radius, row, n)
            warps[radius, row] = n
    assert warps[8, False] <= 24 and warps[8, True] <= 24
    assert warps[2, False] >= warps[8, False]
    planes = [torch.rand((3, 37, 19), device=cuda),
              torch.rand((3, 37, 19), device=cuda),
              torch.rand((37, 19), device=cuda) + 1,
              torch.rand((3, 37, 19), device=cuda),
              torch.zeros((37, 19), dtype=torch.int32, device=cuda)]
    dp = params.pack_denoise_params(POSE_A.rows(19, 37),
                                    params.DenoiseParams())
    before = counters()
    denoise_op.denoise_cuda(*planes, dp, 8)
    torch.cuda.synchronize()
    grown = {k: v - before[k] for k, v in counters().items()}
    plan = denoise_op.tile_plan(37, 19, 8)
    assert grown["launches.denoise"] == 1
    assert grown["denoise.resident_warps"] == denoise_op.resident_warps(
        plan.instance, False, plan.shared_bytes) == warps[8, False]
