"""The sweeping sun's cell (``castle4k-r0.sun``): it is the port's BASELINE
config 5 (``app/bench.py`` ``config5_castle_4k``: castle at 3840x2160,
the ``camera_paths.static`` pose held, the sun's yaw ``1.32 + 0.05 * i``
before frame ``i``), the reference renders each frame at its own sun, and
the control (the reference in bfloat16 in the program's place) fails the
cell's limits."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.harness import load_json
from benchmark.reference import frame as ref_frame
from benchmark.reference import noise as ref_noise
from benchmark.reference import tables as ref_tables
from benchmark.reference.params import pack_trace_params
from benchmark.reference.trace import trace_rays
from benchmark.traffic import Traffic
from voxtracer_torch.app import camera_paths
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.pipeline import Renderer
from voxtracer_torch.engine.scene import load_scene

from .conftest import ROOT
from .test_reference import _poses, _Snap

CELL = "castle4k-r0.sun"
H = W = 64
FRAMES = 4000  # 200 rad of yaw: past any wrap of the trig's argument


def _cell():
    wl = load_json(ROOT, "benchmark", "workloads", CELL + ".json")
    return wl, load_json(ROOT, "benchmark", "configs", wl["config"] + ".json")


def _traffic(seed=2**31 + 11):
    wl, cfg = _cell()
    return Traffic(wl["traffic"], cfg["world_min"], cfg["world_max"], seed)


@pytest.fixture(scope="module")
def noise():
    return torch.from_numpy(ref_noise.blue_noise_buffer())


def test_config_is_the_ports_config5():
    """Castle at 3840x2160, radius 0, whole (``reduced`` empty), framed by
    its grid's bounds."""
    _, cfg = _cell()
    assert (cfg["scene"], cfg["width"], cfg["height"],
            cfg["denoise_radius"], cfg["reduced"]) == (
                "castle", 3840, 2160, 0, [])
    wmin, wmax = ref_tables.world_bounds("castle")
    assert cfg["world_min"] == wmin.tolist()
    assert cfg["world_max"] == wmax.tolist()
    entry, = [c for c in load_json(ROOT, "BENCHMARK.json")["configs"]
              if c["name"] == cfg["name"]]
    assert entry["file"] == f"benchmark/configs/{cfg['name']}.json"


def test_pose_is_the_static_pose_held():
    """Every frame at ``camera_paths.static(castle)(0.0)``, bit for bit,
    and at 3840x2160 the same camera rows; no frame after the first
    moves."""
    cam = camera_paths.static(load_scene("castle"))(0.0)
    tr = _traffic()
    for i in (0, 1, 2, 3, 999, FRAMES):
        pos, d = tr.camera(i)
        assert np.array_equal(pos, cam.position)
        assert np.array_equal(d, cam.direction)
        assert np.array_equal(
            ref_frame.camera_rows(pos, d, 3840, 2160),
            Camera(position=pos, direction=d).rows(3840, 2160))
    assert tr.moving(0)
    assert not any(tr.moving(i) for i in range(1, FRAMES))


def test_sun_is_config5s_sweep():
    """Frame ``i``'s yaw is config 5's ``1.32 + 0.05 * i`` in float64,
    whatever the seed; the rest of the lighting is the default."""
    for seed in (3, 2**31 + 11):
        tr = _traffic(seed)
        for i in range(FRAMES):
            assert tr.sun_yaw(i) == 1.32 + 0.05 * i
    p = check.sun_params(1.32 + 0.05 * 7)
    assert p == dataclasses.replace(ref_frame.RP, sun_yaw=1.32 + 0.05 * 7)
    assert check.sun_params(None) is ref_frame.RP


def test_a_traffic_without_sun_or_hold_draws_as_before():
    """Adding ``sun`` leaves the draws of a traffic with segments alone,
    and a traffic without it has no sun."""
    wmin, wmax = ref_tables.world_bounds("menger")
    spec = {"path": {"name": "orbit", "period": 8.0}, "frame_dt": 1 / 60,
            "segments": {"min": 60, "max": 240}}
    a = Traffic(spec, wmin, wmax, 2**31 + 9)
    b = Traffic(dict(spec, sun={"yaw": 0.3, "yaw_step": 0.01}), wmin, wmax,
                2**31 + 9)
    n = 3000
    assert [a.time(i) for i in range(n)] == [b.time(i) for i in range(n)]
    assert [a.moving(i) for i in range(n)] == [b.moving(i) for i in range(n)]
    assert a.sun_yaw(5) is None and b.sun_yaw(5) == 0.3 + 0.01 * 5
    with pytest.raises(ValueError):
        Traffic(dict(spec, hold=True), wmin, wmax, 1)


def test_default_params_give_todays_single_row_call(noise):
    """``trace_batch`` with every frame at ``RP`` (given or by default)
    makes the one call the single parameter row made: the same outputs,
    bit for bit."""
    tables = ref_tables.Tables(ref_tables.load_grid("menger"), "cpu")
    h, w = 24, 32
    cams = [ref_frame.camera_rows(p, d, w, h) for p, d in _poses("menger")]
    frames = list(range(3, 3 + len(cams)))
    n = h * w
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    cam_t = torch.from_numpy(np.stack([c.reshape(12) for c in cams]))
    one = trace_rays(tables, pack_trace_params(cams[0], ref_frame.RP), noise,
                     torch.tensor(frames).repeat_interleave(n),
                     ys.reshape(n).repeat(len(cams)),
                     xs.reshape(n).repeat(len(cams)),
                     cams=cam_t.repeat_interleave(n, dim=0))
    for params in (None, [ref_frame.RP] * len(cams)):
        outs = ref_frame.trace_batch(tables, noise, cams, frames, h, w,
                                     params=params)
        for j, o in enumerate(outs):
            sl = slice(j * n, (j + 1) * n)
            for k in ("color", "normal", "albedo"):
                assert torch.equal(o[k], one[k][:, sl].reshape(3, h, w)), k
            for k in ("depth", "node"):
                assert torch.equal(o[k], one[k][sl].reshape(h, w)), k
            assert torch.equal(o["steps"],
                               one["ray_steps"][:, sl].sum(1,
                                                          dtype=torch.int64))


def test_a_call_of_many_suns_equals_a_call_a_frame(noise):
    """Frames at different suns traced in one call, each ray at its
    frame's sun, give what one call a frame gives, bit for bit."""
    tables = ref_tables.Tables(ref_tables.load_grid("castle"), "cpu")
    h, w = 24, 32
    pose = _traffic().camera(0)
    cams = [ref_frame.camera_rows(*pose, w, h)] * 4
    params = [check.sun_params(1.32 + 0.05 * i) for i in (0, 1, 2, 900)]
    frames = [5, 6, 7, 8]
    one = ref_frame.trace_batch(tables, noise, cams, frames, h, w,
                                params=params)
    each = ref_frame.trace_batch(tables, noise, cams, frames, h, w,
                                 chunk=h * w, params=params)
    for a, b in zip(one, each):
        for k in ("color", "normal", "albedo", "depth", "node", "rays",
                  "steps"):
            assert torch.equal(a[k], b[k]), k


def test_frames_at_their_suns_equal_the_programs(noise):
    """The program at the cell's held pose with the sun set before each
    frame, as the view driver sets it, against the reference at each
    frame's own sun: every image and state plane equal, and the frames'
    traces differ from the default sun's."""
    tr = _traffic()
    r = Renderer(scene=load_scene("castle"), height=H, width=W,
                 device="cpu", denoise_radius=0, lean=True)
    state = dict(r.state)
    idx = [0, 1, 2, 3, 40]
    images, states = [], []
    for i in idx:
        r.render_params = dataclasses.replace(r.render_params,
                                              sun_yaw=tr.sun_yaw(i))
        images.append(r.render(Camera(*tr.camera(i)))["image"])
        states.append(dict(r.state))
    tables = ref_tables.Tables(ref_tables.load_grid("castle"), "cpu")
    cams = [ref_frame.camera_rows(*tr.camera(i), W, H) for i in idx]
    params = [check.sun_params(tr.sun_yaw(i)) for i in idx]
    frames = list(range(1, len(idx) + 1))
    ref_images, ref_states = ref_frame.render_frames(
        tables, noise, state, cams, frames, 0, params=params)
    for a, b in zip(images, ref_images):
        assert torch.equal(a, b)
    for a, b in zip(states, ref_states):
        for k in ref_frame.STATE_PLANES:
            assert torch.equal(a[k], b[k]), k
    default = ref_frame.trace_batch(tables, noise, cams, frames, H, W)
    ours = ref_frame.trace_batch(tables, noise, cams, frames, H, W,
                                 params=params)
    assert torch.equal(default[0]["color"], ours[0]["color"])
    assert not any(torch.equal(a["color"], b["color"])
                   for a, b in zip(default[1:], ours[1:]))


def test_control_fails_the_sun_cells_limits(noise):
    """As ``test_reference.test_control_fails_the_limits``: at 64x64, two
    held frames at the traffic's suns from the program's state; one of
    the cell's numbers beyond its limit for the control, the program's
    own frames within them."""
    wl, _ = _cell()
    tr = _traffic()
    r = Renderer(scene=load_scene("castle"), height=H, width=W,
                 device="cpu", denoise_radius=0, lean=True)
    pose = tr.camera(0)
    for i in range(3):
        r.render_params = dataclasses.replace(r.render_params,
                                              sun_yaw=tr.sun_yaw(i))
        r.render(Camera(*pose))
    snap = _Snap(dict(r.state), [pose, pose], 4, pose,
                 [tr.sun_yaw(3), tr.sun_yaw(4)])
    snap.images = []
    for i in (3, 4):
        r.render_params = dataclasses.replace(r.render_params,
                                              sun_yaw=tr.sun_yaw(i))
        snap.images.append(r.render(Camera(*pose))["image"])
    snap.state_after = dict(r.state)
    tables = ref_tables.Tables(ref_tables.load_grid("castle"), "cpu")
    cams, frames, params = check.frame_jobs(snap, W, H)
    traces = ref_frame.trace_batch(tables, noise, cams, frames, H, W,
                                   params=params)
    got = check.compare_frames(tables, noise, snap, 0, traces, lowp=True)
    sound = check.compare_frames(tables, noise, snap, 0, traces)
    limits = wl["check"]["limits"]
    assert any(got[k] > limits[k] for k in limits), got
    assert all(sound[k] == 0 for k in limits), sound
