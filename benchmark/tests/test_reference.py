"""The benchmark's plain reference against the port's plain versions
(its CPU path) on small frames, and the control against the limits."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.reference import frame as ref_frame
from benchmark.reference import noise as ref_noise
from benchmark.reference import tables as ref_tables
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.params import RenderParams, pack_trace_params
from voxtracer_torch.engine.pipeline import Renderer
from voxtracer_torch.engine.scene import SceneTables, load_scene
from voxtracer_torch.ops import trace as trace_op

H = W = 64
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def noise():
    return torch.from_numpy(ref_noise.blue_noise_buffer())


@pytest.mark.parametrize("scene", ["menger", "monu9", "chr_knight"])
def test_tables_equal_the_programs(scene):
    ours = ref_tables.load_grid(scene).device_tables()
    theirs = load_scene(scene).device_tables()
    for k in ours:
        assert np.array_equal(np.asarray(ours[k]), np.asarray(theirs[k])), k


def _poses(scene):
    """A move, a hold of two frames, two more moves."""
    wmin, wmax = ref_tables.world_bounds(scene)
    c = (wmin + wmax) / 2
    r = float(np.linalg.norm(wmax - wmin)) / 2
    out = []
    for a in (0.3, 0.3, 0.3, 0.34, 0.38):
        pos = c + 1.7 * r * np.array([np.cos(a), 0.4, np.sin(a)])
        out.append((pos, c - pos))
    return out


@pytest.mark.parametrize("scene,radius", [("menger", 0), ("monu9", 2)])
def test_frames_equal_the_programs(scene, radius, noise):
    r = Renderer(scene=load_scene(scene), height=H, width=W, device="cpu",
                 denoise_radius=radius, lean=True)
    state = dict(r.state)
    poses = _poses(scene)
    images, states = [], []
    for pos, d in poses:
        images.append(r.render(Camera(position=pos, direction=d))["image"])
        states.append(dict(r.state))
    tables = ref_tables.Tables(ref_tables.load_grid(scene), "cpu")
    cams = [ref_frame.camera_rows(p, d, W, H) for p, d in poses]
    traces = ref_frame.trace_batch(tables, noise, cams,
                                   list(range(1, len(poses) + 1)), H, W)
    ref_images, ref_states = ref_frame.render_frames(
        tables, noise, state, cams, list(range(1, len(poses) + 1)), radius,
        traces=traces)
    for a, b in zip(images, ref_images):
        assert torch.equal(a, b)
    for a, b in zip(states, ref_states):
        for k in ref_frame.STATE_PLANES:
            assert torch.equal(a[k], b[k])
    # the work the reference counts is the port's plain trace's
    prog_tables = SceneTables(load_scene(scene), "cpu")
    for i, (cam, g) in enumerate(zip(cams, traces)):
        prog = trace_op.render_sample_plain(
            prog_tables, pack_trace_params(cam, RenderParams()), noise, i + 1,
            H, W)
        assert torch.equal(g["steps"], prog["steps"])
        assert torch.equal(g["rays"], prog["rays"])


def test_burst_pixels_equal_the_programs_burst(noise):
    r = Renderer(scene=load_scene("menger"), height=H, width=W, device="cpu")
    pos, d = np.array([36.0, 34.0, -5.0]), np.array([-16.0, -14.0, 25.0])
    cam = Camera(position=pos, direction=d)
    r.render(cam)
    before, first = dict(r.state), r.frame_number + 1
    image = r.render_burst(cam, 6)
    idx = torch.randperm(H * W, generator=torch.Generator().manual_seed(3))[:500]
    state = {k: before[k].reshape(*before[k].shape[:-2], -1)[..., idx]
             for k in ref_frame.STATE_PLANES}
    state.update(old_cam=before["old_cam"], history_valid=True)
    tables = ref_tables.Tables(ref_tables.load_grid("menger"), "cpu")
    ref_img, ref_state = ref_frame.burst_pixels(
        tables, noise, state, ref_frame.camera_rows(pos, d, W, H),
        range(first, first + 6), idx // W, idx % W)
    assert torch.equal(ref_img, image.reshape(-1, 3)[idx])
    assert check.state_off(r.state, ref_state, idx) == 0.0


@pytest.mark.parametrize("cell", ["menger720-r0.view", "monu9-1080-r2.view",
                                  "monu9-1080-r2.export"])
def test_control_fails_the_limits(cell, noise):
    """The reference in bfloat16 in the program's place, at 64x64: one
    of the cell's numbers beyond its limit."""
    with open(os.path.join(BENCH, "workloads", cell + ".json")) as f:
        wl = json.load(f)
    with open(os.path.join(BENCH, "configs", wl["config"] + ".json")) as f:
        cfg = json.load(f)
    scene, radius = cfg["scene"], cfg["denoise_radius"]
    r = Renderer(scene=load_scene(scene), height=H, width=W, device="cpu",
                 denoise_radius=radius, lean=True)
    poses = _poses(scene)
    r.render(Camera(position=poses[0][0], direction=poses[0][1]))
    snap = _Snap(dict(r.state), poses[1:3], 2, poses[0])
    tables = ref_tables.Tables(ref_tables.load_grid(scene), "cpu")
    cams, frames = check.frame_jobs(snap, W, H)
    traces = ref_frame.trace_batch(tables, noise, cams, frames, H, W)
    got = check.compare_frames(tables, noise, snap, radius, traces,
                               lowp=True)
    limits = wl["check"]["limits"]
    assert any(got[k] > limits[k] for k in limits), got


class _Snap:
    def __init__(self, state_before, cams, first_frame, prev_pose):
        self.state_before = state_before
        self.cams = cams
        self.first_frame = first_frame
        self.prev_pose = prev_pose
