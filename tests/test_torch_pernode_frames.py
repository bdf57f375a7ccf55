"""The frame path on the per-node brick layout (2 planes, the uniform
slot in the meta word: the procedural bowl's from a radius of about 128
on, the full-size default scene's) against the benchmark's plain
reference (``benchmark/reference``), bit for bit: a first frame, a
moved frame that reprojects its history and a held frame that takes the
still blend, at radius 2.  Every shipped asset takes the dedup layout,
so no other tier-1 test reaches this one's trace branch."""

import numpy as np
import torch

from benchmark.reference import frame as ref_frame
from benchmark.reference import grid as ref_grid
from benchmark.reference import noise as ref_noise
from benchmark.reference import procedural as ref_procedural
from benchmark.reference import tables as ref_tables
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.pipeline import Renderer
from voxtracer_torch.scene import GridScene, default_scene

H, W = 48, 64
BOWL_RADIUS = 128  # past the brick dedup's cap (96 still dedups)


def _poses(scene):
    """Above the bowl looking into it (nine in ten pixels hit): a pose,
    a move, and the moved pose held."""
    wmin, wmax = scene.world_min(), scene.world_max()
    c = (wmin + wmax) / 2
    r = float(np.linalg.norm(wmax - wmin)) / 2
    out = []
    for a in (0.3, 0.34, 0.34):
        pos = c + 0.6 * r * np.array([np.cos(a), 1.0, np.sin(a)])
        out.append((pos, c - pos))
    return out


def test_per_node_frames_equal_the_reference():
    scene = GridScene.from_voxels(default_scene(BOWL_RADIUS))
    r = Renderer(scene=scene, height=H, width=W, device="cpu",
                 denoise_radius=2, lean=True)
    assert not r.tables.brick_dedup
    state = dict(r.state)
    poses = _poses(scene)
    images, states = [], []
    for pos, d in poses:
        images.append(r.render(Camera(position=pos, direction=d))["image"])
        states.append(dict(r.state))
    assert (states[-1]["old_depth"] > 0).float().mean() > 0.8

    tables = ref_tables.Tables(ref_grid.GridScene.from_voxels(
        ref_procedural.default_scene(BOWL_RADIUS)), "cpu")
    assert not tables.brick_dedup
    noise = torch.from_numpy(ref_noise.blue_noise_buffer())
    cams = [ref_frame.camera_rows(p, d, W, H) for p, d in poses]
    ref_images, ref_states = ref_frame.render_frames(
        tables, noise, state, cams, [1, 2, 3], 2)
    for a, b in zip(images, ref_images):
        assert torch.equal(a, b)
    for a, b in zip(states, ref_states):
        for k in ref_frame.STATE_PLANES:
            assert torch.equal(a[k], b[k]), k
