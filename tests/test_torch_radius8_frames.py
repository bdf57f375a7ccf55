"""The frame path at the denoiser's largest radius, 8 (the upstream
GUI's slider runs 0-8; the 17x17 cross-bilateral stencil), against the
benchmark's plain reference (``benchmark/reference``), bit for bit: a
first frame, a moved frame that reprojects its history and a held frame
that takes the still blend, on ``monu9`` at a size whose width and
height are no multiple of the kernel's 32x32 tile, so that border tiles
and their 8-wide halos are used.  No other tier-1 frame test denoises
past radius 2."""

import numpy as np
import torch

from benchmark.reference import frame as ref_frame
from benchmark.reference import noise as ref_noise
from benchmark.reference import stages as ref_stages
from benchmark.reference import tables as ref_tables
from benchmark.reference.params import pack_denoise_params
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.pipeline import Renderer
from voxtracer_torch.engine.scene import load_scene

H, W = 45, 70
RADIUS = 8


def _poses():
    """Outside the scene looking at its centre: a pose, a move, and the
    moved pose held."""
    wmin, wmax = ref_tables.world_bounds("monu9")
    c = (wmin + wmax) / 2
    r = float(np.linalg.norm(wmax - wmin)) / 2
    out = []
    for a in (0.3, 0.34, 0.34):
        pos = c + 0.8 * r * np.array([np.cos(a), 0.4, np.sin(a)])
        out.append((pos, c - pos))
    return out


def test_radius8_frames_equal_the_reference():
    assert H % 32 and W % 32 and H > 2 * RADIUS and W > 2 * RADIUS
    r = Renderer(scene=load_scene("monu9"), height=H, width=W, device="cpu",
                 denoise_radius=RADIUS)
    state = dict(r.state)
    poses = _poses()
    images, states, outputs = [], [], []
    for pos, d in poses:
        outputs.append(r.render(Camera(position=pos, direction=d)))
        images.append(outputs[-1]["image"])
        states.append(dict(r.state))
    # the scene fills much of the frame, and its edges meet the sky
    hits = (states[0]["old_depth"] > 0).float().mean()
    assert 0.2 < hits < 0.95, hits
    # the moved frame reprojects (its blend restarts where history is
    # lost), the held one accumulates
    blends = [s["accum_blend"] for s in states]
    assert not torch.equal(blends[1], blends[0])
    assert (blends[2] <= blends[1]).all() and (blends[2] < blends[1]).any()

    tables = ref_tables.Tables(ref_tables.load_grid("monu9"), "cpu")
    noise = torch.from_numpy(ref_noise.blue_noise_buffer())
    cams = [ref_frame.camera_rows(p, d, W, H) for p, d in poses]
    ref_images, ref_states = ref_frame.render_frames(
        tables, noise, state, cams, [1, 2, 3], RADIUS)
    for a, b in zip(images, ref_images):
        assert torch.equal(a, b)
    for a, b in zip(states, ref_states):
        for k in ref_frame.STATE_PLANES:
            assert torch.equal(a[k], b[k]), k
    # the denoise's float output is the reference stencil's at radius 8,
    # bit for bit, and not radius 7's, whose outer ring weighs too little
    # to move a u8 value by more than one
    for cam, out, st in zip(cams, outputs, states):
        planes = [torch.movedim(out[k], -1, 0).contiguous()
                  for k in ("normal", "albedo")]
        args = (st["accum_color"], planes[0], out["depth"], planes[1],
                out["node"], pack_denoise_params(cam, ref_frame.DP))
        linear = torch.movedim(out["linear"], -1, 0)
        assert torch.equal(linear, ref_stages.denoise(*args, RADIUS))
        assert not torch.equal(linear, ref_stages.denoise(*args, RADIUS - 1))
