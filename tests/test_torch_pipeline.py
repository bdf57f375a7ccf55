"""The port's main path as a whole — ``Renderer(device="cpu")``, still
camera, denoise radius 0 — against the JAX package's Renderer, plus the
boundaries of what is ported and the CLI."""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from voxtracer.engine.camera import Camera as JCamera
from voxtracer.engine.pipeline import Renderer as JRenderer
from voxtracer_torch.app import cli
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.pipeline import (
    Renderer,
    state_from_numpy,
    state_to_numpy,
)
from voxtracer_torch.engine.scene import load_scene

H, W = 48, 64
POS, DIR = (36.0, 34.0, -5.0), (-16.0, -14.0, 25.0)  # bench.py's camera
FRAMES = 4


def _jax_state(r):
    return {k: np.asarray(v) for k, v in r.state.items()}


@pytest.fixture(scope="module")
def menger():
    return load_scene("menger")


@pytest.fixture(scope="module")
def jax_run(menger):
    """The reference's XLA path: images, node ids and states per frame.
    (Its frame 1 runs the moving-camera blend with history invalid.)"""
    r = JRenderer(scene=menger, height=H, width=W, trace_impl="xla")
    cam = JCamera(position=np.array(POS), direction=np.array(DIR))
    frames = []
    for _ in range(FRAMES):
        out = r.render(cam)
        frames.append(dict(
            image=np.asarray(out["image"]), node=np.asarray(out["node"]),
            state=_jax_state(r),
        ))
    return frames


def _assert_frame(ref, out, state):
    """Parity bar for a whole frame against the XLA path: node ids
    exact; history depth 1e-5 (the XLA twin is a dense-grid DDA whose
    hit t differs by ulps); accumulated color 1e-5 and blend exact
    (measured 2.4e-7 and 0); u8 image at most 1 code value at 3 of the
    64x48 pixels (measured identical)."""
    np.testing.assert_array_equal(out["node"].numpy(), ref["node"])
    got = state_to_numpy(state)
    want = ref["state"]
    hit = want["old_depth"] >= 0
    np.testing.assert_array_equal(got["old_depth"] >= 0, hit)
    np.testing.assert_allclose(got["old_depth"][hit], want["old_depth"][hit],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["accum_color"], want["accum_color"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["accum_blend"], want["accum_blend"])
    np.testing.assert_array_equal(got["old_cam"], want["old_cam"])
    assert bool(got["history_valid"]) == bool(want["history_valid"])
    img = out["image"].numpy()
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    diff = np.abs(img.astype(int) - ref["image"].astype(int))
    assert diff.max() <= 1 and int((diff > 0).any(-1).sum()) <= 3


def test_still_frames_match_jax_renderer(menger, jax_run):
    r = Renderer(scene=menger, height=H, width=W, device="cpu")
    cam = Camera(position=np.array(POS), direction=np.array(DIR))
    for f, ref in enumerate(jax_run):
        out = r.render(cam)
        _assert_frame(ref, out, r.state)
        if f == 0:
            # frame 1: no history, so the blend is the fresh sample
            np.testing.assert_array_equal(
                r.state["accum_color"].numpy(),
                np.moveaxis(out["trace_color"].numpy(), -1, 0),
            )
    assert r.frame_number == FRAMES and r.still_sample == FRAMES
    assert out["rays"][0].item() == H * W


def test_jax_state_carries_over(menger, jax_run):
    """The reference's state after frame 2, loaded into the port, gives
    the reference's frame 3."""
    r = Renderer(scene=menger, height=H, width=W, device="cpu")
    r.state = state_from_numpy(jax_run[1]["state"], "cpu")
    r.frame_number = 2
    out = r.render(Camera(position=np.array(POS), direction=np.array(DIR)))
    _assert_frame(jax_run[2], out, r.state)
    back = state_to_numpy(state_from_numpy(jax_run[1]["state"], "cpu"))
    for k, v in jax_run[1]["state"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def _small(device="cpu", **kw):
    return Renderer(scene=load_scene("8x8x8"), height=12, width=16,
                    device=device, **kw)


CAM = Camera(position=np.array([2.0, 3.0, -4.0]),
             direction=np.array([0.2, 0.1, 1.0]))


def test_moved_camera_with_history_is_not_ported():
    r = _small()
    r.render(CAM)
    moved = Camera(position=np.array([2.0, 3.0, -4.5]),
                   direction=np.array([0.2, 0.1, 1.0]))
    with pytest.raises(NotImplementedError, match="Queue 1 #5"):
        r.render(moved)
    assert r.frame_number == 1 and r.still_sample == 1
    # restarting accumulation makes the new pose a first frame again
    r.reset_accumulation()
    r.render(moved)
    assert r.frame_number == 2 and r.still_sample == 1
    r.render(moved)
    assert r.still_sample == 2


def test_denoise_radius_is_not_ported():
    with pytest.raises(NotImplementedError, match="denoise"):
        _small(denoise_radius=2).render(CAM)


def test_cuda_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="cuda"):
        _small(device="cuda")


def test_resize_and_set_scene_restart_accumulation():
    r = _small()
    r.render(CAM)
    r.resize(10, 20)
    assert r.state["accum_color"].shape == (3, 10, 20)
    assert not r.state["history_valid"] and r.still_sample == 0
    out = r.render(CAM)
    assert out["image"].shape == (10, 20, 3)
    r.set_scene(load_scene("3x3x3"))
    assert not r.state["history_valid"]
    out = r.render(CAM)
    assert r.frame_number == 3 and r.still_sample == 1
    with pytest.raises(ValueError):
        r.resize(0, 20)


def test_cli_writes_png(tmp_path):
    path = os.path.join(tmp_path, "frame.png")
    rc = cli.main(["--device", "cpu", "--scene", "8x8x8", "--size",
                   "24x16", "--frames", "2", "--camera-pos", "2,3,-4",
                   "--camera-dir", "0.2,0.1,1", "-o", path])
    assert rc == 0
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    width, height = struct.unpack(">II", data[16:24])
    assert (width, height) == (24, 16)
    # RGB rows, each behind a filter byte, in one IDAT chunk
    idat = data.index(b"IDAT")
    n = struct.unpack(">I", data[idat - 4:idat])[0]
    rows = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + n]),
                         np.uint8).reshape(16, 1 + 24 * 3)
    assert rows[:, 1:].std() > 0


@pytest.mark.parametrize(
    "flags",
    [["--denoise-radius", "2"], ["--path", "orbit"], ["--legacy-whitted"],
     ["--save-snapshot", "s.npz"]],
)
def test_cli_refuses_what_is_not_ported(flags):
    with pytest.raises(SystemExit, match="not yet ported"):
        cli.main(["--device", "cpu", "--scene", "8x8x8", *flags])


@pytest.mark.slow
def test_first_frames_match_pallas_interpret_renderer():
    """Against the Pallas kernels themselves, interpreted: frame 1 runs
    the fused moving-camera temporal kernel with history invalid, frame
    2 the still blend.  Interpret mode's XLA code contracts FMAs, so the
    trace agrees to the Pallas suite's own bounds, not bit for bit."""
    scene = load_scene("8x8x8")
    jr = JRenderer(scene=scene, height=32, width=32,
                   trace_impl="pallas_interpret")
    r = Renderer(scene=scene, height=32, width=32, device="cpu")
    jcam = JCamera(position=np.array([2.0, 3.0, -4.0]),
                   direction=np.array([0.2, 0.1, 1.0]))
    cam = Camera(position=jcam.position, direction=jcam.direction)
    for _ in range(2):
        ref = jr.render(jcam)
        out = r.render(cam)
        agree = np.asarray(ref["node"]) == out["node"].numpy()
        assert agree.mean() > 0.999
        diff = np.abs(np.asarray(ref["image"]).astype(int)
                      - out["image"].numpy().astype(int))
        assert (diff[agree] <= 1).mean() > 0.995
        np.testing.assert_allclose(
            state_to_numpy(r.state)["accum_blend"],
            np.asarray(jr.state["accum_blend"]),
        )
