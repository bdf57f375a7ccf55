"""The port's main path as a whole — ``Renderer(device="cpu")``: the
still camera at denoise radius 0, and moving cameras at radius 0 and 2 —
against the JAX package's Renderer, plus the stage selection, the
boundaries of what is ported and the CLI (its session flags are in
``tests/test_torch_session.py``)."""

import functools
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from voxtracer.app import camera_paths as jcamera_paths
from voxtracer.engine.camera import Camera as JCamera
from voxtracer.engine.pipeline import Renderer as JRenderer
from voxtracer_torch.app import camera_paths, cli
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.pipeline import (
    Renderer,
    state_from_numpy,
    state_to_numpy,
)
from voxtracer_torch.engine.scene import load_scene
from voxtracer_torch.ops import temporal

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


# Moving cameras: closer orbits than the bench's, so that ~40% of the
# 48x64 pixels hit (the bench's own paths frame ~5-7% at this size);
# frame i at path(i / 30), as the bench and the CLI step.
MOVING = {
    "chr_knight-r0": ("chr_knight", 0.6, 0),
    "monu9-r2": ("monu9", 0.9, 2),
}
# Pinned per frame, each measured: u8 pixels more than 1 code apart,
# and accumulated-colour pixels beyond 1e-5 (+1e-5 relative).  The
# trace's colour differs from the XLA twin's beyond 1e-3 at up to 4
# monu9 pixels a frame, in image column 32, whose rays lie in the
# vertical plane through the scene centre (on frames 1 and 2 the port
# agrees with the numpy oracle at all but one of them); temporal
# reprojection and the r=2 stencil carry those into their neighbours.
# Validity flips: 0 measured in both cases.  "kept": a lower bound on
# the hit pixels whose history survived to frame 4 (measured 0.70 and
# 0.38).
MOVING_PINS = {
    "chr_knight-r0": dict(trace=0, image=(0, 0, 0, 0), color=(0, 0, 0, 0),
                          kept=0.6),
    "monu9-r2": dict(trace=4, image=(19, 20, 25, 25), color=(4, 7, 9, 12),
                     kept=0.3),
}


@functools.lru_cache(maxsize=None)
def _jax_moving(case):
    """The reference's XLA path along the orbit, per frame: outputs and
    state (every frame moves, so each runs its reprojecting blend; frame
    1 with history invalid)."""
    name, distance, radius = MOVING[case]
    scene = load_scene(name)
    r = JRenderer(scene=scene, height=H, width=W, trace_impl="xla",
                  denoise_radius=radius)
    path = jcamera_paths.orbit(scene, distance=distance)
    frames = []
    for i in range(FRAMES):
        out = r.render(path(i / 30.0))
        frames.append(dict(
            image=np.asarray(out["image"]), node=np.asarray(out["node"]),
            trace_color=np.asarray(out["trace_color"]), state=_jax_state(r),
        ))
    return frames


def _port_renderer(case):
    name, distance, radius = MOVING[case]
    scene = load_scene(name)
    return (Renderer(scene=scene, height=H, width=W, device="cpu",
                     denoise_radius=radius),
            camera_paths.orbit(scene, distance=distance))


def _assert_moving_frame(ref, out, state, pins, f):
    """Parity bar for a moving frame against the XLA path: node ids
    exact; history depth 1e-5; no validity flips; resampled blend 1e-5;
    accumulated colour 1e-5 and u8 image within 1 code except at the
    pinned counts (MOVING_PINS)."""
    np.testing.assert_array_equal(out["node"].numpy(), ref["node"])
    err = np.abs(out["trace_color"].numpy() - ref["trace_color"]).max(-1)
    assert int((err > 1e-3).sum()) <= pins["trace"]
    got = state_to_numpy(state)
    want = ref["state"]
    hit = want["old_depth"] >= 0
    np.testing.assert_array_equal(got["old_depth"] >= 0, hit)
    np.testing.assert_allclose(got["old_depth"][hit], want["old_depth"][hit],
                               rtol=1e-5, atol=1e-5)
    restart = np.float32(0.5)  # 1 - sample_blending
    np.testing.assert_array_equal(got["accum_blend"] < restart - 1e-6,
                                  want["accum_blend"] < restart - 1e-6)
    np.testing.assert_allclose(got["accum_blend"], want["accum_blend"],
                               rtol=1e-5, atol=1e-5)
    far = np.abs(got["accum_color"] - want["accum_color"]) > (
        1e-5 + 1e-5 * np.abs(want["accum_color"]))
    assert int(far.any(0).sum()) <= pins["color"][f]
    np.testing.assert_array_equal(got["old_cam"], want["old_cam"])
    assert bool(got["history_valid"]) and bool(want["history_valid"])
    diff = np.abs(out["image"].numpy().astype(int) - ref["image"].astype(int))
    assert int((diff > 1).any(-1).sum()) <= pins["image"][f]


@pytest.mark.parametrize("case", list(MOVING))
def test_moving_frames_match_jax_renderer(case):
    r, path = _port_renderer(case)
    frames = _jax_moving(case)
    for f, ref in enumerate(frames):
        out = r.render(path(f / 30.0))
        _assert_moving_frame(ref, out, r.state, MOVING_PINS[case], f)
    assert r.frame_number == FRAMES and r.still_sample == 1
    # history was kept: hit pixels accumulated over the frames
    blend = r.state["accum_blend"].numpy()
    hit = r.state["old_depth"].numpy() >= 0
    assert (blend[hit] < 0.5 - 1e-6).mean() > MOVING_PINS[case]["kept"]


@pytest.mark.parametrize("case", list(MOVING))
def test_jax_state_carries_over_a_moving_path(case):
    """The reference's state after moving frame 2, loaded into the port,
    gives the reference's frame 3 (its reprojection reads old_cam)."""
    r, path = _port_renderer(case)
    frames = _jax_moving(case)
    r.state = state_from_numpy(frames[1]["state"], "cpu")
    r.frame_number = 2
    out = r.render(path(2 / 30.0))
    _assert_moving_frame(frames[2], out, r.state, MOVING_PINS[case], 2)


def _small(device="cpu", **kw):
    return Renderer(scene=load_scene("8x8x8"), height=12, width=16,
                    device=device, **kw)


CAM = Camera(position=np.array([2.0, 3.0, -4.0]),
             direction=np.array([0.2, 0.1, 1.0]))


MOVED = Camera(position=np.array([2.0, 3.0, -4.5]),
               direction=np.array([0.2, 0.1, 1.0]))


def test_moved_camera_runs_the_reprojecting_stage(monkeypatch):
    """The reprojecting blend runs exactly on frames whose camera moved
    while history was live, with the history's camera as the old one;
    the counters follow the reference's Renderer.render."""
    calls = []
    blend = temporal.temporal_blend_reproject

    def spy(*args):
        calls.append(args[-1])
        return blend(*args)

    monkeypatch.setattr(temporal, "temporal_blend_reproject", spy)
    r = _small()
    r.render(CAM)  # frame 1: no history, the still blend
    r.render(CAM)  # at rest: the still blend
    assert calls == [] and r.still_sample == 2
    r.render(MOVED)
    assert len(calls) == 1 and r.frame_number == 3 and r.still_sample == 1
    params = calls[0]
    np.testing.assert_array_equal(params[0:12], MOVED.rows(16, 12).ravel())
    np.testing.assert_array_equal(params[12:24], CAM.rows(16, 12).ravel())
    assert params[36] == 1.0
    r.render(MOVED)
    assert len(calls) == 1 and r.still_sample == 2
    # restarting accumulation makes any pose a first frame again
    r.reset_accumulation()
    r.render(CAM)
    assert len(calls) == 1 and r.still_sample == 1 and r.frame_number == 5


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


def test_cli_renders_a_moving_path_with_denoise(tmp_path):
    path = os.path.join(tmp_path, "orbit.png")
    rc = cli.main(["--device", "cpu", "--scene", "8x8x8", "--size", "24x16",
                   "--frames", "3", "--path", "orbit", "--denoise-radius",
                   "2", "-o", path])
    assert rc == 0
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", data[16:24]) == (24, 16)


def test_cli_refuses_a_negative_denoise_radius():
    with pytest.raises(SystemExit, match="denoise-radius"):
        cli.main(["--device", "cpu", "--scene", "8x8x8", "--denoise-radius",
                  "-1"])


PORTED_MODES = [["--legacy-whitted"], ["--watch-kernels"]]


@pytest.mark.parametrize("flags", PORTED_MODES)
def test_cli_runs_the_ported_modes(flags, tmp_path):
    """``--legacy-whitted`` and ``--watch-kernels`` run on the CPU and
    write their PNG at the requested size."""
    path = os.path.join(tmp_path, "frame.png")
    rc = cli.main(["--device", "cpu", "--scene", "8x8x8", "--size", "24x16",
                   "--frames", "2", *flags, "-o", path])
    assert rc == 0
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", data[16:24]) == (24, 16)


@pytest.mark.parametrize("flags", PORTED_MODES)
def test_cli_refuses_a_light_without_its_brightness(flags):
    with pytest.raises(SystemExit, match="--light"):
        cli.main(["--device", "cpu", "--scene", "8x8x8", *flags,
                  "--light", "1,2,3"])


@pytest.mark.parametrize("flags", PORTED_MODES)
def test_cli_refuses_what_is_not_ported(flags, tmp_path):
    """Kept under its earlier name, from when both modes were refused as
    not yet ported: both now run (the two tests above)."""
    test_cli_runs_the_ported_modes(flags, tmp_path)
    test_cli_refuses_a_light_without_its_brightness(flags)


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


@pytest.mark.slow
def test_moving_frames_match_pallas_interpret_renderer():
    """A small move on 8x8x8 against the Pallas kernels themselves,
    interpreted, at denoise radius 2: frames 2 and 3 run the fused
    temporal kernel with live history (inside its serve window) and the
    denoise kernel.  Measured: nodes exact; frame 1's trace colour beyond
    1e-3 at 4 px (secondary rays that graze an edge, the Pallas suite's
    own window), which the r=2 stencil spreads to 20 u8 px beyond 1 code;
    frames 2 and 3 identical in u8; no validity flips; blend 4.8e-7."""
    scene = load_scene("8x8x8")
    jr = JRenderer(scene=scene, height=32, width=32,
                   trace_impl="pallas_interpret", denoise_radius=2)
    r = Renderer(scene=scene, height=32, width=32, device="cpu",
                 denoise_radius=2)
    for step, max_far in enumerate((20, 0, 0)):
        pos = np.array([2.0 + 0.03 * step, 3.0, -4.0 - 0.05 * step])
        direction = np.array([0.2, 0.1 + 0.01 * step, 1.0])
        ref = jr.render(JCamera(position=pos, direction=direction))
        out = r.render(Camera(position=pos, direction=direction))
        np.testing.assert_array_equal(out["node"].numpy(),
                                      np.asarray(ref["node"]))
        err = np.abs(out["trace_color"].numpy()
                     - np.asarray(ref["trace_color"])).max(-1)
        assert int((err > 1e-3).sum()) <= 4
        diff = np.abs(np.asarray(ref["image"]).astype(int)
                      - out["image"].numpy().astype(int))
        assert int((diff > 1).any(-1).sum()) <= max_far
        got = state_to_numpy(r.state)["accum_blend"]
        want = np.asarray(jr.state["accum_blend"])
        np.testing.assert_array_equal(got < 0.5 - 1e-6, want < 0.5 - 1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert r.still_sample == 1 and (got < 0.5 - 1e-6).any()
