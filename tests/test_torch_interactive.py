"""The port's interactive layer against the JAX package's: the fly
controller, the terminal viewer's key panel and frame formatting, the
browser viewer (its page, parameters, HTTP endpoints and frames), the
exact Mray/s readout, the lookahead host fetch, kernel hot-reload, the
interactive benchmark and ``profile_frames``.

The JAX package is imported inside the tests (the ``ref`` fixture): the
card's machine runs this file's ``cuda`` tests without JAX,

    python -m pytest --noconftest -m cuda tests/test_torch_interactive.py

Tolerances: cameras, parameters, bytes and sizes equal; frames of the
browser viewer against the JAX viewer's (XLA trace) within the u8 bar
of ``tests/test_torch_pipeline.py``'s still frames (at most 1 code value
at at most 3 pixels; measured identical); on the card, the viewer's
frames bit-equal to ``render()`` (the same code on the same values).
"""

import dataclasses
import importlib
import json
import os
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from voxtracer_torch.app import camera_paths, cli, ibench, profile, viewer, web
from voxtracer_torch.app.input import FlyController
from voxtracer_torch.engine import reload
from voxtracer_torch.engine.camera import Camera
from voxtracer_torch.engine.pipeline import Renderer
from voxtracer_torch.engine.scene import load_scene
from voxtracer_torch.ops import _build
from voxtracer_torch.utils import timing
from voxtracer_torch.utils.fetch import LookaheadFetch


@pytest.fixture(scope="module")
def ref():
    """The JAX package's counterparts, imported here (see the module
    docstring)."""
    names = ("app.input", "app.viewer", "app.web", "app.ibench",
             "app.cli", "engine.camera", "engine.pipeline", "engine.reload")
    return types.SimpleNamespace(**{
        n.split(".")[1]: importlib.import_module("voxtracer." + n)
        for n in names})


def _port_renderer(name="3x3x3", w=16, h=16, **kw):
    return Renderer(scene=load_scene(name), height=h, width=w, device="cpu",
                    lean=True, **kw)


def _jax_renderer(ref, name="3x3x3", w=16, h=16, **kw):
    return ref.pipeline.Renderer(scene=ref.cli.load_scene(name), height=h,
                                 width=w, trace_impl="xla", lean=True, **kw)


# -- the fly controller ----------------------------------------------------

def _same_controller(a, b):
    assert np.array_equal(a.camera.position, b.camera.position,
                          equal_nan=True)
    assert np.array_equal(a.camera.direction, b.camera.direction,
                          equal_nan=True)
    assert a.camera.fov == b.camera.fov
    assert (a.yaw, a.pitch, a.pressed, a.cursor_grabbed, a.exit_requested,
            a.moved) == (b.yaw, b.pitch, b.pressed, b.cursor_grabbed,
                         b.exit_requested, b.moved)


def _apply(ctl, event):
    kind, *args = event
    if kind == "down":
        ctl.key_down(*args)
    elif kind == "up":
        ctl.key_up(*args)
    elif kind == "look":
        ctl.mouse_delta(*args)
    elif kind == "update":
        ctl.update(*args)
    else:
        return ctl.take_moved()


KEYS = ["w", "a", "s", "d", "q", "e", "W", "shift", "ctrl", "tab", "escape",
        "x"]

SCRIPT = [
    ("update", 0.0), ("look", 100.0, 0.0), ("down", "tab"),
    ("look", 100.0, -50.0), ("down", "w"), ("update", 1.0),
    ("down", "shift"), ("update", 0.5), ("up", "shift"), ("down", "ctrl"),
    ("update", 1 / 30), ("take",), ("take",), ("down", "D"), ("down", "q"),
    ("update", 0.25), ("up", "w"), ("up", "d"), ("up", "ctrl"),
    ("look", -3.5, 1200.0), ("update", 1 / 60), ("down", "s"),
    ("down", "a"), ("down", "e"), ("update", 2.0), ("down", "escape"),
]


def test_fly_controller_matches_reference_scripted(ref):
    port, jax_ctl = FlyController(), ref.input.FlyController()
    for event in SCRIPT:
        assert _apply(port, event) == _apply(jax_ctl, event)
        _same_controller(port, jax_ctl)
    assert port.exit_requested and port.cursor_grabbed


_EVENT = st.one_of(
    st.tuples(st.just("down"), st.sampled_from(KEYS)),
    st.tuples(st.just("up"), st.sampled_from(KEYS)),
    st.tuples(st.just("look"), st.floats(-500, 500), st.floats(-500, 500)),
    st.tuples(st.just("update"), st.floats(0.0, 2.0)),
    st.tuples(st.just("take")),
)


@settings(max_examples=60, deadline=None)
@given(events=st.lists(_EVENT, max_size=40),
       pos=st.tuples(*[st.floats(-50, 50)] * 3))
def test_fly_controller_matches_reference_drawn(events, pos):
    jinput = importlib.import_module("voxtracer.app.input")
    jcamera = importlib.import_module("voxtracer.engine.camera")
    port = FlyController(camera=Camera(position=np.array(pos)))
    jax_ctl = jinput.FlyController(
        camera=jcamera.Camera(position=np.array(pos)))
    for event in events:
        assert _apply(port, event) == _apply(jax_ctl, event)
        _same_controller(port, jax_ctl)


def test_fly_controller_frames_a_camera_as_the_viewers_did():
    cam = camera_paths.static(load_scene("3x3x3"))(0.0)
    ctl = FlyController()
    ctl.frame(cam)
    d = cam.direction / np.linalg.norm(cam.direction)
    assert ctl.camera is cam
    assert ctl.pitch == float(np.arcsin(d[1]))
    assert ctl.yaw == float(np.arctan2(d[0], d[2]))
    np.testing.assert_allclose(ctl.update(0.0).direction, d, atol=1e-12)


# -- the terminal viewer ------------------------------------------------------

# every key of the reference's panel (voxtracer/app/viewer.py:144-236),
# an unbound one and the empty key of a non-byte curses code
PANEL_KEYS = list("[]{}-=_+,.vVfFxXcC;'gGhHbB") + ["z", ""]


def _params(r):
    return (dataclasses.asdict(r.render_params),
            dataclasses.asdict(r.temporal_params),
            dataclasses.asdict(r.denoise_params), r.denoise_radius,
            r.still_sample)


def test_viewer_keys_leave_the_reference_parameters(ref, tmp_path,
                                                    monkeypatch):
    """Each key, pressed enough times to reach its slider's clamp, leaves
    the same parameters, camera and scene on a port ``Renderer`` (CPU)
    and a JAX one; then movement, scene cycling, reset, snapshot, quit."""
    scenes = ["3x3x3", "8x8x8"]
    port_r, jax_r = _port_renderer(), _jax_renderer(ref)
    port = viewer.ViewerState(port_r, FlyController(), scenes)
    jax_vs = ref.viewer.ViewerState(jax_r, ref.input.FlyController(), scenes)
    assert _params(port_r) == _params(jax_r)
    for key in PANEL_KEYS:
        for _ in range(12):
            assert port.handle_key(key) == jax_vs.handle_key(key) is True
            assert _params(port_r) == _params(jax_r), key
    for key in "wasdqe":
        assert port.handle_key(key) and jax_vs.handle_key(key)
        _same_controller(port.ctl, jax_vs.ctl)
    for _ in range(3):
        port.handle_key("m")
        jax_vs.handle_key("m")
        assert port.scene_idx == jax_vs.scene_idx
        assert port_r.scene.values.shape == jax_r.scene.values.shape
        assert np.array_equal(port_r.scene.values, jax_r.scene.values)
    port_r.still_sample = jax_r.still_sample = 5
    port.handle_key("r")
    jax_vs.handle_key("r")
    assert port_r.still_sample == jax_r.still_sample == 0
    metas = []
    for side, vs in (("port", port), ("jax", jax_vs)):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        assert vs.handle_key("p")
        with np.load("viewer_snapshot.npz") as data:
            metas.append(json.loads(str(data["meta"])))
    for key in ("render_params", "temporal_params", "denoise_params",
                "denoise_radius", "camera_position", "camera_direction",
                "scene_hash", "height", "width"):
        assert metas[0][key] == metas[1][key], key
    assert not port.handle_key("\x1b") and not jax_vs.handle_key("\x1b")


def test_viewer_cycle_keeps_the_old_scene_when_one_fails():
    r = _port_renderer()
    vs = viewer.ViewerState(r, FlyController(), ["3x3x3", "no-such-scene"])
    scene = r.scene
    vs.cycle_scene()
    assert r.scene is scene and vs.scene_idx == 1


@pytest.mark.parametrize("shape", [(4, 2), (7, 5), (24, 32), (143, 256)])
def test_halfblock_frame_bytes_match_reference(ref, shape):
    img = np.random.default_rng(shape[0]).integers(
        0, 256, (*shape, 3), dtype=np.uint8)
    assert viewer._halfblock_frame(img) == ref.viewer._halfblock_frame(img)


def test_fit_size_matches_reference(ref):
    for rows in range(1, 80, 3):
        for cols in range(1, 300, 7):
            assert viewer._fit_size(rows, cols) == ref.viewer._fit_size(
                rows, cols)


def test_viewer_docstring_lists_the_reference_controls(ref):
    doc = ref.viewer.__doc__
    start = doc.index("Controls")
    end = doc.index("terminal has no color picker")
    assert doc[start:end].replace(
        "denoise radius (0..8; recompiles, like a pipeline rebuild)",
        "denoise radius (0..8)") in viewer.__doc__


# -- the exact Mray/s ---------------------------------------------------------

class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_ray_rate_is_the_rays_of_its_window_over_its_seconds(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(timing.time, "perf_counter", clock)
    fps = timing.FpsCounter(window=0.25)
    rays = [1000, 3000, 2500, 7]
    for n in rays[:3]:
        clock.now += 0.1
        fps.tick(n)
    # the window closed at the third frame: 3 frames, 6500 rays, 0.3 s
    assert fps.fps == pytest.approx(3 / 0.3)
    assert fps.rays_per_s == pytest.approx(6500 / 0.3)
    assert fps.rays_per_s == pytest.approx(np.mean(rays[:3]) * fps.fps)
    clock.now += 0.3
    fps.tick(rays[3])
    assert fps.rays_per_s == pytest.approx(7 / 0.3)


def test_viewers_read_the_rays_the_trace_counted(monkeypatch):
    """The browser viewer's Mray/s is the trace's counted rays over the
    window's seconds, not ``H * W * fps`` (the JAX viewers' readout):
    with secondary rays they differ.  The terminal viewer's status line
    prints the same rate."""
    clock = _Clock()
    monkeypatch.setattr(timing.time, "perf_counter", clock)
    r = _port_renderer("8x8x8", 24, 16)
    v = web.WebViewer(r)
    v.ctl.frame(camera_paths.static(r.scene)(0.0))
    counted = []
    render = r.render

    def spy(camera):
        out = render(camera)
        counted.append(int(out["rays"].sum()))
        return out

    r.render = spy
    for _ in range(3):  # the third frame closes the 0.25 s window
        clock.now += 0.1
        v.render_once()
    assert v.fps.fps == pytest.approx(3 / 0.3)
    assert v.fps.rays_per_s == pytest.approx(sum(counted) / 0.3)
    state = v.state_json()
    assert state["mrays_per_s"] == round(sum(counted) / 0.3 / 1e6, 1)
    assert sum(counted) / 3 > 24 * 16  # more than the primary rays
    line = viewer.ViewerState(r, v.ctl).status_line(v.fps.fps,
                                                    v.fps.rays_per_s)
    assert f"Mray/s:{v.fps.rays_per_s / 1e6:6.1f}" in line


# -- the browser viewer -------------------------------------------------------

def test_web_page_and_param_specs_match_reference(ref):
    assert web.PAGE == ref.web.PAGE
    assert web.PARAM_SPECS == ref.web.PARAM_SPECS


def test_state_json_matches_reference(ref):
    port = web.WebViewer(_port_renderer(), scenes=["3x3x3"])
    jax_v = ref.web.WebViewer(_jax_renderer(ref), scenes=["3x3x3"])
    a, b = port.state_json(), jax_v.state_json()
    assert a.keys() == b.keys()
    assert a["params"] == b["params"]
    for key in ("scenes", "scene", "fps", "mrays_per_s", "frame", "size"):
        assert a[key] == b[key], key


def test_render_once_frames_match_the_jax_viewer(ref):
    """The same scripted events through both viewers' ``render_once``:
    the raw u8 frames handed to the encoder agree within the bar."""
    w, h = 32, 24
    cam = camera_paths.static(load_scene("8x8x8"))(0.0)
    port = web.WebViewer(_port_renderer("8x8x8", w, h, denoise_radius=2),
                         scenes=["8x8x8", "3x3x3"])
    port.ctl.frame(cam)
    jax_v = ref.web.WebViewer(
        _jax_renderer(ref, "8x8x8", w, h, denoise_radius=2),
        scenes=["8x8x8", "3x3x3"])
    jax_v.ctl.camera = ref.camera.Camera(position=cam.position.copy(),
                                         direction=cam.direction.copy())
    jax_v.ctl.yaw, jax_v.ctl.pitch = port.ctl.yaw, port.ctl.pitch
    got, want = [], []
    publish, jax_publish = port._publish, jax_v._publish
    port._publish = lambda img, rays: (got.append(img.copy()),
                                       publish(img, rays))
    jax_v._publish = lambda img: (want.append(np.array(img)),
                                  jax_publish(img))
    script = [
        [{"type": "grab", "grabbed": True}], [{"type": "keydown", "key": "w"}],
        [], [{"type": "keyup", "key": "w"}, {"type": "look", "dx": 30,
                                            "dy": -10}],
        [{"type": "param", "name": "sun_strength", "value": 6.5}],
        [{"type": "param", "name": "denoise_radius", "value": 1}],
        [{"type": "reset"}], [],
        [{"type": "size", "width": 24, "height": 16}], [],
    ]
    for events in script:
        for ev in events:
            port.handle_event(ev)
            jax_v.handle_event(ev)
        port.render_once()
        jax_v.render_once()
    assert len(got) == len(want) == len(script)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == np.uint8
        diff = np.abs(a.astype(int) - b.astype(int))
        assert diff.max() <= 1 and int((diff > 0).any(-1).sum()) <= 3
    assert got[-1].shape == (16, 24, 3) and got[0].std() > 5
    _same_controller(port.ctl, jax_v.ctl)


@pytest.mark.cuda
def test_render_once_frames_equal_render_on_the_card():
    """On the card every raw frame the browser viewer publishes, and its
    ray count, equals a plain ``render()`` loop over the same cameras and
    parameters, through looks, a radius change, a reset and a resize."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    scene = load_scene("menger")

    def renderer():
        return Renderer(scene=scene, height=90, width=160, device="cuda",
                        denoise_radius=2, lean=True)

    v = web.WebViewer(renderer())
    v.ctl.frame(camera_paths.static(scene)(0.0))
    plain = renderer()
    published = []
    publish = v._publish
    v._publish = lambda img, rays: (published.append((img.copy(), rays)),
                                    publish(img, rays))
    script = [
        [{"type": "grab", "grabbed": True}], [{"type": "look", "dx": 20,
                                               "dy": 5}],
        [{"type": "param", "name": "denoise_radius", "value": 4}],
        [{"type": "reset"}], [], [{"type": "size", "width": 64,
                                   "height": 40}], [{"type": "look",
                                                     "dx": -9, "dy": 0}],
    ]
    for events in script:
        for ev in events:
            v.handle_event(ev)
            if ev["type"] == "reset":
                plain.reset_accumulation()
            elif ev["type"] == "size":
                plain.resize(ev["height"], ev["width"])
        v.render_once()
        plain.denoise_radius = v.renderer.denoise_radius
        out = plain.render(v.ctl.camera)
        img, rays = published[-1]
        assert np.array_equal(img, out["image"].cpu().numpy())
        assert rays == int(out["rays"].sum().cpu())
    assert published[-1][0].shape == (40, 64, 3)


@pytest.fixture(scope="module")
def server():
    r = _port_renderer("3x3x3", 32, 24)
    v = web.WebViewer(r, scenes=["3x3x3", "8x8x8"])
    srv = web.serve(v, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    v.render_once()  # one frame without the loop thread
    yield v, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as resp:
        return resp.status, resp.headers, resp.read()


def _post(base, ev):
    req = urllib.request.Request(base + "/input", data=json.dumps(ev).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def test_http_page_state_and_frame(server):
    v, base = server
    status, _, body = _get(base, "/")
    assert status == 200 and body == web.PAGE.encode()
    state = json.loads(_get(base, "/state")[2])
    assert state["size"] == [32, 24] and state["scene"] == "3x3x3"
    assert set(state["params"]) >= set(web.PARAM_SPECS)
    status, headers, body = _get(base, "/frame")
    assert status == 200 and headers["Content-Type"] in ("image/jpeg",
                                                         "image/png")
    assert body[:2] == b"\xff\xd8" or body[:8] == b"\x89PNG\r\n\x1a\n"
    assert _get_code(base, "/nope") == 404


def _get_code(base, path):
    try:
        return _get(base, path)[0]
    except urllib.error.HTTPError as e:
        return e.code


def test_http_input_drives_controller_and_params(server):
    v, base = server
    pos0 = np.array(v.ctl.camera.position)
    assert _post(base, {"type": "keydown", "key": "w"}) == 200
    v.ctl.update(1.0)
    assert _post(base, {"type": "keyup", "key": "w"}) == 200
    assert np.linalg.norm(v.ctl.camera.position - pos0) == pytest.approx(5.0)
    assert _post(base, {"type": "grab", "grabbed": True}) == 200
    yaw = v.ctl.yaw
    assert _post(base, {"type": "look", "dx": 100, "dy": 0}) == 200
    assert v.ctl.yaw == pytest.approx(yaw + 0.1)
    assert _post(base, {"type": "param", "name": "sun_strength",
                        "value": 99.0}) == 200
    assert v.renderer.render_params.sun_strength == 10.0
    assert _post(base, {"type": "param", "name": "denoise_radius",
                        "value": 3}) == 200
    assert v.renderer.denoise_radius == 3
    assert _post(base, {"type": "color", "name": "sun_color",
                        "value": [0.5, 0.25, 1.5]}) == 200
    assert v.renderer.render_params.sun_color == (0.5, 0.25, 1.0)
    assert _post(base, {"type": "param", "name": "nope", "value": 1}) == 200
    assert _post(base, {"type": "look", "dx": "left"}) == 400
    assert _post(base, {"type": "param", "name": "denoise_radius",
                        "value": 0}) == 200


def test_http_scene_swap_reset_and_resize_wait_for_the_owner(server):
    """Scene swaps, resets and resizes posted over HTTP are queued and
    applied by the thread that renders, between frames; an unknown
    scene is ignored."""
    v, base = server
    r = v.renderer
    v.render_once()
    assert r.state["history_valid"]
    tables = r.tables
    assert _post(base, {"type": "scene", "name": "missing-scene"}) == 200
    assert _post(base, {"type": "scene", "name": "8x8x8"}) == 200
    assert _post(base, {"type": "reset"}) == 200
    assert _post(base, {"type": "size", "width": 40, "height": 20}) == 200
    assert _post(base, {"type": "size", "width": 0, "height": 9}) == 200
    # nothing applied yet: the renderer is the render loop's
    assert r.tables is tables and r.state["history_valid"]
    assert (r.height, r.width) == (24, 32) and v.has_pending()
    v.render_once()
    assert not v.has_pending() and r.tables is not tables
    assert (r.height, r.width) == (20, 40) and r.still_sample == 1
    state = json.loads(_get(base, "/state")[2])
    assert state["scene"] == "8x8x8" and state["size"] == [40, 20]
    assert _post(base, {"type": "size", "width": 32, "height": 24}) == 200
    v.render_once()
    assert (r.height, r.width) == (24, 32)


def test_http_snapshot_is_written_by_the_owner(server, tmp_path):
    v, base = server
    path = str(tmp_path / "snap.npz")
    assert _post(base, {"type": "snapshot", "path": path}) == 200
    assert not os.path.exists(path)
    v.render_once()
    assert os.path.exists(path)


def test_stream_serves_multipart_frames_from_the_loop():
    """The render loop thread and ``/stream``: a client reads parts of
    the MJPEG stream while look events move the camera."""
    r = _port_renderer("3x3x3", 16, 16)
    v = web.WebViewer(r)
    srv = web.serve(v, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    v.start()
    try:
        v.handle_event({"type": "grab", "grabbed": True})
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(base + "/stream", timeout=60) as resp:
            assert resp.headers["Content-Type"] == (
                "multipart/x-mixed-replace; boundary=vtframe")
            for _ in range(3):
                v.handle_event({"type": "look", "dx": 3.0, "dy": 0.0})
                assert resp.readline() == b"--vtframe\r\n"
                mime = resp.readline().split(b": ")[1].strip()
                n = int(resp.readline().split(b": ")[1])
                assert resp.readline() == b"\r\n"
                assert len(resp.read(n)) == n and resp.read(2) == b"\r\n"
                assert mime in (b"image/jpeg", b"image/png")
    finally:
        v.stop()
        srv.shutdown()
        srv.server_close()
    stats = v.stage_stats()
    assert stats["errors"] == 0 and stats["loop_frames"] >= 3
    assert not v._thread.is_alive() and not v._enc_thread.is_alive()


def test_the_loop_hands_off_the_frames_render_once_publishes():
    """``render_once`` and the served loop run one frame step: with the
    camera still, the raw frames the loop hands to the encoder are, in
    order, those ``render_once`` publishes, ray counts included."""
    def make():
        r = _port_renderer("8x8x8", 16, 16, denoise_radius=1)
        v = web.WebViewer(r)
        v.ctl.frame(camera_paths.static(r.scene)(0.0))
        return v

    once, served = make(), make()
    want = []
    once._publish = lambda img, rays: want.append((img.copy(), rays))
    for _ in range(3):
        once.render_once()
    got = []
    served._submit_raw = lambda img, rays: got.append((img, rays))
    served.start()
    try:
        deadline = time.time() + 60
        while len(got) < 3 and time.time() < deadline:
            time.sleep(0.05)
    finally:
        served.stop()
    assert len(got) >= 3 and len(want) == 3
    for (a, ra), (b, rb) in zip(got, want):
        assert np.array_equal(a, b) and ra == rb
    assert served.stage_stats()["errors"] == 0


def test_encoder_falls_back_to_png_without_pil(monkeypatch):
    img = np.random.default_rng(1).integers(0, 256, (8, 12, 3), np.uint8)
    monkeypatch.setitem(sys.modules, "PIL", None)  # import fails
    data, mime = web._encode_jpeg(img)
    assert mime == "image/png" and data[:8] == b"\x89PNG\r\n\x1a\n"


# -- the lookahead host fetch -------------------------------------------------

def test_lookahead_fetch_is_one_frame_behind_on_the_cpu():
    fetch = LookaheadFetch()
    outs = [{"image": torch.full((2, 3, 3), i, dtype=torch.uint8),
             "rays": torch.tensor([i, 2 * i], dtype=torch.int64)}
            for i in range(1, 4)]
    assert fetch.push(outs[0]) is None
    img, rays = fetch.push(outs[1])
    assert (img == 1).all() and rays == 3 and img.shape == (2, 3, 3)
    fetch.drop()
    assert fetch.push(outs[2]) is None
    img, rays = fetch.flush()
    assert (img == 3).all() and rays == 9
    assert fetch.flush() is None


@pytest.mark.cuda
def test_lookahead_fetch_equals_cpu_copies_on_the_card():
    """20 consecutive frames of a moving camera at 320x180 r=2: each
    fetched image and ray count == the frame's ``.cpu()``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    scene = load_scene("menger")
    r = Renderer(scene=scene, height=180, width=320, device="cuda",
                 denoise_radius=2, lean=True)
    cam = camera_paths.static(scene)(0.0)
    fetch = LookaheadFetch()
    outs, got = [], []
    for i in range(20):
        out = r.render(cam.pitched(0.5 * i))
        outs.append((out["image"], out["rays"]))
        fetched = fetch.push(out)
        if fetched is not None:
            got.append((fetched[0].copy(), fetched[1]))
    got.append(fetch.flush())
    assert len(got) == 20
    for (image, rays), (img, n) in zip(outs, got):
        assert np.array_equal(img, image.cpu().numpy())
        assert n == int(rays.sum().cpu())


# -- kernel hot-reload --------------------------------------------------------

@pytest.fixture
def fake_module(tmp_path, monkeypatch):
    """Makes an importable module from source text; removed at the end."""
    made = []

    def make(name, text):
        f = tmp_path / f"{name}.py"
        f.write_text(text)
        monkeypatch.syspath_prepend(str(tmp_path))
        importlib.import_module(name)
        made.append(name)
        return f

    yield make
    for name in made:
        sys.modules.pop(name, None)


def _bump(path):
    later = time.time() + 5
    os.utime(path, (later, later))


def test_kernel_watcher_reloads_a_changed_module(fake_module):
    """The reference's fake-module reload (tests/test_app.py), with the
    port's watcher and its renderer hook: the reloaded function takes
    the old one's place in the same module object, where the renderer
    reads its stages, and the hook drops the frame plan and the sequence
    runner."""
    name = "voxtracer_torch_fake_kernel"
    f = fake_module(name, "def render_sample(*a):\n    return 1\n")
    module = sys.modules[name]
    r = _port_renderer()
    r._plan, r._runner = object(), object()
    calls = []
    hook = reload.renderer_hook(r)
    w = reload.KernelWatcher(on_reload=lambda: (calls.append(1), hook()),
                             modules=[name], debounce=0.0)
    assert not w.poll()
    f.write_text("def render_sample(*a):\n    return 2\n")
    _bump(f)
    assert w.poll()
    assert calls == [1] and module.render_sample() == 2
    assert r._plan is None and r._runner is None
    assert sys.modules[name] is module
    f.write_text("def render_sample(*a):\n    return (\n")  # broken
    _bump(f)
    assert not w.poll()
    assert calls == [1] and module.render_sample() == 2


def test_kernel_watcher_debounces(fake_module, monkeypatch):
    """A change within 0.5 s of the last reload waits, and is reloaded at
    the first poll after the window (the reference drops it)."""
    clock = _Clock()
    monkeypatch.setattr(reload.time, "monotonic", clock)
    name = "voxtracer_torch_fake_debounced"
    f = fake_module(name, "VALUE = 1\n")
    w = reload.KernelWatcher(modules=[name])
    f.write_text("VALUE = 2\n")
    _bump(f)
    assert w.poll()  # the first change is never held
    f.write_text("VALUE = 3\n")
    later = time.time() + 10
    os.utime(f, (later, later))
    clock.now += 0.2
    assert not w.poll()  # within the debounce
    assert sys.modules[name].VALUE == 2
    clock.now += 0.4
    assert w.poll()
    assert sys.modules[name].VALUE == 3
    assert not w.poll()


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """``_build`` pointed at a copy of the CUDA sources."""
    import shutil

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, src)
    monkeypatch.setattr(_build, "CSRC_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return src


class _FakeLoad:
    """Stands in for ``_build.load`` (its cache)."""

    def __init__(self):
        self.cleared = 0

    def cache_clear(self):
        self.cleared += 1


def test_kernel_watcher_rebuilds_a_changed_cuda_source(csrc_copy,
                                                      monkeypatch):
    """A changed ``.cu``: the stubbed build returns the new library's
    path, ``load``'s cache is cleared, and the frame plan and the runner
    are dropped; the stages stay the package's."""
    built = []
    monkeypatch.setattr(_build, "build", lambda: built.append(1) or
                        "/lib/libvoxtracer_kernels-new.so")
    fake = _FakeLoad()
    monkeypatch.setattr(_build, "load", fake)
    r = _port_renderer()
    stages = r._stages()
    r._plan, r._runner = object(), object()
    w = reload.KernelWatcher(on_reload=reload.renderer_hook(r),
                             debounce=0.0)
    assert not w.poll() and not built
    with open(csrc_copy / "reproject.cu", "a") as f:
        f.write("\n// edited\n")
    _bump(csrc_copy / "reproject.cu")
    assert w.poll()
    assert built == [1] and fake.cleared == 1
    assert r._plan is None and r._runner is None
    assert r._stages() == stages
    assert not w.poll()  # nothing changed since


def test_kernel_watcher_keeps_the_library_when_the_build_fails(csrc_copy,
                                                              monkeypatch):
    def fail():
        raise RuntimeError("nvcc failed on trace.cu (1)")

    monkeypatch.setattr(_build, "build", fail)
    fake = _FakeLoad()
    monkeypatch.setattr(_build, "load", fake)
    r = _port_renderer()
    plan, runner = object(), object()
    r._plan, r._runner = plan, runner
    w = reload.KernelWatcher(on_reload=reload.renderer_hook(r),
                             debounce=0.0)
    with open(csrc_copy / "trace.cu", "a") as f:
        f.write("\nthis is not C++;\n")
    _bump(csrc_copy / "trace.cu")
    assert not w.poll()
    assert fake.cleared == 0 and r._runner is runner and r._plan is plan
    assert not w.poll()  # a failed source is tried again when it changes


FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: "-c -o OBJ SRC" compiles, "-shared -o LIB ..." links
case "$*" in
  *-shared*) shift 2; touch "$1"; echo linked ;;
  *broken.cu*) echo "broken.cu(1): error: expected a declaration"; exit 2 ;;
  *slow.cu*) sleep 60 ;;
  *) for a; do case "$prev" in -o) touch "$a" ;; esac; prev="$a"; done
     echo "ptxas info    : Used 32 registers" ;;
esac
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """``_build`` with a stand-in nvcc and its own source and build
    directories (the CPU has no CUDA toolkit)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    src = tmp_path / "csrc"
    src.mkdir()
    monkeypatch.setattr(_build, "CSRC_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return src


def test_build_compiles_every_source_and_links(fake_nvcc):
    for name in ("a.cu", "b.cu"):
        (fake_nvcc / name).write_text("// kernel\n")
    path = _build.build()
    assert os.path.exists(path) and path == _build.library_path()
    assert _build.build_log().count("Used 32 registers") == 2
    assert _build.build() == path  # built once


def test_build_stops_at_the_first_failing_source(fake_nvcc):
    """A source that fails ends the build at once, whatever still
    compiles (a hot-reload waits for the build), with nvcc's message."""
    (fake_nvcc / "a_slow.cu").write_text("// takes a minute\n")
    (fake_nvcc / "broken.cu").write_text("this is not C++;\n")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="nvcc failed on broken.cu") as e:
        _build.build()
    assert time.perf_counter() - t0 < 20
    assert "expected a declaration" in str(e.value)
    assert not os.path.exists(_build.library_path())


@pytest.mark.cuda
def test_kernel_watcher_rebuilds_on_the_card(csrc_copy):
    """A real rebuild from the copy of ``csrc/`` and a failed one: the
    new library renders the frames of the old; a broken source keeps the
    last good library loaded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    scene = load_scene("8x8x8")
    cams = [camera_paths.static(scene)(0.0)]
    cams.append(cams[0].pitched(2.0))

    def frames():
        r = Renderer(scene=scene, height=48, width=64, device="cuda",
                     denoise_radius=2, lean=True)
        return np.stack([r.render(c)["image"].cpu().numpy() for c in cams])

    first = _build.load()._name
    want = frames()
    w = reload.KernelWatcher(debounce=0.0)
    with open(csrc_copy / "denoise.cu", "a") as f:
        f.write("\n// hot-reload check\n")
    _bump(csrc_copy / "denoise.cu")
    try:
        assert w.poll()
        second = _build.load()._name
        assert second != first and np.array_equal(frames(), want)
        with open(csrc_copy / "temporal.cu", "a") as f:
            f.write("\nthis is not C++;\n")
        _bump(csrc_copy / "temporal.cu")
        assert not w.poll()
        assert _build.load()._name == second
        assert np.array_equal(frames(), want)
    finally:
        _build.load.cache_clear()  # the repo's library at the next load


# -- the CLI, the interactive benchmark, profile_frames -------------------------

def test_cli_watch_kernels_polls_once_a_frame_and_a_batch(tmp_path,
                                                          monkeypatch):
    polls = []
    monkeypatch.setattr(reload.KernelWatcher, "poll",
                        lambda self: polls.append(1) or False)
    out = str(tmp_path / "w.png")
    assert cli.main(["--device", "cpu", "--scene", "3x3x3", "--size", "16x12",
                     "--frames", "5", "--batch", "2", "--watch-kernels",
                     "-o", out]) == 0
    assert len(polls) == 3  # two batches, one frame
    assert os.path.getsize(out) > 0


@pytest.fixture(scope="module")
def ibench_rows(ref):
    """The tui and wall rows of both packages at 32x24 for 0.5 s."""
    args = ("3x3x3", 32, 24, 0.5)
    return {
        "tui": (ibench.bench_tui(*args, device="cpu"),
                ref.ibench.bench_tui(*args, trace_impl="xla")),
        "wall": (ibench.bench_wall(*args, device="cpu"),
                 ref.ibench.bench_wall(*args, trace_impl="xla")),
    }


@pytest.mark.parametrize("mode", ["tui", "wall"])
def test_ibench_rows_have_the_reference_keys(ibench_rows, mode):
    port, jax_row = ibench_rows[mode]
    assert port.keys() == jax_row.keys()
    assert port["mode"] == mode and port["resolution"] == "32x24"
    assert port["fps"] > 0
    if mode == "wall":
        assert port["wall_ms"] > 0 and port["fetch_ms"] >= 0
        assert port["device_ms"] == 0.0  # no device activity on the CPU
    else:
        assert port["frames"] > 0


def test_ibench_web_row_on_the_cpu(ref):
    row = ibench.bench_web("3x3x3", 16, 12, 0.3, device="cpu",
                           warmup_frames=2)
    keys = ("mode", "scene", "resolution", "frames", "seconds", "fps",
            "stages", "note")
    assert set(keys) <= set(row) and row["frames"] > 0
    assert row["stages"]["errors"] == 0
    assert set(row["stages"]) >= {"loop_frames", "encoded_frames", "dropped",
                                  "watcher_ms", "ctl_ms", "dispatch_ms",
                                  "fetch_ms", "encode_ms"}
    assert row["mime"] in ("image/jpeg", "image/png")


def test_ibench_default_rows_are_the_reference_rows(ref):
    import inspect

    source = inspect.getsource(ref.ibench.main)
    for mode, scene, w, h in ibench.ROWS:
        call = f'bench_{mode}("{scene}", {w}, {h}, args.seconds)'
        assert call in source, call


def test_profile_frames_on_the_cpu(tmp_path):
    """On the CPU the trace holds no device activity: no rows, and the
    trace file is written."""
    r = _port_renderer("3x3x3", 12, 8)
    cam = camera_paths.static(r.scene)(0.0)
    rows = profile.profile_frames(r, [cam.pitched(1.0)], str(tmp_path))
    assert rows == []
    assert r.frame_number == 3  # two warm-up frames and one profiled
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)
