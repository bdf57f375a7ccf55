"""Browser live viewer of the PyTorch port: continuous mouse-look and
the full slider panel.

Counterpart of :mod:`voxtracer.app.web`, with the same page, endpoints
and parameter ranges: a stdlib HTTP server plus one self-contained HTML
page:

  * pointer-lock mouse-look (0.001 rad/px, the reference's rate) and
    WASD/QE key-state flying via :class:`FlyController`
  * an MJPEG ``multipart/x-mixed-replace`` stream of the rendered
    frames (JPEG where PIL imports, PNG otherwise)
  * every egui slider bound to an ``<input type=range>`` posting
    absolute values — same ranges and defaults as the reference panel
  * scene combobox, accumulation reset, snapshot save

Where it differs from the reference, on purpose:

  * one thread owns the renderer.  HTTP threads update the controller
    and the parameter values (frozen values, read once a frame), but a
    scene swap, an accumulation reset, a resize and a snapshot are
    queued and applied by the render-loop thread between frames: run
    from an HTTP thread they would swap scene tables or state under a
    half-launched frame.  A client sees the same;
  * the readout's Mray/s is exact: the rays the trace kernel counted in
    the published frames of the fps window, over its seconds (the
    reference prints ``H * W * fps``).

Run: ``python -m voxtracer_torch.app.web --scene menger --size 640x360``
then open http://localhost:8089/ (``--device cpu`` runs the plain torch
versions: tiny sizes only).
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import logging
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..engine import snapshot
from ..engine.pipeline import Renderer
from ..engine.reload import KernelWatcher, renderer_hook
from ..engine.scene import available_scenes, load_scene
from ..io.image import encode_png
from ..utils.fetch import LookaheadFetch
from ..utils.timing import FpsCounter
from .input import FlyController

log = logging.getLogger("voxtracer_torch.app.web")

# egui slider ranges (src/context.rs:1692-1827); absolute-set analogs
# of the terminal viewer's key pairs.
PARAM_SPECS = {
    # name: (group, lo, hi)
    "sun_yaw": ("render", -np.pi, np.pi),
    "sun_pitch": ("render", 0.0, np.pi / 2),
    "sun_size": ("render", 0.0, 1.0),
    "sun_strength": ("render", 0.0, 10.0),
    "emit_strength": ("render", 0.0, 32.0),
    "specularity": ("render", 0.0, 1.0),
    "sample_blending": ("temporal", 0.0, 1.0),
    "maximum_blending": ("temporal", 0.0, 1.0),
    "blending_distance_cutoff": ("temporal", 1e-6, 1.0),
    "sigma_distance": ("denoise", 0.25, 8.0),
    "sigma_range": ("denoise", 0.25, 8.0),
    "albedo_factor": ("denoise", 0.0, 1.0),
    "denoise_radius": ("radius", 0, 8),
}


def _encode_jpeg(img: np.ndarray) -> tuple[bytes, str]:
    """JPEG where PIL imports, else the port's PNG encoder."""
    try:
        from PIL import Image
    except ImportError:
        return encode_png(img), "image/png"
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=85)
    return buf.getvalue(), "image/jpeg"


class WebViewer:
    """Owns the renderer and controller and runs the render loop thread.

    The HTTP layer reads ``latest`` (frame bytes) and posts events
    through the thread-safe ``handle_event``; whatever replaces the
    renderer's scene tables or state waits in a queue for the render
    loop's thread (:meth:`apply_pending`).
    """

    def __init__(self, renderer: Renderer, scenes=None, scene_idx=0,
                 controller: FlyController | None = None,
                 watcher=None):
        self.renderer = renderer
        self.ctl = controller or FlyController()
        self.scenes = scenes or ["default"]
        self.scene_idx = scene_idx
        # kernel hot-reload during the live session, polled by the
        # render-loop thread; None skips polling (tests build bare
        # viewers)
        self.watcher = watcher
        self.lock = threading.Lock()
        self.frame_ready = threading.Condition(self.lock)
        self.latest: bytes = b""
        self.latest_mime = "image/jpeg"
        self.frame_no = 0
        self.fps = FpsCounter()
        self.running = False
        self._thread: threading.Thread | None = None
        # the encoder thread takes the host encode off the render loop:
        # the loop hands off the RAW frame (latest wins) and dispatches
        # the next device frame at once
        self._enc_cond = threading.Condition()
        self._enc_frame: tuple[np.ndarray, int] | None = None
        self._enc_thread: threading.Thread | None = None
        # events for the render-loop thread: the newest requested size,
        # and scene swaps, resets and snapshots in order
        self._pending_size: tuple[int, int] | None = None
        self._pending: list = []
        # the host side of the frames: one frame behind the card
        self._fetch = LookaheadFetch()
        # per-stage wall accumulators (seconds / counts).  The loop
        # thread owns the first five and ``errors``; the encoder thread
        # owns enc_s/enc_n (read via stage_stats).
        self._stats = dict(
            watch_s=0.0, ctl_s=0.0, dispatch_s=0.0, fetch_s=0.0,
            loop_n=0, enc_s=0.0, enc_n=0, errors=0,
        )

    def reset_stage_stats(self):
        for k in self._stats:
            self._stats[k] = 0 if k in ("loop_n", "enc_n", "errors") else 0.0

    def stage_stats(self) -> dict:
        """Per-published-frame stage means in ms (plus raw counts).

        ``dispatch_ms`` is the ``renderer.render`` call (host work and
        kernel launches; it waits for the card only where the launch
        queue is full), ``fetch_ms`` the wait for the PREVIOUS frame's
        host copy (the lookahead overlap target), ``encode_ms`` the
        JPEG/PNG encode + publish on the encoder thread, ``dropped`` how
        many rendered frames latest-wins replaced before encoding,
        ``errors`` the frames whose rendering raised."""
        s = self._stats
        n = max(s["loop_n"], 1)
        return dict(
            loop_frames=s["loop_n"],
            encoded_frames=s["enc_n"],
            dropped=max(s["loop_n"] - s["enc_n"], 0),
            watcher_ms=round(s["watch_s"] / n * 1e3, 2),
            ctl_ms=round(s["ctl_s"] / n * 1e3, 2),
            dispatch_ms=round(s["dispatch_s"] / n * 1e3, 2),
            fetch_ms=round(s["fetch_s"] / n * 1e3, 2),
            encode_ms=round(s["enc_s"] / max(s["enc_n"], 1) * 1e3, 2),
            errors=s["errors"],
        )

    # -- events (called from HTTP threads) ----------------------------
    def handle_event(self, ev: dict):
        kind = ev.get("type")
        if kind == "scene":
            # the .vox load is host work: here; the swap: queued
            self._queue_scene(str(ev.get("name")))
            return
        with self.lock:
            if kind == "keydown":
                self.ctl.key_down(str(ev.get("key", "")))
            elif kind == "keyup":
                self.ctl.key_up(str(ev.get("key", "")))
            elif kind == "look":
                self.ctl.mouse_delta(
                    float(ev.get("dx", 0.0)), float(ev.get("dy", 0.0))
                )
            elif kind == "grab":
                self.ctl.cursor_grabbed = bool(ev.get("grabbed", False))
            elif kind == "param":
                self._set_param(str(ev.get("name")), ev.get("value"))
            elif kind == "color":
                self._set_color(str(ev.get("name")), ev.get("value"))
            elif kind == "size":
                w = int(ev.get("width", 0))
                h = int(ev.get("height", 0))
                if 16 <= w <= 3840 and 16 <= h <= 2160:
                    self._pending_size = (h, w)
            elif kind == "reset":
                self._pending.append(("reset",))
            elif kind == "snapshot":
                self._pending.append(
                    ("snapshot", str(ev.get("path", "viewer_snapshot.npz"))))

    def _set_param(self, name: str, value):
        if name not in PARAM_SPECS:
            return
        group, lo, hi = PARAM_SPECS[name]
        r = self.renderer
        if group == "radius":
            r.denoise_radius = int(np.clip(int(value), lo, hi))
            return
        v = float(np.clip(float(value), lo, hi))
        if group == "render":
            r.render_params = dataclasses.replace(
                r.render_params, **{name: v}
            )
        elif group == "temporal":
            r.temporal_params = dataclasses.replace(
                r.temporal_params, **{name: v}
            )
        elif group == "denoise":
            r.denoise_params = dataclasses.replace(
                r.denoise_params, **{name: v}
            )

    def _set_color(self, name: str, value):
        if name not in ("sun_color", "sky_color"):
            return
        rgb = tuple(float(np.clip(float(c), 0.0, 1.0)) for c in value)[:3]
        r = self.renderer
        r.render_params = dataclasses.replace(
            r.render_params, **{name: rgb}
        )

    def _queue_scene(self, name: str):
        try:
            scene = load_scene(name)
        except (OSError, ValueError):
            return  # keep the old scene (src/context.rs:1817-1818)
        with self.lock:
            self._pending.append(("scene", name, scene))

    # -- the owner thread's side ---------------------------------------
    def has_pending(self) -> bool:
        return self._pending_size is not None or bool(self._pending)

    def apply_pending(self):
        """Apply the queued scene swaps, resets, snapshots and the newest
        requested size (render-loop/owner thread only: never while a
        frame is being launched)."""
        with self.lock:
            size, self._pending_size = self._pending_size, None
            events, self._pending = self._pending, []
            camera = self.ctl.camera
        for ev in events:
            if ev[0] == "scene":
                self.renderer.set_scene(ev[2])
                if ev[1] in self.scenes:
                    self.scene_idx = self.scenes.index(ev[1])
            elif ev[0] == "reset":
                self.renderer.reset_accumulation()
            elif ev[0] == "snapshot":
                try:
                    snapshot.save(ev[1], self.renderer, camera)
                except OSError:
                    log.exception("snapshot to %s failed", ev[1])
        if size is not None:
            self.renderer.resize(*size)

    def state_json(self) -> dict:
        r = self.renderer
        vals = {}
        for name, (group, _, _) in PARAM_SPECS.items():
            if group == "render":
                vals[name] = getattr(r.render_params, name)
            elif group == "temporal":
                vals[name] = getattr(r.temporal_params, name)
            elif group == "denoise":
                vals[name] = getattr(r.denoise_params, name)
            else:
                vals[name] = r.denoise_radius
        vals["sun_color"] = list(r.render_params.sun_color)
        vals["sky_color"] = list(r.render_params.sky_color)
        return {
            "params": vals,
            "scenes": self.scenes,
            "scene": self.scenes[self.scene_idx],
            "fps": round(self.fps.fps, 1),
            "mrays_per_s": round(self.fps.rays_per_s / 1e6, 1),
            "frame": self.frame_no,
            "size": [r.width, r.height],
        }

    # -- render loop --------------------------------------------------
    def start(self):
        self.running = True
        self._enc_thread = threading.Thread(
            target=self._encode_loop, daemon=True
        )
        self._enc_thread.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self.running = False
        if self._thread is not None:
            self._thread.join(timeout=10)
        with self._enc_cond:
            self._enc_cond.notify_all()
        if self._enc_thread is not None:
            self._enc_thread.join(timeout=10)

    def poll_watcher(self):
        """Non-fatal kernel hot-reload poll (the reference keeps the old
        pipeline on a failed shader compile, src/context.rs:1644-1646;
        ``KernelWatcher.poll`` already catches build and reload errors —
        this guard covers faults of the watcher itself)."""
        if self.watcher is None:
            return
        try:
            self.watcher.poll()
        except Exception:
            log.exception("kernel watcher poll failed")

    def render_once(self, dt: float = 1 / 30.0):
        """One frame through the render loop's own step, then its host
        copy waited for, encoded and published here (synchronous — the
        single-step path tests drive)."""
        self._step(dt, self._publish)
        got = self._fetch.flush()
        if got is not None:
            self._publish(got[0].copy(), got[1])

    def _step(self, dt: float, hand_off):
        """One frame of the render loop: poll the watcher, apply the
        queued events, advance the controller, launch the frame and start
        its host copy.  The previous frame, once its copy is complete,
        goes to ``hand_off(image, rays)``; so does the frame in flight
        before a resize, at its old size."""
        stats = self._stats
        t0 = time.perf_counter()
        self.poll_watcher()
        t1 = time.perf_counter()
        if self.has_pending():
            if self._pending_size is not None:
                got = self._fetch.flush()
                if got is not None:
                    hand_off(got[0].copy(), got[1])
            self.apply_pending()
        with self.lock:
            cam = self.ctl.update(dt)
        t2 = time.perf_counter()
        out = self.renderer.render(cam)
        t3 = time.perf_counter()
        # the host copy is valid until the next push: the receiver gets
        # its own copy of it
        got = self._fetch.push(out)
        if got is not None:
            hand_off(got[0].copy(), got[1])
        t4 = time.perf_counter()
        stats["watch_s"] += t1 - t0
        stats["ctl_s"] += t2 - t1
        stats["dispatch_s"] += t3 - t2
        stats["fetch_s"] += t4 - t3
        stats["loop_n"] += 1

    def _publish(self, img: np.ndarray, rays: int):
        data, mime = _encode_jpeg(img)
        with self.frame_ready:
            self.latest, self.latest_mime = data, mime
            self.frame_no += 1
            self.fps.tick(rays)
            self.frame_ready.notify_all()

    def _submit_raw(self, img: np.ndarray, rays: int):
        """Hand a raw frame to the encoder thread (latest wins — if
        the encoder is behind, the stale frame is dropped, never
        queued: an interactive stream wants freshness, not history)."""
        with self._enc_cond:
            self._enc_frame = (img, rays)
            self._enc_cond.notify()

    def _encode_loop(self):
        while True:
            with self._enc_cond:
                while self._enc_frame is None and self.running:
                    self._enc_cond.wait(0.25)
                frame, self._enc_frame = self._enc_frame, None
            if frame is None:
                if not self.running:
                    return
                continue
            t0 = time.perf_counter()
            try:
                self._publish(*frame)
            except Exception:  # keep encoding the frames that follow
                log.exception("frame encode failed")
                continue
            self._stats["enc_s"] += time.perf_counter() - t0
            self._stats["enc_n"] += 1

    def _loop(self):
        # One frame of lookahead: launch frame N+1 BEFORE waiting for
        # frame N's host copy, so the wait overlaps the card's work on
        # the next frame.  Costs one frame of display latency.
        last = time.perf_counter()
        while self.running:
            now = time.perf_counter()
            dt, last = now - last, now
            try:
                self._step(min(dt, 0.25), self._submit_raw)
            except Exception:  # keep serving; stage_stats counts it
                log.exception("frame failed")
                self._stats["errors"] += 1
                self._fetch.drop()
                time.sleep(0.5)
        got = self._fetch.flush()  # publish the lookahead frame
        if got is not None:
            self._publish(got[0].copy(), got[1])

    def wait_frame(self, after: int, timeout: float = 5.0):
        """Block until a frame newer than ``after`` exists."""
        deadline = time.time() + timeout
        with self.frame_ready:
            while self.frame_no <= after:
                left = deadline - time.time()
                if left <= 0 or not self.frame_ready.wait(left):
                    break
            return self.latest, self.latest_mime, self.frame_no


PAGE = """<!DOCTYPE html>
<html><head><title>voxtracer</title><style>
body{margin:0;background:#111;color:#ddd;font:13px sans-serif;display:flex}
#view{flex:1;display:flex;align-items:center;justify-content:center}
#view img{max-width:100%;max-height:100vh;cursor:crosshair}
#panel{width:270px;padding:10px;background:#1b1b1b;overflow-y:auto;height:100vh;box-sizing:border-box}
#panel label{display:block;margin-top:8px;font-size:11px;color:#aaa}
#panel input[type=range]{width:100%}
#panel select,#panel button{width:100%;margin-top:6px}
#stats{font-size:12px;color:#8c8;margin-bottom:6px;white-space:pre}
</style></head><body>
<div id=view><img id=frame src=/stream></div>
<div id=panel>
<div id=stats>connecting…</div>
<select id=scene></select>
<label>resolution <select id=size>
<option>320x180</option><option>640x360</option><option>960x540</option>
<option>1280x720</option><option>1920x1080</option>
</select></label>
<button id=reset>reset accumulation (R)</button>
<button id=snap>save snapshot (P)</button>
<div id=sliders></div>
<label>sun color <input type=color id=sun_color></label>
<label>sky color <input type=color id=sky_color></label>
<p style="font-size:11px;color:#777">click the image to grab the
cursor (pointer lock): WASD/QE fly, mouse looks, Shift fast, Ctrl
slow, Esc releases.</p>
</div>
<script>
const SLIDERS = {
 sun_yaw:[-3.14159,3.14159,0.01], sun_pitch:[0,1.5708,0.01],
 sun_size:[0,1,0.005], sun_strength:[0,10,0.1],
 emit_strength:[0,32,0.25], specularity:[0,1,0.01],
 sample_blending:[0,1,0.01], maximum_blending:[0,1,0.005],
 blending_distance_cutoff:[0.000001,1,0.0001],
 sigma_distance:[0.25,8,0.05], sigma_range:[0.25,8,0.05],
 albedo_factor:[0,1,0.05], denoise_radius:[0,8,1]};
const post = (o) => fetch('/input', {method:'POST', body:JSON.stringify(o)});
const sdiv = document.getElementById('sliders');
for (const [name,[lo,hi,step]] of Object.entries(SLIDERS)) {
  const l = document.createElement('label');
  l.textContent = name;
  const s = document.createElement('input');
  s.type='range'; s.min=lo; s.max=hi; s.step=step; s.id=name;
  s.oninput = () => post({type:'param', name, value:+s.value});
  l.appendChild(s); sdiv.appendChild(l);
}
const hex = (rgb) => '#'+rgb.map(c=>Math.round(c*255).toString(16).padStart(2,'0')).join('');
const unhex = (h) => [1,3,5].map(i=>parseInt(h.slice(i,i+2),16)/255);
for (const id of ['sun_color','sky_color']) {
  document.getElementById(id).oninput = (e) =>
    post({type:'color', name:id, value:unhex(e.target.value)});
}
const scenesEl = document.getElementById('scene');
scenesEl.onchange = () => post({type:'scene', name:scenesEl.value});
const sizeEl = document.getElementById('size');
sizeEl.onchange = () => {
  const [w,h] = sizeEl.value.split('x').map(Number);
  post({type:'size', width:w, height:h});
};
document.getElementById('reset').onclick = () => post({type:'reset'});
document.getElementById('snap').onclick = () => post({type:'snapshot'});
async function refresh(init) {
  const st = await (await fetch('/state')).json();
  document.getElementById('stats').textContent =
    `${st.scene} ${st.size[0]}x${st.size[1]}  fps ${st.fps}  ` +
    `${st.mrays_per_s} Mray/s`;
  if (init) {
    for (const name of Object.keys(SLIDERS))
      document.getElementById(name).value = st.params[name];
    scenesEl.innerHTML = st.scenes.map(s=>`<option>${s}</option>`).join('');
    scenesEl.value = st.scene;
    const cur = `${st.size[0]}x${st.size[1]}`;
    if (![...sizeEl.options].some(o=>o.value===cur))
      sizeEl.add(new Option(cur, cur));
    sizeEl.value = cur;
    document.getElementById('sun_color').value = hex(st.params.sun_color);
    document.getElementById('sky_color').value = hex(st.params.sky_color);
  }
}
refresh(true); setInterval(()=>refresh(false), 1000);
const img = document.getElementById('frame');
img.onclick = () => img.requestPointerLock();
document.addEventListener('pointerlockchange', () =>
  post({type:'grab', grabbed: document.pointerLockElement === img}));
document.addEventListener('mousemove', (e) => {
  if (document.pointerLockElement === img && (e.movementX||e.movementY))
    post({type:'look', dx:e.movementX, dy:e.movementY});
});
const KEYS = {KeyW:'w',KeyA:'a',KeyS:'s',KeyD:'d',KeyQ:'q',KeyE:'e',
  ShiftLeft:'shift',ControlLeft:'control',KeyR:'r',KeyP:'p'};
document.addEventListener('keydown', (e) => {
  const k = KEYS[e.code]; if (!k) return;
  if (k==='r') return post({type:'reset'});
  if (k==='p') return post({type:'snapshot'});
  post({type:'keydown', key:k});
});
document.addEventListener('keyup', (e) => {
  const k = KEYS[e.code]; if (k) post({type:'keyup', key:k});
});
</script></body></html>
"""


def make_handler(viewer: WebViewer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, mime="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", mime)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                self._send(200, PAGE.encode())
            elif self.path == "/state":
                self._send(
                    200,
                    json.dumps(viewer.state_json()).encode(),
                    "application/json",
                )
            elif self.path.startswith("/frame"):
                data, mime, _ = viewer.wait_frame(0)
                if not data:
                    self._send(503, b"no frame yet", "text/plain")
                else:
                    self._send(200, data, mime)
            elif self.path.startswith("/stream"):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=vtframe",
                )
                self.end_headers()
                seen = 0
                try:
                    while viewer.running or viewer.frame_no > seen:
                        data, mime, seen = viewer.wait_frame(seen)
                        if not data:
                            continue
                        self.wfile.write(
                            b"--vtframe\r\nContent-Type: "
                            + mime.encode()
                            + b"\r\nContent-Length: "
                            + str(len(data)).encode()
                            + b"\r\n\r\n"
                            + data
                            + b"\r\n"
                        )
                        if not viewer.running:
                            break
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/input":
                return self._send(404, b"not found", "text/plain")
            n = int(self.headers.get("Content-Length", 0))
            try:
                ev = json.loads(self.rfile.read(n) or b"{}")
                viewer.handle_event(ev)
            except (ValueError, TypeError, AttributeError) as e:
                # a malformed event from the client
                return self._send(400, str(e).encode(), "text/plain")
            self._send(200, b"{}", "application/json")

    return Handler


def serve(viewer: WebViewer, host="127.0.0.1", port=8089):
    server = ThreadingHTTPServer((host, port), make_handler(viewer))
    server.daemon_threads = True
    return server


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--scene", default="default")
    p.add_argument("--size", default="640x360", help="WIDTHxHEIGHT")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8089)
    p.add_argument("--denoise-radius", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (plain versions)")
    args = p.parse_args(argv)
    w, h = (int(v) for v in args.size.lower().split("x"))

    scenes = available_scenes()
    renderer = Renderer(
        scene=load_scene(args.scene), height=h, width=w, device=args.device,
        denoise_radius=args.denoise_radius, lean=True,
    )
    viewer = WebViewer(
        renderer,
        scenes=scenes,
        scene_idx=scenes.index(args.scene) if args.scene in scenes else 0,
        watcher=KernelWatcher(on_reload=renderer_hook(renderer)),
    )
    viewer.start()
    server = serve(viewer, args.host, args.port)
    print(f"voxtracer_torch web viewer on http://{args.host}:{args.port}/")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        viewer.stop()
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
