"""Interactive end-to-end throughput of the PyTorch port.

Counterpart of :mod:`voxtracer.app.ibench`: where ``app/bench.py``
times frames, this times what a person at a front end sees.

  * ``web``  — client-observed MJPEG fps: a headless client consumes
    frames from :class:`WebViewer` as the browser's ``/stream`` reader
    does (render → lookahead host copy → encode thread → latest-wins
    publish), while the camera rotates in place through the same
    ``look`` events the browser posts.  Encode overlap, dropped stale
    frames and the launch pipeline are all included.
  * ``tui``  — the terminal viewer's frame path (render + lookahead
    copy + vectorised ANSI half-block formatting) without curses, frames
    written to a sink.
  * ``wall`` — the pipelined loop's wall ms/frame against the device
    ms/frame of the same frames under ``torch.profiler`` (the sum of the
    device activities), plus the cost of one blocking fetch of a u8
    image, so that the wall/device residual is measured, not guessed.

The default rows are the reference's: web chr_knight and menger at
640x360, tui chr_knight at 256x144, wall chr_knight at 1280x720.  The
web rows run at denoise radius 2, what ``app/web.py`` serves by default
(the reference's rows run at 0), so that each of their frames runs the
trace, temporal and denoise kernels; the tui and wall rows at 0, the
terminal viewer's default.  Each row prints one JSON line with the
reference's keys, plus ``device``: the card's name and power limit as
``nvidia-smi`` gives them (or ``cpu``); the web rows also name the
frames' MIME type (JPEG where PIL imports, else PNG).

    python -m voxtracer_torch.app.ibench [--only web|tui|wall] [--seconds 6]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import torch

from ..engine.pipeline import Renderer
from ..engine.scene import load_scene
from ..utils.fetch import LookaheadFetch
from . import camera_paths
from .bench import _sync, device_label
from .input import FlyController

# the rows ``main`` runs without --only: (mode, scene, width, height)
ROWS = (
    ("web", "chr_knight", 640, 360),
    ("web", "menger", 640, 360),
    ("tui", "chr_knight", 256, 144),
    ("wall", "chr_knight", 1280, 720),
)


def _spin(viewer, dx: float = 3.0):
    """Post one slow-look mouse delta (rotating in place keeps the
    scene framed for minutes while still exercising the moving-camera
    reprojection path every frame)."""
    viewer.handle_event({"type": "grab", "grabbed": True})
    viewer.handle_event({"type": "look", "dx": dx, "dy": 0.0})


def _renderer(scene_name, w, h, device, radius=0):
    return Renderer(scene=load_scene(scene_name), height=h, width=w,
                    device=device, denoise_radius=radius, lean=True)


def _framed(renderer) -> FlyController:
    ctl = FlyController()
    ctl.frame(camera_paths.static(renderer.scene)(0.0))
    return ctl


def bench_web(scene_name: str, w: int, h: int, seconds: float,
              device="cuda", warmup_frames: int = 10,
              radius: int = 2) -> dict:
    """Client-observed fps from a live WebViewer loop."""
    from .web import WebViewer

    r = _renderer(scene_name, w, h, device, radius)
    viewer = WebViewer(r, scenes=[scene_name], controller=_framed(r))
    viewer.start()
    try:
        # frame-count based warm-up: the kernels' first build extends
        # it instead of eating the timed window
        seen = 0
        for _ in range(warmup_frames):
            _spin(viewer)
            _, _, seen = viewer.wait_frame(seen, timeout=300.0)
        viewer.reset_stage_stats()
        t0 = time.perf_counter()
        first = seen
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            _spin(viewer)
            _, _, seen = viewer.wait_frame(seen, timeout=120.0)
        dt = time.perf_counter() - t0
        frames = seen - first
        stages = viewer.stage_stats()
        mime = viewer.latest_mime
    finally:
        viewer.stop()
    if stages["errors"]:
        raise RuntimeError(f"{stages['errors']} frames failed in the web "
                           "viewer's loop")
    fps = frames / dt
    return dict(
        mode="web", scene=scene_name, resolution=f"{w}x{h}",
        frames=frames, seconds=round(dt, 2), fps=round(fps, 1),
        # where the loop's wall time goes: render call, wait for the
        # previous frame's host copy, encoder-thread ms, drops
        stages=stages,
        mime=mime,
        note="client-observed MJPEG fps, moving camera, encode "
             "included (latest-wins drops counted as dropped)",
    )


def bench_tui(scene_name: str, w: int, h: int, seconds: float,
              device="cuda") -> dict:
    """The terminal viewer's frame path, curses replaced by a byte sink
    (the real terminal's write cost varies by emulator; formatting —
    the part the port owns — is included)."""
    from .viewer import _halfblock_frame

    r = _renderer(scene_name, w, h, device)
    ctl = _framed(r)
    ctl.cursor_grabbed = True
    cam0 = ctl.camera

    def step():
        ctl.mouse_delta(3.0, 0.0)
        return r.render(ctl.update(0.0))

    # both kinds of frame (still, moving) once: the kernels build
    r.render(cam0)
    step()
    _sync(r.device)

    sink = 0
    frames = 0
    fetch = LookaheadFetch()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        got = fetch.push(step())
        if got is not None:
            sink += len(_halfblock_frame(got[0]))
            frames += 1
    # the last frame rendered, still in flight: a window shorter than two
    # frames would otherwise count none
    sink += len(_halfblock_frame(fetch.flush()[0]))
    frames += 1
    dt = time.perf_counter() - t0
    fps = frames / dt if dt > 0 else 0.0
    return dict(
        mode="tui", scene=scene_name, resolution=f"{w}x{h}",
        frames=frames, seconds=round(dt, 2), fps=round(fps, 1),
        note="render + lookahead fetch + ANSI half-block formatting "
             f"({sink / max(frames, 1) / 1e3:.0f} kB/frame to sink)",
    )


def bench_wall(scene_name: str, w: int, h: int, seconds: float,
               device="cuda") -> dict:
    """Pipelined wall ms/frame against profiled device ms/frame for the
    realtime loop, with the blocking-fetch cost measured separately so
    that the residual is attributed, not assumed."""
    from .profile import profile_frames

    r = _renderer(scene_name, w, h, device)
    ctl = _framed(r)
    ctl.cursor_grabbed = True
    cam0 = ctl.camera

    def cams():
        ctl.mouse_delta(3.0, 0.0)
        return ctl.update(0.0)

    r.render(cam0)
    r.render(cams())
    _sync(r.device)

    # pipelined loop: launch N+1 before waiting for N (the viewers' path)
    fetch = LookaheadFetch()
    frames = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        if fetch.push(r.render(cams())) is not None:
            frames += 1
    wall_ms = (time.perf_counter() - t0) / max(frames, 1) * 1e3
    fetch.flush()

    # one blocking image fetch, steady state.  Each fetch reads a
    # distinct frame: render n frames first (launched, not fetched),
    # drain the queue, then time one fetch each, so that no fetch times
    # a copy that is already done
    n = 5
    imgs = [r.render(cams())["image"] for _ in range(n)]
    r.render(cams())["image"].cpu()  # drain the queue
    t0 = time.perf_counter()
    for img in imgs:
        img.cpu().numpy()
    fetch_ms = (time.perf_counter() - t0) / n * 1e3

    # device time of the same loop's frames under the profiler
    logdir = tempfile.mkdtemp(prefix="voxibench_")
    try:
        rows = profile_frames(r, [cams() for _ in range(6)], logdir)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    device_ms = sum(ns for _, ns in rows) / 6 / 1e6

    return dict(
        mode="wall", scene=scene_name, resolution=f"{w}x{h}",
        wall_ms=round(wall_ms, 4), device_ms=round(device_ms, 4),
        fetch_ms=round(fetch_ms, 4),
        wall_over_device=round(wall_ms / max(device_ms, 1e-9), 2),
        fps=round(1e3 / wall_ms, 1),
        note="pipelined loop (lookahead fetch); fetch_ms = one blocking "
             "u8 image fetch, steady state (host-link cost per frame)",
    )


BENCHES = {"web": bench_web, "tui": bench_tui, "wall": bench_wall}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--only", choices=sorted(BENCHES), default=None)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (plain versions)")
    p.add_argument("--markdown", action="store_true")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is "
                         "False")
    label = device_label(device)

    rows = []
    for mode, scene, w, h in ROWS:
        if args.only not in (None, mode):
            continue
        row = BENCHES[mode](scene, w, h, args.seconds, device=device)
        row["device"] = label
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.markdown:
        print("\n| mode | scene | resolution | fps | detail |")
        print("|---|---|---|---|---|")
        for r in rows:
            detail = (
                f"wall {r['wall_ms']} ms / device {r['device_ms']} ms "
                f"(x{r['wall_over_device']}), fetch {r['fetch_ms']} ms"
                if r["mode"] == "wall" else r["note"]
            )
            print(f"| {r['mode']} | {r['scene']} | {r['resolution']} | "
                  f"{r['fps']} | {detail} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
