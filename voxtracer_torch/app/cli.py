"""Headless render CLI of the PyTorch port: render frames along a
camera path (or at a fixed pose) and write the last one as a PNG.

Counterpart of :mod:`voxtracer.app.cli` (same flags, names and
defaults): still and scripted moving cameras, any denoise radius, the
offline export mode (``--batch N``: N frames per host call through
``Renderer.render_sequence``, on the card one CUDA-graph replay a
frame), every frame as a PNG (``--video-dir``), resumable snapshots
(``--save-snapshot``, ``--resume``), per-stage timing (``--stats``) and
a ``torch.profiler`` trace (``--profile DIR``).  ``--trace-impl`` and
``--batch-resample`` have no counterpart: the device picks the trace
implementation, and the temporal kernel gathers history at any offset.
The legacy Whitted mode and kernel hot-reload are not ported yet and
exit with a message.

Examples:
  python -m voxtracer_torch.app.cli --device cuda --scene menger \\
      --size 1280x720 --frames 32 -o out.png
  python -m voxtracer_torch.app.cli --device cuda --scene monu9 \\
      --size 1920x1080 --path dolly --denoise-radius 2 --frames 120 \\
      --batch 24 --video-dir frames/ -o m.png
  python -m voxtracer_torch.app.cli --device cpu --scene 8x8x8 \\
      --size 64x64 --frames 4 --save-snapshot s.npz -o small.png
  python -m voxtracer_torch.app.cli --device cpu --scene 8x8x8 \\
      --size 64x64 --frames 4 --resume s.npz --stats -o small.png
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time

import numpy as np
import torch

from ..engine import snapshot as snapshot_mod
from ..engine.camera import Camera
from ..engine.params import DenoiseParams, RenderParams, TemporalParams
from ..engine.pipeline import Renderer
from ..engine.scene import available_scenes, load_scene
from ..io.image import write_png
from ..ops.noise import blue_noise_buffer, white_noise_buffer
from ..utils import FpsCounter, StageTimer, setup_logging
from . import camera_paths

log = logging.getLogger("voxtracer_torch.app")

NOT_PORTED = "not yet ported to the PyTorch port"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="voxtracer_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--scene", default="default",
                   help="scene name from assets/vox, a .vox path, or 'default'")
    p.add_argument("--list-scenes", action="store_true")
    p.add_argument("--size", default="1280x720", help="WIDTHxHEIGHT")
    p.add_argument("--frames", type=int, default=16,
                   help="frames to render")
    p.add_argument("--batch", type=int, default=1,
                   help="render frames in batches of this size, one host "
                        "call per batch (on the card each frame is one "
                        "replay of a captured CUDA graph): the offline "
                        "export mode; 1 = the per-frame loop")
    p.add_argument("-o", "--output", default="frame.png",
                   help="output PNG for the final frame")
    p.add_argument("--video-dir", default=None,
                   help="also write every frame as PNG into this directory")
    p.add_argument("--path", default="static",
                   choices=["dolly", "orbit", "static"],
                   help="scripted camera path")
    p.add_argument("--fps-target", type=float, default=30.0,
                   help="camera-path playback rate (frames advance 1/fps)")
    p.add_argument("--camera-pos", default=None,
                   help="explicit camera position 'x,y,z' (overrides --path)")
    p.add_argument("--camera-dir", default=None,
                   help="explicit camera direction 'x,y,z'")
    p.add_argument("--fov", type=float, default=70.0, help="degrees")
    p.add_argument("--noise", default="blue", choices=["blue", "white"],
                   help="RNG source")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' runs the CUDA trace kernel, "
                        "'cpu' its plain torch version")

    scene_g = p.add_argument_group("scene / lighting")
    scene_g.add_argument("--sun-strength", type=float, default=4.0,
                         help="0..10")
    scene_g.add_argument("--sun-size", type=float, default=0.05, help="0..1")
    scene_g.add_argument("--sun-yaw", type=float, default=None,
                         help="degrees 0..360 (default 75.6)")
    scene_g.add_argument("--sun-pitch", type=float, default=None,
                         help="degrees -90..90 (default 57.3)")
    scene_g.add_argument("--sun-color", default="1,1,1")
    scene_g.add_argument("--sky-color", default="0.45,0.6,0.65")
    scene_g.add_argument("--emit-strength", type=float, default=4.0,
                         help="0..40")
    scene_g.add_argument("--specularity", type=float, default=0.0,
                         help="0..1")

    ren_g = p.add_argument_group("renderer")
    ren_g.add_argument("--temporal-factor", type=float, default=0.5,
                       help="sample blending 0..1")
    ren_g.add_argument("--temporal-max", type=float, default=0.98,
                       help="maximum blending 0..1")
    ren_g.add_argument("--temporal-cutoff", type=float, default=1e-2,
                       help="blending distance cutoff (log scale 0..1)")
    ren_g.add_argument("--denoise-radius", type=int, default=0,
                       help="0..8")
    ren_g.add_argument("--sigma-distance", type=float, default=2.0,
                       help="0.1..5")
    ren_g.add_argument("--sigma-range", type=float, default=1.5,
                       help="0.1..5")
    ren_g.add_argument("--albedo", type=float, default=1.0,
                       help="albedo composition factor 0..1")

    io_g = p.add_argument_group("session")
    io_g.add_argument("--save-snapshot", default=None,
                      help="write a resumable snapshot (.npz) at the end")
    io_g.add_argument("--resume", default=None,
                      help="resume accumulation from a snapshot")
    io_g.add_argument("--stats", action="store_true",
                      help="print per-stage timing at the end")
    io_g.add_argument("--profile", default=None, metavar="DIR",
                      help="capture a torch.profiler trace of the render "
                           "loop into DIR (trace.json, chrome format)")
    io_g.add_argument("--legacy-whitted", action="store_true",
                      help="(not ported yet)")
    io_g.add_argument("--watch-kernels", action="store_true",
                      help="(not ported yet)")
    return p


def _parse_vec(text):
    return tuple(float(v) for v in text.split(","))


def make_params(args) -> RenderParams:
    kwargs = dict(
        emit_strength=args.emit_strength,
        sun_strength=args.sun_strength,
        sun_size=args.sun_size,
        sun_color=_parse_vec(args.sun_color),
        sky_color=_parse_vec(args.sky_color),
        specularity=args.specularity,
    )
    if args.sun_yaw is not None:
        kwargs["sun_yaw"] = np.radians(args.sun_yaw)
    if args.sun_pitch is not None:
        kwargs["sun_pitch"] = np.radians(args.sun_pitch)
    return RenderParams(**kwargs)


def _refuse_unported(args):
    if args.denoise_radius < 0:
        raise SystemExit(f"--denoise-radius must be >= 0, got "
                         f"{args.denoise_radius}")
    if args.frames < 1:
        raise SystemExit(f"--frames must be >= 1, got {args.frames}")
    if args.batch < 1:
        raise SystemExit(f"--batch must be >= 1, got {args.batch}")
    if args.legacy_whitted:
        raise SystemExit(f"--legacy-whitted is {NOT_PORTED} (ROADMAP Queue 1 #6)")
    if args.watch_kernels:
        raise SystemExit(f"--watch-kernels is {NOT_PORTED} (ROADMAP Queue 1 #4)")


@contextlib.contextmanager
def _profiled(directory, device):
    """A ``torch.profiler`` trace of the block, written to
    ``directory/trace.json``; nothing where ``directory`` is None."""
    if directory is None:
        yield
        return
    os.makedirs(directory, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))
    log.info("profiler trace written to %s", directory)


def main(argv=None) -> int:
    setup_logging()
    args = build_parser().parse_args(argv)
    if args.list_scenes:
        print("\n".join(["default"] + available_scenes()))
        return 0
    _refuse_unported(args)

    width, height = (int(v) for v in args.size.lower().split("x"))
    try:
        scene = load_scene(args.scene)
    except ValueError as e:
        raise SystemExit(str(e))
    fixed_cam = None
    if args.camera_pos is not None:
        direction = _parse_vec(args.camera_dir) if args.camera_dir else (0, 0, 1)
        fixed_cam = Camera(
            position=np.array(_parse_vec(args.camera_pos)),
            direction=np.array(direction),
            fov=np.radians(args.fov),
        )
    path = camera_paths.PATHS[args.path](scene)

    renderer = Renderer(
        scene=scene,
        height=height,
        width=width,
        device=args.device,
        render_params=make_params(args),
        temporal_params=TemporalParams(
            sample_blending=args.temporal_factor,
            maximum_blending=args.temporal_max,
            blending_distance_cutoff=args.temporal_cutoff,
        ),
        denoise_params=DenoiseParams(
            sigma_distance=args.sigma_distance,
            sigma_range=args.sigma_range,
            albedo_factor=args.albedo,
        ),
        denoise_radius=args.denoise_radius,
        noise_buffer=(
            blue_noise_buffer() if args.noise == "blue" else white_noise_buffer()
        ),
        lean=True,
    )

    start_frame = 0
    if args.resume:
        fixed_cam = snapshot_mod.load(args.resume, renderer)
        start_frame = renderer.frame_number
        log.info("resumed at frame %d", start_frame)

    if args.video_dir:
        os.makedirs(args.video_dir, exist_ok=True)

    def camera_at(i):
        if fixed_cam is not None:
            return fixed_cam
        return path((start_frame + i) / args.fps_target)

    def write_frame(i, image):
        write_png(
            os.path.join(args.video_dir, f"frame_{start_frame + i:05d}.png"),
            image.cpu().numpy(),
        )

    fps = FpsCounter()
    timer = StageTimer()
    image = None
    camera = fixed_cam
    # Stages are closed by a device synchronise only under --stats: a
    # wait per frame would keep the host from running ahead of the card.
    with _profiled(args.profile, renderer.device):
        t_start = time.perf_counter()
        batched = 0
        if args.batch > 1:
            # The export mode: one host call per batch.  The remainder
            # (< batch frames) goes through the per-frame loop below.
            while args.frames - batched >= args.batch:
                cams = [camera_at(batched + j) for j in range(args.batch)]
                frames_u8 = timer.measure(
                    "batch", renderer.render_sequence, cams,
                    sync=(lambda o: o) if args.stats else None,
                )
                camera = cams[-1]
                for _ in range(args.batch):
                    fps.tick()
                if args.video_dir:
                    for j, img in enumerate(frames_u8):
                        write_frame(batched + j, img)
                image = frames_u8[-1]
                batched += args.batch
        for i in range(batched, args.frames):
            camera = camera_at(i)
            out = timer.measure(
                "frame", renderer.render, camera,
                sync=(lambda o: o["image"]) if args.stats else None,
            )
            fps.tick()
            image = out["image"]
            if args.video_dir:
                write_frame(i, image)
        final = image.cpu().numpy()  # waits for the device
        wall = time.perf_counter() - t_start

    write_png(args.output, final)
    print(
        f"rendered {args.frames} frames at {width}x{height} in {wall:.2f}s "
        f"({args.frames / wall:.2f} fps, kernel={renderer.device.type}) "
        f"-> {args.output}"
    )

    if args.save_snapshot:
        snapshot_mod.save(args.save_snapshot, renderer, camera)
        log.info("snapshot saved to %s", args.save_snapshot)

    if args.stats:
        for name, avg in timer.report().items():
            print(f"  stage {name}: {avg * 1e3:.2f} ms avg")
    return 0


if __name__ == "__main__":
    sys.exit(main())
