"""Headless render CLI of the PyTorch port: render frames along a
camera path (or at a fixed pose) and write the last one as a PNG.

Counterpart of :mod:`voxtracer.app.cli` (same flags, names and
defaults): still and scripted moving cameras, any denoise radius, the
offline export mode (``--batch N``: N frames per host call through
``Renderer.render_sequence``, on the card one CUDA-graph replay a
frame), every frame as a PNG (``--video-dir``), resumable snapshots
(``--save-snapshot``, ``--resume``), per-stage timing (``--stats``) and
a ``torch.profiler`` trace (``--profile DIR``), kernel hot-reload
during the run (``--watch-kernels``: ``voxtracer_torch/csrc/*.cu`` and
the kernel wrappers, polled once a frame and once a batch), and one
still from the legacy Whitted raytracer (``--legacy-whitted``, with
``--light``; on ``--device`` like every mode: the reference pins it to
the CPU).  ``--trace-impl`` and ``--batch-resample`` have no
counterpart: the device picks the trace implementation, and the
temporal kernel gathers history at any offset.

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
  python -m voxtracer_torch.app.cli --legacy-whitted --scene menger \\
      --size 1280x720 -o whitted.png
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
from ..engine.pipeline import Renderer, counters
from ..engine.reload import KernelWatcher, renderer_hook
from ..engine.scene import available_scenes, load_scene, load_voxels
from ..io.image import write_png
from ..ops.noise import blue_noise_buffer, white_noise_buffer
from ..utils import FpsCounter, StageTimer, setup_logging
from . import camera_paths

log = logging.getLogger("voxtracer_torch.app")


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
                      help="print per-stage timing and the run's counters "
                           "(launches a frame, graph captures and "
                           "replays, kernel builds, host waits, the scene "
                           "build) at the end")
    io_g.add_argument("--profile", default=None, metavar="DIR",
                      help="capture a torch.profiler trace of the render "
                           "loop into DIR (trace.json, chrome format)")
    io_g.add_argument("--legacy-whitted", action="store_true",
                      help="render one still with the legacy sorted-octant "
                           "Whitted raytracer (reference shaders/basic.frag) "
                           "instead of the path tracer")
    io_g.add_argument("--light", default="0.4,-0.4,0.02,0.05",
                      help="point light x,y,z,brightness for --legacy-whitted "
                           "(reference src/context.rs:944-947 defaults)")
    io_g.add_argument("--watch-kernels", action="store_true",
                      help="rebuild csrc/*.cu and reload the kernel wrappers "
                           "when their sources change")
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


def _check_args(args):
    if args.denoise_radius < 0:
        raise SystemExit(f"--denoise-radius must be >= 0, got "
                         f"{args.denoise_radius}")
    if args.frames < 1:
        raise SystemExit(f"--frames must be >= 1, got {args.frames}")
    if args.batch < 1:
        raise SystemExit(f"--batch must be >= 1, got {args.batch}")
    if len(_parse_vec(args.light)) != 4:
        raise SystemExit(f"--light takes x,y,z,brightness, got {args.light}")


@contextlib.contextmanager
def _profiled(directory, device):
    """A profiler trace of the block, written to
    ``directory/trace.json``; nothing where ``directory`` is None."""
    if directory is None:
        yield
        return
    os.makedirs(directory, exist_ok=True)
    # torch.autograd.profiler, the Kineto profiler under torch.profiler,
    # which imports torch._inductor (and Triton) each time it starts
    with torch.autograd.profiler.profile(
            use_device="cuda" if device.type == "cuda" else None,
            use_kineto=True) as prof:
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
    _check_args(args)

    width, height = (int(v) for v in args.size.lower().split("x"))
    # --stats prints the counters' growth from here: the scene build too
    counts = counters()
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

    if args.legacy_whitted:
        camera = fixed_cam if fixed_cam is not None else path(0.0)
        return _legacy_whitted(args, camera, width, height)

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

    watcher = (KernelWatcher(on_reload=renderer_hook(renderer))
               if args.watch_kernels else None)
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
                if watcher is not None:
                    watcher.poll()
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
            if watcher is not None:
                watcher.poll()
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
        print_counters(counts, counters(), args.frames)
    return 0


def print_counters(before, after, frames: int):
    """The counters' growth over a run of ``frames`` frames, launches
    also a frame."""
    for name, n in after.items():
        delta = n - before.get(name, 0)
        per = (f" ({delta / frames:.2f} a frame)"
               if name.startswith("launches.") and frames else "")
        print(f"  counter {name}: {delta}{per}")


def _legacy_whitted(args, camera, width, height) -> int:
    """One still from the legacy Whitted raytracer, written as a PNG."""
    from ..ops.whitted import render_scene

    *light_pos, light_brightness = _parse_vec(args.light)
    t0 = time.perf_counter()
    img = render_scene(
        load_voxels(args.scene), camera, width, height,
        light_pos=tuple(light_pos), light_brightness=light_brightness,
        device=args.device,
    ).cpu().numpy()  # waits for the device
    seconds = time.perf_counter() - t0
    write_png(args.output, np.clip(img * 255.0, 0, 255).astype(np.uint8))
    print(f"legacy whitted still at {width}x{height} in {seconds:.2f}s "
          f"(device={torch.device(args.device).type}) -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
