"""BASELINE measurement harness of the PyTorch port: configs 1-6.

Counterpart of :mod:`voxtracer.app.bench`.  Runs each config of
``BASELINE.md`` and prints one JSON line per config (config 6: per
asset) with the reference harness's keys, plus ``device``: the card's
name and power limit as ``nvidia-smi`` gives them, or ``cpu``.  Config
1 is the correctness gate (the trace against the numpy oracle); configs
2-5 are throughput; config 6 sweeps every shipped asset.

Frame times: a warm pass over the whole camera sequence, then the best
of two timed passes of lean frames on the host clock, each ending in a
device synchronise; then one full render supplies the G-buffer.  Stage
times (config 4): CUDA events around 5 calls after one warm call.
Exact rays come from the trace's per-phase counters on one sample
(:func:`voxtracer_torch.app.phasestats.phase_stats`).

Each config is a generator of its JSON rows.  A config that raises
prints its error line; the others still run, and the harness exits
non-zero.  ``SIZES`` holds every config's sizes.

Run: ``python -m voxtracer_torch.app.bench [--quick] [--skip 5]
[--only 1 4] [--device cuda]``
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from voxtracer.oracle import renderer as oracle
from voxtracer.ops.noise import noise_planes

from ..engine.camera import Camera
from ..engine.params import (
    DenoiseParams,
    RenderParams,
    TemporalParams,
    pack_denoise_params,
    pack_trace_params,
)
from ..engine.pipeline import Renderer
from ..engine.scene import SceneTables, available_scenes, load_scene
from ..ops import denoise as denoise_op
from ..ops import temporal as temporal_op
from ..ops import tonemap
from ..ops import trace as trace_op
from ..ops.noise import blue_noise_buffer, white_noise_buffer
from . import camera_paths
from .phasestats import phase_stats

# Per config: image (height, width) and timed frames, in full and with
# --quick (a missing quick entry keeps the full one); config 6 adds the
# oracle-agreement crop.
SIZES = {
    1: {"hw": (256, 256), "quick_hw": (128, 128)},
    2: {"hw": (720, 1280), "frames": 10, "quick_frames": 4},
    3: {"hw": (720, 1280), "frames": 10, "quick_frames": 4},
    4: {"hw": (1080, 1920), "frames": 8, "quick_frames": 3},
    5: {"hw": (2160, 3840), "frames": 4, "quick_frames": 2},
    6: {"hw": (360, 640), "quick_hw": (180, 320), "frames": 5,
        "quick_frames": 2, "crop": (72, 128)},
}


def _size(idx, quick):
    """A config's ((height, width), timed frames)."""
    s = SIZES[idx]
    if quick:
        return s.get("quick_hw", s["hw"]), s.get("quick_frames", s.get("frames"))
    return s["hw"], s.get("frames")


def device_label(device: torch.device) -> str:
    """The card's name and power limit, or the device type."""
    if device.type != "cuda":
        return device.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_frames(renderer, cameras, per_frame=None):
    """Seconds per frame (best of two timed passes over ``cameras[1:]``
    after a warm pass over all of them) and a full render of the last
    camera.  ``per_frame(i)`` may change live parameters before frame
    ``i`` (config 5's animated sun)."""
    def run(pass_cams, start):
        for i, cam in enumerate(pass_cams, start):
            if per_frame is not None:
                per_frame(i)
            renderer.render(cam, lean=True)
        _sync(renderer.device)

    run(cameras, 0)
    dt = None
    for _ in range(2):
        t0 = time.perf_counter()
        run(cameras[1:], 1)
        cand = (time.perf_counter() - t0) / max(1, len(cameras) - 1)
        dt = cand if dt is None else min(dt, cand)
    return dt, renderer.render(cameras[-1], lean=False)


def _stage_ms(fn, device, n=5):
    """Mean ms of ``n`` calls after one warm call: CUDA events on the
    card, the host clock elsewhere."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def _exact_rays(scene, cam, h, w, device):
    """Exact rays of one sample from the trace's per-phase counters."""
    return sum(r["rays"] for r in phase_stats(scene, cam, h, w, device))


def _rate(dt, rays):
    return dict(ms_per_frame=dt * 1e3, fps=1 / dt, rays_per_frame=round(rays),
                mrays_per_s=rays / dt / 1e6)


def _oracle_and_trace(scene, cam, h, w, seed, device):
    """The numpy oracle's and the port trace's sample (white noise of
    ``seed``, frame 1) at ``h`` x ``w``; the trace's planes channels-last."""
    params = RenderParams()
    right, up, forward = cam.axis_scaled(w, h)
    buf = white_noise_buffer(seed=seed)
    o = oracle.render_sample(
        scene.values, scene.origin.astype(np.int64),
        np.asarray(cam.position, np.float64), right, up, forward, params,
        noise_planes(buf, 1, h, w), w, h,
    )
    x = trace_op.render_sample(
        SceneTables(scene, device), pack_trace_params(cam.rows(w, h), params),
        torch.from_numpy(buf).to(device), 1, h, w,
    )
    x = {k: v.cpu().numpy() for k, v in x.items()}
    for k in ("color", "normal", "albedo"):
        x[k] = np.moveaxis(x[k], 0, -1)
    return o, x


def config1_oracle_match(device, quick=False):
    """8x8x8.vox, 1 spp, static camera: the trace against the oracle."""
    (h, w), _ = _size(1, quick)
    cam = Camera(position=np.array([2.0, 3.0, -4.0]),
                 direction=np.array([0.2, 0.1, 1.0]))
    o, x = _oracle_and_trace(load_scene("8x8x8"), cam, h, w, 7, device)
    agree = float((o["node"] == x["node"]).mean())
    err = (x["color"] - o["color"]).astype(np.float64)
    mse = float(np.mean(err**2))
    psnr = 10 * np.log10(max(1.0, float(o["color"].max())) ** 2
                         / max(mse, 1e-12))
    yield dict(config=1, name="8x8x8 oracle match", resolution=f"{w}x{h}",
               node_agreement=agree, color_psnr_db=psnr)


def config2_menger(device, quick=False):
    (h, w), frames = _size(2, quick)
    scene = load_scene("menger")
    r = Renderer(scene=scene, height=h, width=w, device=device)
    cam = Camera(position=np.array([36.0, 34.0, -5.0]),
                 direction=np.array([-16.0, -14.0, 25.0]))
    dt, _ = _time_frames(r, [cam] * (frames + 1))
    rays = _exact_rays(scene, cam, h, w, device)
    yield dict(config=2, name="menger 720p progressive", **_rate(dt, rays))


def config3_knight_temporal(device, quick=False):
    (h, w), frames = _size(3, quick)
    scene = load_scene("chr_knight")
    r = Renderer(scene=scene, height=h, width=w, device=device)
    path = camera_paths.orbit(scene)
    cams = [path(i / 30.0) for i in range(frames + 1)]
    dt, _ = _time_frames(r, cams)
    blend = r.state["accum_blend"]
    rays = _exact_rays(scene, cams[-1], h, w, device)
    yield dict(config=3, name="chr_knight 720p temporal reprojection (orbit)",
               **_rate(dt, rays),
               reprojection_accepted=float((blend < 1.0).float().mean()))


def config4_monu9_full(device, quick=False):
    (h, w), frames = _size(4, quick)
    scene = load_scene("monu9")
    r = Renderer(scene=scene, height=h, width=w, device=device,
                 denoise_radius=2)
    path = camera_paths.dolly(scene)
    cams = [path(i / 30.0) for i in range(frames + 1)]
    dt, out = _time_frames(r, cams)

    # each stage alone on the last frame's G-buffer: the reprojecting
    # blend around the resampler of this device, the r=2 stencil, the u8
    # encode.  temporal_reproject is the channels-last blend (plain torch
    # ops around the resample kernel), kept for the reference harness's
    # key; the renderer's frames never run it, their temporal cost is
    # the temporal kernel's (csrc/temporal.cu).
    cam = cams[-1].rows(w, h)
    gC, gN, gD = out["trace_color"], out["normal"], out["depth"]
    planar = [torch.movedim(t, -1, 0).contiguous()
              for t in (gC, out["normal"], out["albedo"])]
    half = gD * 0 + 0.5
    t_temporal = _stage_ms(lambda: temporal_op.temporal_blend(
        gC, gN, gD, gC, half, gD, cam, cam, TemporalParams(), True,
        reproject=True), device)
    dparams = pack_denoise_params(cam, DenoiseParams())
    t_denoise = _stage_ms(lambda: denoise_op.denoise(
        planar[0], planar[1], gD, planar[2], out["node"], dparams, 2), device)
    t_tone = _stage_ms(lambda: tonemap.to_u8(gC), device)

    rays = _exact_rays(scene, cams[-1], h, w, device)
    yield dict(
        config=4,
        name="monu9 1080p full pipeline (trace+temporal+denoise r=2)",
        **_rate(dt, rays),
        standalone_stage_ms_incl_dispatch={
            "temporal_reproject": t_temporal,
            "denoise_r2": t_denoise,
            "tonemap_u8": t_tone,
        },
    )


def config5_castle_4k(device, quick=False):
    (h, w), frames = _size(5, quick)
    scene = load_scene("castle")
    r = Renderer(scene=scene, height=h, width=w, device=device)
    cam = camera_paths.static(scene)(0.0)

    def sun_sweep(i):
        # animated sun: yaw sweeps while the camera holds still
        r.render_params = dataclasses.replace(r.render_params,
                                              sun_yaw=1.32 + 0.05 * i)

    dt, _ = _time_frames(r, [cam] * (frames + 1), per_frame=sun_sweep)
    rays = _exact_rays(scene, cam, h, w, device)
    yield dict(config=5, name="castle 4K animated sun (stretch)",
               **_rate(dt, rays))


def config6_asset_sweep(device, quick=False):
    """Every shipped .vox asset through the full pipeline: fps, the
    pixels that hit the step cap (fused leaves) and node agreement with
    the oracle on a small crop (white noise of seed 3)."""
    (h, w), frames = _size(6, quick)
    ch, cw = SIZES[6]["crop"]
    noise = blue_noise_buffer()  # the Renderer's default, loaded once
    for name in available_scenes():
        scene = load_scene(name)
        cam = camera_paths.orbit(scene)(0.15)
        r = Renderer(scene=scene, height=h, width=w, device=device,
                     noise_buffer=noise)
        dt, out = _time_frames(r, [cam] * (frames + 2))
        fuse_px = int((out["node"] == trace_op.LEAF_BIT).sum())
        o, x = _oracle_and_trace(scene, cam, ch, cw, 3, device)
        yield dict(
            config=6, name=f"asset sweep: {name}", resolution=f"{w}x{h}",
            ms_per_frame=dt * 1e3, fps=1 / dt, fuse_pixels=fuse_px,
            node_agreement=float((o["node"] == x["node"]).mean()),
        )


CONFIGS = {
    1: config1_oracle_match,
    2: config2_menger,
    3: config3_knight_temporal,
    4: config4_monu9_full,
    5: config5_castle_4k,
    6: config6_asset_sweep,
}


def _emit(**kv):
    print(json.dumps(kv), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--quick", action="store_true")
    p.add_argument("--skip", type=int, nargs="*", default=[])
    p.add_argument("--only", type=int, nargs="*", default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (plain versions)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False")
    label = device_label(device)
    failed = []
    for idx, fn in CONFIGS.items():
        if idx in args.skip or (args.only and idx not in args.only):
            continue
        try:
            for row in fn(device, quick=args.quick):
                _emit(**row, device=label)
        except Exception as e:  # report, measure the rest, fail at the end
            traceback.print_exc()
            _emit(config=idx, error=f"{type(e).__name__}: {e}"[:300],
                  device=label)
            failed.append(idx)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
