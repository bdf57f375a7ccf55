"""What a frame costs the host and the device, in two trees or more.

    python voxtracer_torch/app/renderbench.py --compare OTHER_TREE [...]

renders configs 2, 3, 4 and 5 (menger 1280x720 still r=0, chr_knight
1280x720 orbit r=0, monu9 1920x1080 dolly r=2, castle 3840x2160 still
r=0) in fresh processes, in turns: the other trees, this tree twice, the
other trees in reverse order (each a checkout of another commit that
holds a ``voxtracer_torch`` package; its lines are labelled with its
directory's name).  Each process prints one JSON line a config:

* the per-frame loop: the host's microseconds per ``render()`` call
  (wall clock around a burst of calls that waits for nothing; the device
  is synchronised between bursts, and a burst's launches fit the launch
  queue) and the ms/frame of the same bursts from CUDA events, medians
  over the bursts;
* the same path through ``render_burst`` (still) or ``render_sequence``
  (moving): ms/frame from CUDA events, median over bursts of 12 after a
  warm one that captures the graphs;
* for each of the two, from one ``torch.profiler`` range of 12 further
  frames (``app/profile.py`` ``profile_range``): the device time a frame
  (the union of its activities), the busy share (device time over the
  range's wall time) and the device activities (kernels, copies, fills)
  a frame.

The loop renders the path's first 213 frames and profiles the next 12;
the sequence renders its first 60 (the last 12 profiled): on a moving
path the two see other positions, so compare each across trees.

Without ``--compare``, one process measures ``--tree`` (default: the
tree this file is in).

    python voxtracer_torch/app/renderbench.py --kernels [--compare OTHER]

times the trace, temporal, denoise and still epilogue kernels of each
tree at one device, on the main path's inputs (:func:`kernel_cases`):
one JSON line a case, the kernel's ms on the device alone (20 launches
replayed from a CUDA graph) and over 20 eager calls.  These kernels
take a slab's rows (``voxtracer_torch/parallel/mesh.py``); the
one-device calls leave those arguments at their defaults, so trees
without them run the same cases.

    python voxtracer_torch/app/renderbench.py --epilogue [--compare OTHER]

times the frame epilogue's two kernels (``csrc/epilogue.cu``) of each
tree instead, on the planes the main path gives them
(:func:`epilogue_cases`; ``chip_smoke.py`` phase 19 times the same
cases) and on uniform 1920x1080 planes that take the sRGB curve's linear
branch and its ``powf``.  One JSON line a case
(:func:`time_epilogue_case`): the kernel's ms three ways,

* ``eager_ms``: 20 calls of the Python wrapper between CUDA events (the
  wrapper's host time included wherever it outlasts the kernel);
* ``ms``: 20 calls captured into one CUDA graph, their outputs allocated
  once in its pool, replayed 5 times between CUDA events: the device
  alone, each launch finding in the 50 MB L2 what the one before left;
* ``frame_cache_ms``: the kernel's activities in one profiled replay of
  a graph that evicts the L2 and rewrites the planes the kernel before
  it writes in a frame, before each launch: the frame's cache state;

the bound on this run's data (``bound_ms``: the bytes the function needs
on these planes over 3.35 TB/s, 47-79 B a pixel for the still epilogue
by whether a pixel hits and keeps its history, 15 / 27 B for the encode
without / with the albedo; or its float32 operations over 67 TFLOP/s)
and its share of each time, the fixed
bound (``fixed_bound_ms``: 79 B a pixel whatever the data) and the share of
sky (miss) pixels.  Last, a device copy moving as many bytes as the 4K
still epilogue: the share of 3.35 TB/s the memory reaches.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = (
    ("config 2", "menger", 1280, 720, "static", 0),
    ("config 3", "chr_knight", 1280, 720, "orbit", 0),
    ("config 4", "monu9", 1920, 1080, "dolly", 2),
    ("config 5", "castle", 3840, 2160, "static", 0),
)
WARMUP, BURSTS, FRAMES = 3, 7, 30
SEQ_BURSTS, SEQ_FRAMES = 3, 12


def _events():
    import torch

    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _profiled(advance, device, n):
    """Device ms a frame, busy share and device activities a frame of
    ``advance()`` (``n`` frames) under one profiled range."""
    from voxtracer_torch.app.profile import profile_range

    wall_us, dev, busy_us = profile_range(advance, device)
    return {"device_ms": busy_us / 1e3 / n, "busy_share": busy_us / wall_us,
            "activities": len(dev) / n}


EPILOGUE_CALLS, EPILOGUE_REPLAYS = 20, 5
L2_SCRUB_BYTES = 128 << 20  # over twice the H100's 50 MB L2
# float32 operations of the still epilogue a pixel: the validity test
# (~95, run on a hit with live history) and the modulate and encode
# (~85, three powf included); of the encode a pixel
TEST_FLOPS_PER_PX, TAIL_FLOPS_PER_PX = 95, 85
ENCODE_FLOPS_PER_PX = 80


def epilogue_bytes(h, w, albedo=True, linear=False):
    """The still epilogue's bytes at their most, whatever the data: 12 float32 planes read (colour, normal, old colour, depth, old
    blend, old depth), 4 written (blend, next blend); with albedo 3 more
    read, the u8 image written and, with the linear, 3 more written:
    79 B a pixel at r = 0."""
    nbytes = 4 * 12 + 4 * 4
    if albedo:
        nbytes += 4 * 3 + 3 + (4 * 3 if linear else 0)
    return nbytes * h * w


def still_kept(planes, row):
    """Where the still epilogue keeps the history (``valid``: a hit with
    live history at the same position) on ``planes`` (colour, normal,
    depth, old colour, old blend, old depth) and the frame's numpy row:
    the plain still blend of white over black history with old blend 2,
    which blends to 2 exactly where the history is kept."""
    import torch
    from voxtracer_torch.ops.temporal import temporal_blend_still_row

    _, normal, depth, _, _, old_depth = planes
    blended, _ = temporal_blend_still_row(
        torch.ones_like(planes[0]), normal, depth, torch.zeros_like(planes[0]),
        torch.full_like(depth, 2.0), old_depth, row)
    return blended[0] == 2.0


def still_bytes(depth, kept, history_valid, albedo=True, linear=False):
    """What the still epilogue must move on this frame's data: every
    pixel reads colour and depth and writes blend and next blend (with
    albedo it also reads the albedo and writes the u8 image and, with the
    linear, the linear); a hit with live history also reads the normal
    and the old depth, which decide whether it keeps its history, and a
    pixel that keeps it also reads the old colour and old blend.  At
    r = 0: 47 B a miss or a pixel without history, 63 B a hit whose
    history is not kept, 79 B one whose history is."""
    n = depth.numel()
    tested = int((depth >= 0).sum()) if history_valid else 0
    nbytes = (4 * 4 + 4 * 4) * n + 16 * tested + 16 * int(kept.sum())
    if albedo:
        nbytes += (4 * 3 + 3 + (4 * 3 if linear else 0)) * n
    return nbytes


def still_flops(depth, history_valid, albedo=True):
    """The still epilogue's float32 operations on this frame's data."""
    tested = int((depth >= 0).sum()) if history_valid else 0
    return TEST_FLOPS_PER_PX * tested + (
        TAIL_FLOPS_PER_PX * depth.numel() if albedo else 0)


def encode_bytes(h, w, albedo, linear=False):
    """What the encode must move: 3 float32 planes read (3 more with the
    albedo), the u8 image written (and the modulated linear)."""
    return (4 * 3 + (4 * 3 if albedo else 0) + 3
            + (4 * 3 if albedo and linear else 0)) * h * w


def eager_ms(fn, n=EPILOGUE_CALLS):
    """Mean ms of ``n`` eager calls of ``fn`` between CUDA events."""
    start, end = _events()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n=EPILOGUE_CALLS, replays=EPILOGUE_REPLAYS):
    """The device's ms a call of ``fn`` (a kernel's wrapper) from ``n``
    calls captured into one CUDA graph, whose outputs the graph's pool
    allocates once (each call's are dropped before the next), replayed
    ``replays`` times between CUDA events after one warm replay.  The
    wrapper's host work runs once, at the capture.  Back to back, the
    launches find in the L2 whatever of their planes it holds."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = _events()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * replays)


def frame_cache_ms(fn, name, warm, n=EPILOGUE_CALLS):
    """The mean device ms of the kernel named ``*name*`` that ``fn``
    launches, in the cache state a frame leaves it: ``n`` calls captured
    into one CUDA graph, each after a write of ``L2_SCRUB_BYTES`` (which
    evicts the L2, as a frame's other kernels do to the history a frame
    on) and a rewrite of the planes ``warm`` (``mul_(1)``: what the
    kernel before it has just written), the kernel's activities read from
    one profiled replay (``app/profile.py`` ``profile_range``)."""
    import torch
    from voxtracer_torch.app.profile import profile_range

    scrub = torch.empty(L2_SCRUB_BYTES // 4, device="cuda")

    def call():
        scrub.fill_(1.0)
        for t in warm:
            t.mul_(1.0)
        fn()

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            call()
    graph.replay()
    _, dev, _ = profile_range(graph.replay, torch.device("cuda"))
    runs = [e.time_range.elapsed_us() for e in dev if name in e.name]
    assert runs, f"no activity named *{name}* in the profiled replay"
    return sum(runs) / len(runs) / 1e3


def time_epilogue_case(case):
    """One timed case of :func:`epilogue_cases`: the kernel's ms over
    eager calls of its wrapper (the host's enqueue included wherever it
    outlasts the kernel), on the device alone replayed back to back
    (``graph_ms``) and in the frame's cache state (``frame_cache_ms``);
    the bound on this run's data and its share of each time; the fixed
    bound (the bytes a pixel whatever the data) and its share of the
    replayed time."""
    from voxtracer_torch.app.denoisebench import FP32_FLOPS_PER_S
    from voxtracer_torch.app.tracebench import bound

    fn = case["fn"]
    t = {"eager_ms": eager_ms(fn), "ms": graph_ms(fn),
         "frame_cache_ms": frame_cache_ms(fn, case["name"], case["warm"])}
    b, by = bound(case["bytes"], case["flops"], FP32_FLOPS_PER_S)
    fixed, _ = bound(case["fixed_bytes"], case["flops"], FP32_FLOPS_PER_S)
    return {**t, "bound_ms": b, "bound_by": by, "share": b / t["ms"],
            "share_frame_cache": b / t["frame_cache_ms"],
            "share_eager": b / t["eager_ms"], "fixed_bound_ms": fixed,
            "fixed_share": fixed / t["ms"],
            "bytes_per_px": case["bytes"] / case["pixels"]}


def still_case(case, planes, albedo, row, valid, timed=True):
    """A still-epilogue case of :func:`epilogue_cases` on ``planes``
    (colour, normal, depth, old colour, old blend, old depth), the albedo
    (or None: the blend alone) and the frame's numpy row."""
    from voxtracer_torch.ops import epilogue

    h, w = planes[2].shape
    args = (*planes, albedo, row)
    c = {"kernel": "still epilogue", "case": case, "size": f"{w}x{h}",
         "history_valid": valid, "args": args, "timed": timed,
         "miss_share": float((planes[2] < 0).float().mean())}
    if timed:
        c.update(fn=lambda: epilogue.still_epilogue_cuda(*args),
                 name="still_epilogue_kernel",
                 warm=(planes[0], planes[1], planes[2], albedo),
                 bytes=still_bytes(planes[2], still_kept(planes, row), valid),
                 flops=still_flops(planes[2], valid),
                 fixed_bytes=epilogue_bytes(h, w), pixels=h * w)
    return c


def encode_case(case, args, depth):
    """A timed encode case of :func:`epilogue_cases` on the wrapper's
    ``args`` (linear, height, width[, albedo, row]); ``depth`` gives the
    miss share."""
    from voxtracer_torch.ops import epilogue

    h, w = args[1], args[2]
    albedo = len(args) > 3
    return {"kernel": "encode", "case": case, "size": f"{w}x{h}",
            "history_valid": True, "args": args, "timed": True,
            "miss_share": float((depth < 0).float().mean()),
            "fn": lambda: epilogue.encode_cuda(*args), "name": "encode_kernel",
            "warm": (args[0],), "bytes": encode_bytes(h, w, albedo),
            "flops": ENCODE_FLOPS_PER_PX * h * w,
            "fixed_bytes": encode_bytes(h, w, albedo), "pixels": h * w}


def epilogue_cases(seed=19):
    """The main path's planes for the two epilogue kernels (on the card),
    as a list of cases: dicts with ``kernel`` ("still epilogue" or
    "encode"), ``case``, ``size``, ``history_valid``, ``miss_share``,
    ``args`` (the wrapper's; for the still epilogue ``(*planes, albedo,
    row)``, for the encode ``(linear, height, width[, albedo, row])``),
    ``timed`` and, for a timed case, ``fn`` (a call of the wrapper),
    ``name`` (the kernel's), ``warm`` (the planes the kernel before it
    has just written in a frame), ``bytes`` and ``flops`` (on this data),
    ``fixed_bytes`` (the bytes a pixel whatever the data) and
    ``pixels``.

    The still epilogue (r = 0, with the albedo) on menger 1280x720 at the
    bench camera, monu9 1920x1080 at the dolly's pose t = 1 and castle
    3840x2160 at its static pose, history valid and invalid (frame 2's
    trace over frame 1's, random old blends), and, untimed, monu9's
    dolly planes t = 1 to 1 + 1/30 with both cameras; the encode of
    monu9's dolly blend (the temporal kernel's output; with the albedo,
    as at r = 0) and of its r = 2 denoised frame (without), and of the
    720p and 4K still frames' blends (with the albedo)."""
    import numpy as np
    import torch
    from voxtracer_torch.app import camera_paths
    from voxtracer_torch.app.tracebench import BENCH_DIR, BENCH_POS
    from voxtracer_torch.engine.camera import Camera
    from voxtracer_torch.engine.params import (
        DenoiseParams,
        RenderParams,
        TemporalParams,
        pack_denoise_params,
        pack_frame_rows,
        pack_temporal_params,
        pack_trace_params,
    )
    from voxtracer_torch.engine.scene import SceneTables, load_scene
    from voxtracer_torch.ops import denoise, epilogue, temporal, trace
    from voxtracer_torch.ops.noise import blue_noise_buffer

    noise = torch.from_numpy(blue_noise_buffer()).cuda()
    rng = np.random.default_rng(seed)

    def sample(tables, cam, w, h, frame):
        return trace.render_sample_cuda(
            tables, pack_trace_params(cam.rows(w, h), RenderParams()), noise,
            frame, h, w)

    def frame_row(cam_rows, old_rows, valid):
        return pack_frame_rows([cam_rows], old_rows, valid, 2, RenderParams(),
                               TemporalParams(), DenoiseParams())[0]

    def still(*a, **kw):
        cases.append(still_case(*a, **kw))

    def encode(*a):
        cases.append(encode_case(*a))

    cases = []
    menger = load_scene("menger")
    monu9 = load_scene("monu9")
    castle = load_scene("castle")
    dolly = camera_paths.dolly(monu9)
    for case, scene, cam, w, h in (
            ("menger bench camera", menger,
             Camera(position=np.array(BENCH_POS),
                    direction=np.array(BENCH_DIR)), 1280, 720),
            ("monu9 dolly t=1", monu9, dolly(1.0), 1920, 1080),
            ("castle static", castle, camera_paths.static(castle)(0.0), 3840,
             2160)):
        tables = SceneTables(scene, "cuda")
        old = sample(tables, cam, w, h, 1)
        new = sample(tables, cam, w, h, 2)
        blend = torch.from_numpy(
            rng.uniform(0.02, 1.0, (h, w)).astype(np.float32)).cuda()
        planes = (new["color"], new["normal"], new["depth"], old["color"],
                  blend, old["depth"])
        rows = cam.rows(w, h)
        for valid in (True, False):
            still(case, planes, new["albedo"], frame_row(rows, rows, valid),
                  valid)
        if h != 1080:  # the still frame's blend, encoded as at r = 0
            row = frame_row(rows, rows, True)
            blended = epilogue.still_epilogue_cuda(*planes, None, row)[0]
            encode(f"{case} blend, with albedo",
                   (blended, h, w, new["albedo"], row), new["depth"])
    # monu9's dolly blend and its r = 2 denoised frame
    w, h = 1920, 1080
    tables = SceneTables(monu9, "cuda")
    old_cam, cam = dolly(1.0), dolly(1.0 + 1 / 30)
    old = sample(tables, old_cam, w, h, 1)
    new = sample(tables, cam, w, h, 2)
    old_blend = torch.from_numpy(
        rng.uniform(0.02, 0.9, (h, w)).astype(np.float32)).cuda()
    rows, old_rows = cam.rows(w, h), old_cam.rows(w, h)
    planes = (new["color"], new["normal"], new["depth"], old["color"],
              old_blend, old["depth"])
    row = frame_row(rows, old_rows, True)
    still("monu9 dolly t=1 to 1+1/30 (both cameras)", planes, new["albedo"],
          row, True, timed=False)
    blended, _ = temporal.temporal_blend_reproject_cuda(
        *planes, pack_temporal_params(rows, old_rows, TemporalParams(), True))
    denoised = denoise.denoise_cuda(
        blended, new["normal"], new["depth"], new["albedo"], new["node"],
        pack_denoise_params(rows, DenoiseParams()), 2)
    encode("monu9 dolly blend, with albedo (r = 0)",
           (blended, h, w, new["albedo"], row), new["depth"])
    encode("monu9 dolly denoised r = 2", (denoised, h, w), new["depth"])
    return cases


def kernel_cases():
    """The four frame kernels that take a slab's rows, each at one
    device (the slab arguments at their defaults) on its main path's
    inputs: ``(kernel, case, fn)``, ``fn`` a call of the wrapper with
    its arguments by position (as a tree without the slab arguments
    takes them).  The trace on menger 1280x720 at the bench camera
    (config 2) and on monu9 1920x1080 at the dolly's pose t = 1 + 1/30
    (config 4); at that pose, over frame t = 1's history (random old
    blends), the reprojecting blend, the r = 2 denoise of its output
    and, as if still, the still epilogue; the still epilogue of the
    720p frame too (history valid)."""
    import numpy as np
    import torch
    from voxtracer_torch.app import camera_paths
    from voxtracer_torch.app.tracebench import BENCH_DIR, BENCH_POS
    from voxtracer_torch.engine.camera import Camera
    from voxtracer_torch.engine.params import (
        DenoiseParams,
        RenderParams,
        TemporalParams,
        pack_denoise_params,
        pack_frame_rows,
        pack_temporal_params,
        pack_trace_params,
    )
    from voxtracer_torch.engine.scene import SceneTables, load_scene
    from voxtracer_torch.ops import denoise, epilogue, temporal, trace
    from voxtracer_torch.ops.noise import blue_noise_buffer

    noise = torch.from_numpy(blue_noise_buffer()).cuda()
    rng = np.random.default_rng(23)
    cases = []

    def traced(tables, rows, w, h, frame):
        args = (tables, pack_trace_params(rows, RenderParams()), noise, frame,
                h, w)
        return args, trace.render_sample_cuda(*args)

    def row_of(rows, old_rows):
        return pack_frame_rows([rows], old_rows, True, 2, RenderParams(),
                               TemporalParams(), DenoiseParams())[0]

    menger = SceneTables(load_scene("menger"), "cuda")
    rows = Camera(position=np.array(BENCH_POS),
                  direction=np.array(BENCH_DIR)).rows(1280, 720)
    _, old = traced(menger, rows, 1280, 720, 1)
    args, new = traced(menger, rows, 1280, 720, 2)
    cases.append(("trace", "config 2 menger 1280x720 bench camera",
                  lambda a=args: trace.render_sample_cuda(*a)))
    still = (new["color"], new["normal"], new["depth"], old["color"],
             torch.from_numpy(rng.uniform(0.02, 1.0, (720, 1280)).astype(
                 np.float32)).cuda(), old["depth"], new["albedo"],
             row_of(rows, rows))
    cases.append(("still epilogue", "config 2 menger 1280x720, history "
                  "valid", lambda a=still: epilogue.still_epilogue_cuda(*a)))

    monu9 = load_scene("monu9")
    dolly = camera_paths.dolly(monu9)
    tables = SceneTables(monu9, "cuda")
    w, h = 1920, 1080
    old_rows, rows = dolly(1.0).rows(w, h), dolly(1.0 + 1 / 30).rows(w, h)
    _, old = traced(tables, old_rows, w, h, 1)
    args, new = traced(tables, rows, w, h, 2)
    cases.append(("trace", "config 4 monu9 1920x1080 dolly t=1+1/30",
                  lambda a=args: trace.render_sample_cuda(*a)))
    planes = (new["color"], new["normal"], new["depth"], old["color"],
              torch.from_numpy(rng.uniform(0.02, 0.9, (h, w)).astype(
                  np.float32)).cuda(), old["depth"])
    tp = pack_temporal_params(rows, old_rows, TemporalParams(), True)
    cases.append(("temporal", "config 4 monu9 1920x1080 dolly t=1 to "
                  "1+1/30", lambda: temporal.temporal_blend_reproject_cuda(
                      *planes, tp)))
    blended, _ = temporal.temporal_blend_reproject_cuda(*planes, tp)
    den = (blended, new["normal"], new["depth"], new["albedo"], new["node"],
           pack_denoise_params(rows, DenoiseParams()), 2)
    cases.append(("denoise", "config 4 monu9 1920x1080 r=2",
                  lambda: denoise.denoise_cuda(*den)))
    row = row_of(rows, old_rows)
    cases.append(("still epilogue", "config 4 monu9 1920x1080, history "
                  "valid", lambda: epilogue.still_epilogue_cuda(
                      *planes, new["albedo"], row)))
    return cases


def measure_kernels(tree: str, label: str):
    """The four frame kernels of ``tree`` on :func:`kernel_cases`, one
    JSON line a case: ms on the device alone (``graph_ms``: 20 launches
    captured into a CUDA graph, replayed back to back) and over 20 eager
    calls of the wrapper (``eager_ms``)."""
    sys.path.insert(0, tree)
    smi = _smi()
    for kernel, case, fn in kernel_cases():
        print(json.dumps({"tree": label, "kernel": kernel, "case": case,
                          "ms": graph_ms(fn), "eager_ms": eager_ms(fn),
                          "device": smi}), flush=True)


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def measure_epilogue(tree: str, label: str):
    """The epilogue kernels of ``tree`` on the main path's planes, one
    JSON line a timed case (the module docstring lists them), and a
    device copy of the 4K still epilogue's bytes as the yardstick of the
    rate the memory reaches."""
    sys.path.insert(0, tree)
    import torch
    from voxtracer_torch.app.tracebench import bound

    smi = _smi()
    cases = epilogue_cases()
    w, h = 1920, 1080
    for value in (0.0, 0.5):  # the sRGB curve's linear branch, its powf
        flat = torch.full((3, h, w), value, device="cuda")
        powf = "no powf" if value == 0 else "powf on every channel"
        cases.append(encode_case(f"uniform {value} ({powf})", (flat, h, w),
                                 flat[0]))
    for case in cases:
        if not case["timed"]:
            continue
        line = {"tree": label, **{k: case[k] for k in (
            "kernel", "case", "size", "history_valid", "miss_share")},
            **time_epilogue_case(case), "device": smi}
        print(json.dumps(line), flush=True)
    # the yardstick: a device-to-device copy moving as many bytes
    nbytes = next(c["bytes"] for c in cases if c["size"] == "3840x2160")
    src = torch.empty(nbytes // 8, device="cuda")
    dst = torch.empty_like(src)
    ms = graph_ms(lambda: dst.copy_(src))
    print(json.dumps({"tree": label, "kernel": "copy", "bytes": nbytes,
                      "ms": ms, "share": bound(nbytes, 0, 1.0)[0] / ms,
                      "device": smi}), flush=True)


def held_orbit(scene, frames: int, seed: int):
    """``frames`` cameras of the orbit path from a seeded start, in runs
    of 1-8 frames that move (1/60 s a frame) or hold the pose of the
    frame before them, in turn, a moving run first."""
    import numpy as np

    from voxtracer_torch.app import camera_paths

    rng = np.random.default_rng(seed)
    path = camera_paths.orbit(scene)
    t = float(rng.uniform(0.0, 8.0))
    cams, moving = [path(t)], True
    while len(cams) < frames:
        for _ in range(int(rng.integers(1, 9))):
            if moving:
                t += 1.0 / 60.0
            cams.append(path(t) if moving else cams[-1])
        moving = not moving
    return cams[:frames]


def eager_render(r, camera, lean=None, **stages):
    """``r.render(camera)`` with the stages called one by one through
    :func:`~voxtracer_torch.engine.pipeline.render_frame` (the package's
    own, or those given by ``render_frame``'s names), on the renderer's
    tables, state and counters: the eager frame that the direct path and
    the kernels are held against."""
    from voxtracer_torch.engine.pipeline import camera_moved, render_frame

    frame = r.frame_number + 1
    cam = camera.rows(r.width, r.height)
    moved = camera_moved(r.state, cam)
    r.state, outputs = render_frame(
        r.state, r.tables, r.noise, cam, r.render_params, r.temporal_params,
        r.denoise_params, frame, r.height, r.width, r.denoise_radius,
        r.lean if lean is None else lean, **stages)
    r.frame_number = frame
    r.still_sample = 1 if moved else r.still_sample + 1
    return outputs


def _same(a, b) -> bool:
    """Bit for bit: a tensor's shape, type, strides and bytes, a host
    value's type and bytes."""
    import numpy as np
    import torch

    if not torch.is_tensor(a):
        return type(a) is type(b) and (
            np.asarray(a).tobytes() == np.asarray(b).tobytes())
    return (torch.is_tensor(b) and a.shape == b.shape and a.dtype == b.dtype
            and a.stride() == b.stride() and torch.equal(
                a.contiguous().view(torch.uint8),
                b.contiguous().view(torch.uint8)))


def direct_against_eager(scene_name: str, width: int, height: int,
                         radius: int, frames: int = 64, seed: int = 15,
                         turns: int = 4):
    """The same seeded orbit of ``frames`` frames (:func:`held_orbit`)
    through ``Renderer.render``'s direct path and the eager stages
    (:func:`eager_render`), on the card: every frame's outputs (all of
    them: not lean) and state compared bit for bit, the counters' growth
    on each path, then the host's us a lean frame call (the viewers') of
    each, median over the path's calls, ``turns`` times in turns
    (direct, eager, eager, direct, ...), over bursts of the path that
    wait for nothing (the device synchronised between them), and the
    device's ms a frame from CUDA events around each burst."""
    import collections

    import torch

    from voxtracer_torch.engine.pipeline import Renderer, counters
    from voxtracer_torch.engine.scene import load_scene

    scene = load_scene(scene_name)
    cams = held_orbit(scene, frames, seed)
    kw = dict(scene=scene, height=height, width=width, device="cuda",
              denoise_radius=radius)
    paths = {"direct": Renderer(**kw), "eager": Renderer(**kw)}
    render = {"direct": Renderer.render, "eager": eager_render}
    counts = {name: collections.Counter() for name in paths}
    differ = []
    for i, cam in enumerate(cams):
        got = {}
        for name, r in paths.items():
            before = counters()
            out = render[name](r, cam, False)
            counts[name].update({k: v - before[k]
                                 for k, v in counters().items()})
            got[name] = (out, r.state)
        for part, x, y in zip(("output", "state"), got["direct"],
                              got["eager"]):
            if x.keys() != y.keys():
                differ.append((i, part, "keys"))
            else:
                differ += [(i, part, k) for k in x if not _same(x[k], y[k])]
    host = {"direct": [], "eager": []}
    device = {"direct": [], "eager": []}
    order = ["direct", "eager"]
    for turn in range(turns):
        for name in (order if turn % 2 == 0 else order[::-1]):
            r = paths[name]
            r.reset_accumulation()
            render[name](r, cams[0], True)
            torch.cuda.synchronize()
            start, end = _events()
            calls = []
            start.record()
            for cam in cams:
                t0 = time.perf_counter()
                render[name](r, cam, True)
                calls.append(time.perf_counter() - t0)
            end.record()
            end.synchronize()
            host[name].append(statistics.median(calls) * 1e6)
            device[name].append(start.elapsed_time(end) / len(cams))
    return {"scene": scene_name, "size": f"{width}x{height}",
            "radius": radius, "frames": frames, "seed": seed,
            "differ": differ[:10], "n_differ": len(differ),
            "counts": {name: {k: n for k, n in c.items() if n}
                       for name, c in counts.items()},
            "host_us": host, "frame_ms": device}


def measure(tree: str, label: str):
    sys.path.insert(0, tree)
    import torch
    from voxtracer_torch.app import camera_paths
    from voxtracer_torch.engine.pipeline import Renderer
    from voxtracer_torch.engine.scene import load_scene

    smi = _smi()
    for config, scene_name, w, h, path_name, radius in CONFIGS:
        scene = load_scene(scene_name)
        path = camera_paths.PATHS[path_name](scene)
        kw = dict(scene=scene, height=h, width=w, device="cuda",
                  denoise_radius=radius, lean=True)
        r = Renderer(**kw)
        n_loop = WARMUP + BURSTS * FRAMES
        cams = [path(i / 30.0) for i in range(
            max(n_loop + SEQ_FRAMES, (SEQ_BURSTS + 2) * SEQ_FRAMES))]
        for cam in cams[:WARMUP]:
            r.render(cam)
        torch.cuda.synchronize()
        host_us, frame_ms = [], []
        for b in range(BURSTS):
            burst = cams[WARMUP + b * FRAMES:WARMUP + (b + 1) * FRAMES]
            start, end = _events()
            start.record()
            t0 = time.perf_counter()
            for cam in burst:
                r.render(cam)
            host_us.append((time.perf_counter() - t0) / FRAMES * 1e6)
            end.record()
            end.synchronize()
            frame_ms.append(start.elapsed_time(end) / FRAMES)
        loop_prof = _profiled(
            lambda: [r.render(c) for c in cams[n_loop:n_loop + SEQ_FRAMES]],
            r.device, SEQ_FRAMES)

        # the same path through the export path, one host call a burst
        seq = Renderer(**kw)
        still = path_name == "static"

        def run_seq(i):
            part = cams[i * SEQ_FRAMES:(i + 1) * SEQ_FRAMES]
            if still:
                seq.render_burst(part[0], SEQ_FRAMES)
            else:
                seq.render_sequence(part)

        run_seq(0)  # captures the graphs
        torch.cuda.synchronize()
        seq_ms = []
        for b in range(1, SEQ_BURSTS + 1):
            start, end = _events()
            start.record()
            run_seq(b)
            end.record()
            end.synchronize()
            seq_ms.append(start.elapsed_time(end) / SEQ_FRAMES)
        seq_prof = _profiled(lambda: run_seq(SEQ_BURSTS + 1), seq.device,
                             SEQ_FRAMES)
        print(json.dumps({
            "tree": label, "config": config,
            "size": f"{w}x{h}", "path": path_name, "radius": radius,
            "host_us_per_render": statistics.median(host_us),
            "host_us_bursts": host_us,
            "ms_per_frame": statistics.median(frame_ms),
            "ms_bursts": frame_ms, "loop_profiled": loop_prof,
            "sequence_ms_per_frame": statistics.median(seq_ms),
            "sequence_ms_bursts": seq_ms, "sequence_profiled": seq_prof,
            "device": smi,
        }), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--tree", default=HERE)
    p.add_argument("--label", default="this")
    p.add_argument("--compare", metavar="OTHER_TREE", nargs="+")
    p.add_argument("--epilogue", action="store_true",
                   help="time the epilogue kernels instead of the configs")
    p.add_argument("--kernels", action="store_true",
                   help="time the trace, temporal, denoise and still "
                        "epilogue kernels at one device instead")
    args = p.parse_args(argv)
    mode = (["--epilogue"] if args.epilogue else []) + (
        ["--kernels"] if args.kernels else [])
    if len(mode) > 1:
        raise SystemExit("--epilogue and --kernels exclude each other")
    if not args.compare:
        run = (measure_epilogue if args.epilogue
               else measure_kernels if args.kernels else measure)
        run(os.path.abspath(args.tree), args.label)
        return 0
    others = [(os.path.abspath(t), os.path.basename(os.path.abspath(t)))
              for t in args.compare]
    for tree, label in (*others, (HERE, "this"), (HERE, "this"),
                        *others[::-1]):
        subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree,
             "--label", label, *mode],
            check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
