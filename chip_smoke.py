"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

0. device: requires CUDA; prints torch / CUDA versions, the card's
   name and power limit from nvidia-smi, and whether the native
   scene-build library loaded.
1. build: compiles voxtracer_torch/csrc/*.cu with nvcc (sm_90a); the
   trace kernel's registers, spills, shared bytes and resident warps
   per SM; ptxas's registers, spills and static shared bytes of each
   denoise instance (r = 1-8, and 0: the radius at run time; the range
   quotient's 1 and 2 corrections): no spills, at most 80 registers from
   r = 2 on; and the dynamic shared bytes of its tile at r in {1, 2, 4,
   8}; the same of the stall kernel's three instances (static, ser,
   ind): no spills.
2. golden: the trace kernel against tests/golden/oracle_8x8x8_32.npz
   (the numpy oracle's pinned output) at the parity bar.
3. plain: the trace kernel against its plain torch version, both on the
   card, on four cases (single voxel; menger 320x180 with the bench
   camera; menger with per-node brick tables; menger 333x187):
   G-buffer bit-equal, rays and steps of phases b0, s0, b1 equal.
4. main path: ``Renderer(device="cuda")`` on menger at 1280x720 with the
   bench camera (``bench.py``): 3 warm-up frames, 3 bursts of 12 still
   frames timed with CUDA events; the trace and still-epilogue launch
   counters must equal the frames rendered (2 launches a frame).  Then
   the same frames' trace stage and two whole frames with the plain
   trace, for comparison.  Then the trace
   kernel alone (``voxtracer_torch.app.tracebench``) on menger
   1280x720, monu9 1920x1080 (dolly, t=0) and castle 3840x2160
   (static): its time, the steps per phase, the SIMT efficiency
   steps / (32 x slots) and the share of its bound.
5. temporal: the reprojection kernel against its plain version at
   1920x1080 on monu9 G-buffers from two dolly poses and from a 10
   degree whip pan, with kernel and plain times.
6. denoise: the denoise kernel against its plain version at 1920x1080
   on the dolly frame, r in {1, 2, 4, 8}, with kernel and plain times
   per radius, and on a ragged 333x187 crop of it at r in {1, ..., 8,
   12} and, through the instance for radii whose tile does not fit
   shared memory, {27, 32}: values beyond the bar and values that differ
   at all (none), at the default sigma_range 1.5 and at 0.3 and 2.75,
   whose range quotients take one and two corrections.  The range
   quotient (``ops/denoise.py`` ``quotient_check``) against IEEE division
   over all 2^31 non-negative float32 dividends (inf and the NaNs among
   them), at 1.5, 0.3, 2.75 and 7.75 and then at each of the web
   viewer's 156 values: the dividends whose quotients differ, all with
   both quotients below 2^-52 (tiny dividends, whose tap weight cannot
   differ), and expf's plateau (1 on [-2^-25, 0]).  Then the kernel alone
   (``voxtracer_torch.app.denoisebench``) at 1920x1080 and 3840x2160, r
   in {1, 2, 4, 8}, on random and on uniform planes: time, bound and
   share (the cost curve).
7. config 4 (``BASELINE.json``): monu9 1920x1080 on the dolly path,
   denoise r=2 — 3 warm-up frames, 3 bursts of 12 frames continuing
   along the path so that every timed frame moves.  Launch counts:
   trace = denoise = encode = frames, temporal = moving frames with live
   history, still epilogue = the first frame.  Then each kernel against
   its plain version, and timed alone, on the next frame's inputs and
   accumulated history; and 2 frames with every stage plain against 2
   kernel frames from the same state.
8. config 3: chr_knight 1280x720 on the orbit path, r=0, the same with
   2 bursts of 8 (encode = moving frames: the first encodes in its still
   epilogue).  In both, the encode kernel against its plain version on
   the next frame's inputs, and the row-reading entries of all four frame
   kernels == their by-value entries.
9. resample: the history-resample kernel against its plain version at
   1920x1080, C=5, on phase 5's coordinates (dolly and whip pan) and on
   a field with NaN/inf/1e30 entries: bit-equal; kernel and plain times.
10. the channels-last ``temporal_blend`` on CUDA tensors (one resample
    kernel launch) against the planar reprojecting body around the
    plain resampler at 1920x1080: equal.
11. stallbench: the stall kernel against its plain version on
    ``stallbench.check_cases()`` (every mode at h in {1, 2, 4, 8} and 64
    trips, pre 512 and mid 256 (the matrix's longest chains), ind with
    both, odd trip and sweep counts): equal; then the CLI's default
    matrix at its default trips (cycles per trip, stall cycles per
    handoff, bound and share), and ser:1 and static:1 against their
    plain versions at those trips: equal; the SM clock; ser:1's and
    static:1's bound on one SM (the kernel is one block), counted from
    what the probe computes (``stallbench.stall_work``), the whole
    card's, and the count of the TPU's 24-row ladder that the kernel's
    first, ladder-walking version was held to, with its share.
12. the offline export path, at full size: config 2 through
    ``Renderer.render_burst``, configs 3 and 4 through
    ``Renderer.render_sequence``.  Two renderers from equal state, one
    driven by N ``render()`` calls, one by the sequence (each frame a
    replay of a captured CUDA graph): frames, final state and counters
    equal, the launch counters (zeroed before, read after) equal to the
    loop's, replays included.  Then ms/frame of the sequence against the
    per-frame loop, in turns (loop, sequence, sequence, loop), 3 warm
    frames, bursts of 12, CUDA events; the device activities and copies
    a replayed frame (``app/profile.py`` ``frame_activities``: those
    between the first and the last frames' trace launches of one profiled
    sequence of 12): a still frame at r = 0 copies only the rows
    of its two row-reading launches, its epilogue blending straight into
    the carried state.  And a mixed path (still, still, pan, pan, still,
    still, pan) at 320x180 for the segment split.  The replayed graphs
    write each frame's image through the epilogue kernels' device slot.
13. ``voxtracer_torch.app.cli.main`` on the card: menger 1280x720,
    ``--batch 8 --frames 20 --video-dir --save-snapshot``, then
    ``--resume --batch 4 --frames 4``: 20 + 4 PNGs, and the resumed
    final image equals an uninterrupted 24-frame run's.
14. ``voxtracer_torch.app.bench.main([])``: BASELINE configs 1-6 at
    their full sizes; every JSON line printed; a non-zero return, a
    config's error line or a kernel never launched fails the run.

16. the interactive layer: (a) ``WebViewer.render_once`` through a
    scripted list of events (key-downs, look deltas, a slider, a denoise
    radius, a reset, a resize, a scene swap) on chr_knight 640x360 r=2:
    every raw u8 frame that reaches the encoder (through the render
    loop's own frame step and host fetch), and its ray count, == a plain
    ``Renderer.render()`` loop over the same cameras and parameters,
    whose stages hold the trace, temporal, denoise, still-epilogue and
    encode kernels against their plain versions on every frame's inputs
    (640x360 at r = 2 and 3, 320x180, both scenes; the bars of phases 3,
    5, 6 and 19); (b) ``serve()`` on 127.0.0.1:0 with the render loop
    thread: a client reads ``/stream`` for 3 s while ``look`` events are
    posted: client-observed fps, ``stage_stats()``, the MIME type, the
    exact Mray/s (the trace kernel's ray counters), and the seven
    kernels' launches per frame of the loop, read around the run;
    (c) ``voxtracer_torch.app.ibench.main(["--seconds", "3"])``: its four
    rows (web chr_knight and menger 640x360, tui chr_knight 256x144,
    wall chr_knight 1280x720).
17. kernel hot-reload: ``ops/_build`` pointed at a copy of ``csrc/`` (six
    sources) in a temporary directory (the repo's sources are never
    edited); a
    comment appended to one ``.cu`` and ``KernelWatcher.poll()``: a new
    library path, the sequence path's graphs dropped, frames (a render
    loop and a replayed sequence) == those of the library before; then a
    broken source: ``poll()`` False, the last good library still loaded,
    the next frames equal again; the seconds of each rebuild.
18. the legacy Whitted mode: ``cli.main(["--legacy-whitted", ...])`` on
    the card at 1280x720 (menger) with its time; ``render_scene`` on the
    card against ``--device cpu`` at 160x90: max abs error (bar 1e-5,
    the JAX comparison's) and values differing.
19. (after phase 6) the frame epilogue: the still-epilogue and encode
    kernels (csrc/epilogue.cu) against their plain versions, by value
    and by row, with and without the modulated linear, the still
    epilogue also without albedo (the blend alone) and in place (into a
    copy of the history), on the main path's planes
    (``renderbench.epilogue_cases``: menger 1280x720 at the bench camera,
    monu9 1920x1080 at a dolly pose and castle 3840x2160, history valid
    and invalid; monu9's dolly planes with both cameras; the encode of
    monu9's dolly temporal output at r = 0 and of its denoised frame at
    r = 2, and of the 720p and 4K still blends), menger 333x187, 333x187
    planes with NaN, +-inf, negative and > 1 values, a cropped encode,
    and every float32 in [0, 1] through the encode: float32 outputs
    bit-equal, u8 values that differ at all (the bar: none beyond 1);
    then, at 720p, 1080p and 4K (``renderbench.time_epilogue_case``),
    each kernel's time on the device alone (20 launches captured into a
    CUDA graph and replayed back to back), in the frame's cache state
    (the L2 evicted and the planes the kernel before it writes rewritten
    before each launch; the profiled kernel's duration), over 20 eager
    calls of the wrapper (the earlier yardstick), the plain version's,
    the bound on the run's data and the fixed one, their shares, and
    the share of miss pixels.
20. (after 18) the row-slab mesh (``voxtracer_torch.parallel``) on
    ``["cuda:0"] * n``: configs 2 (menger 1280x720 at the bench camera),
    3 (chr_knight 1280x720 orbit) and 4 (monu9 1920x1080 dolly r=2) in
    4 contiguous slabs, config 3 in 3 (uneven), config 4 in the cyclic
    layout (1080 rows: the last device's bands cut at the image's edge),
    a ragged 333x187 in 8 slabs at r = 2 and a 64-row frame in 16 slabs
    at r = 8 (a halo taller than a slab): 4 frames each (the first
    still, then along the path) against the one-device ``render_frame``
    loop from the same state: image, node, depth, linear, the other
    outputs and the final state bit-equal; each kernel's launches
    (zeroed before the slab frames, read after) equal to slabs x frames
    of its stage.  Then, for the five full-size cases, ms/frame of the
    one-device frame and of the slab path in turns (one-device, slabs,
    slabs, one-device), bursts of 8 after 8 warm frames, CUDA events,
    and the row blocks the slab path copies a frame (windows, history,
    resort) and how many of them device to device.  The card count is printed; on
    more than one card, configs 3, 4 (cyclic) and the ragged case run
    on the distinct devices too.  Records, not gates: slabs on one card
    only add launches.
21. (after 20) the slab probe (``voxtracer_torch.app.slabprobe``) on
    menger 1280x720 and castle 3840x2160, 4 and 8 devices, k in {1, 2,
    3} contiguous slabs a device and the cyclic layout: every slab's
    trace bit-equal to the one-launch frame's rows (and the counters'
    sums), each slab's device ms (CUDA-graph replays), blocks and waves,
    each device's sum, the skew, the launch overhead; the cyclic rows
    pad nothing.
22. the scale probe (``voxtracer_torch.app.scaleprobe``): the synthetic
    480^3 shell (the reference's size; its fine table is about 3x the
    50 MB L2, built on the host in the run's time), the build seconds,
    every table's bytes against the card's L2, ms/frame of
    ``Renderer(lean=True)`` at 640x360, the trace alone (CUDA-graph
    replays) and its share of bound (the tables' bytes left out, as in
    every trace bound), beside menger's at the same size, and the plain
    trace's node agreement with the kernel: exactly 1.0.
23. the trace kernel's steps-map instance against the shipped instance
    (every output and counter equal) and against the plain version's
    map (bit-equal) on the single voxel, menger 320x180 (bench camera)
    and menger 333x187; the live-decay curve of each phase
    (``ops/trace.py`` ``warp_decay``) for menger 1280x720, monu9
    1920x1080 (dolly t=0) and castle 3840x2160, and each of these three
    kernel outputs against the plain version's on the same inputs (the
    maps, nodes, depths, normals, albedos and counters equal, the colour
    at phase 4's bar; the ``kernels`` line's error is theirs); the
    shipped instance, the shipped instance with a memset of the map's
    size, and the steps-map instance timed in turns at menger 1280x720;
    the trace instances' registers and spills (the shipped ones: 80 and
    0, as phase 1 reads).
24. the blue-noise baker (``voxtracer_torch.ops.bluenoise``, torch ops)
    on the card: ``generate(8, 128)``, its seconds, every slice a
    permutation of the ranks with a blue spectrum.
25. the program's spans and counters (``utils/timing.py``,
    ``engine.pipeline.counters``): the card's tests of them (``pytest
    --noconftest -m cuda tests/test_torch_tracing.py``: the sequence
    driver's spans, a graph captured only on first use,
    ``graph.replays`` the frames replayed, a host wait a push and a
    ``load_rows``; and ``tests/test_torch_fetch_stream.py``: the
    lookahead fetch's frames, copied on its own stream, bit-equal to
    blocking copies, through a drop and a resize, and the copy's event
    on that stream); the off path's cost a span on this host (the best of
    5 loops of 200,000 no-op spans) times the 8 sites a frame opens at
    most (``vt.render``, its pack, 4 stages, the fetch's copy and wait),
    the on path's a span under the profiler; and the device side of a
    profiled view loop (menger 320x180, r=2, through
    ``LookaheadFetch``): any ``vt.*`` event on the device is flagged
    ``is_user_annotation`` (so the benchmark's trace reading leaves it
    out) and none is among ``app/profile.py``'s device activities.
26. the frame driver's direct path (``engine/direct.py``,
    ``csrc/frame.cu``): ``app/renderbench.py`` ``direct_against_eager``
    renders a seeded 64-frame orbit with holds and moves through the
    direct path and through the eager stages (``renderbench.eager_render``,
    a ``render_frame`` loop) at menger 1280x720 r=0 and
    monu9 1920x1080 r=2: every output and state plane bit-equal, the
    same kernels launched, ``frames.direct`` 64 on the direct path
    alone; then the host's us a lean frame call of each path and the
    device's ms a frame, 4 turns each, in turns.
27. the scene build on the card (``engine/scene.py`` ``SceneTables``,
    ``scene/device_build.py``): the card's tests of it (``pytest
    --noconftest -m cuda tests/test_torch_scene_device_build_cuda.py``:
    the full bowl, menger and monu9 bit-equal to the host build, its
    counters and spans); then the procedural bowl (radius 256) built
    on the host and copied, as a CPU ``SceneTables`` builds it, and
    built on the card, in turns, three each: the parts of the
    benchmark's ``scene_build_s`` (``scene.load_us`` once, the tables'
    and the copies' us), the device memory each build takes at its
    peak, every build's tables bit-equal to the first's.

Then (phase 15) checks that no module of the JAX package
(``voxtracer``), JAX or Triton was imported, prints the per-kernel JSON
line (the five ported TPU kernels, the frame epilogue's two, which
replace an XLA fusion and no ``pallas_call``, and the trace kernel's
steps-map instance, whose launches are phase 23's: each kernel's launches,
error, times, bound and share of it,
launches per frame of each config that ran it, its launches on phase
12's sequences, per frame of phase 16's viewer loop and on each of
phase 20's slab cases (``mesh_launches``), on phases 21-24's paths
(``slab_launches``, ``scale_launches``, ``decay_launches``,
``bake_launches``), and the time of
one PyTorch call computing the same function, where there is one), then
the device line last.

Bounds (``bound_ms``): the larger of the bytes the function must move
(each input read once, each output written once; for the epilogue
kernels ``renderbench.still_bytes``, counted on the run's planes, and
``encode_bytes``; for the trace no scene table bytes, since which of
them a sample reads depends on its rays) over 3.35 TB/s and
its operations over the card's peak for their type: float32 operations
over 67 TFLOP/s, or, for the integer and control work of the trace
kernel, lane operations over the issue rate, 33.5 T a second (132 SMs x
4 schedulers x 32 lanes x 1.98 GHz); the stall kernel, one block, over
one SM's issue rate and shared memory (``stallbench.stall_bound``).  The trace's operations
are counted from the function's definition over this run's counted
steps and rays (``voxtracer_torch.app.tracebench``), the denoise's over
the stencil's in-frame taps (``voxtracer_torch.app.denoisebench``).
"""

import contextlib
import io
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from voxtracer_torch.app import denoisebench, tracebench  # noqa: E402
from voxtracer_torch.app.denoisebench import FP32_FLOPS_PER_S  # noqa: E402
from voxtracer_torch.app.renderbench import (  # noqa: E402
    eager_render,
    encode_case,
    epilogue_cases,
    still_case,
    time_epilogue_case,
)
from voxtracer_torch.app.tracebench import LANE_OPS_PER_S, bound  # noqa: E402

WIDTH, HEIGHT = 1280, 720
WARMUP, BURSTS, FRAMES = 3, 3, 12
BENCH_POS, BENCH_DIR = tracebench.BENCH_POS, tracebench.BENCH_DIR

# float32 operations of the temporal kernel (csrc/temporal.cu) per
# pixel; of the resample kernel per pixel and plane.
TEMPORAL_FLOPS_PER_PX = 200
RESAMPLE_FLOPS_PER_PX_PLANE = 9

# the kernels that render_sequence / render_burst replay; the slab path
# (phase 20) runs the same
SEQUENCE_KERNELS = ("trace", "temporal", "denoise", "epilogue", "encode")
# phase 20: frames held against the one-device frames, frames a burst
MESH_FRAMES, MESH_BURST = 4, 8
# phase 21: the slab probe's scenes, the mean of SLAB_REPS replays of
# graphs of SLAB_CHAIN launches
SLAB_CASES = (("menger", 1280, 720), ("castle", 3840, 2160))
SLAB_REPS, SLAB_CHAIN = 5, 20
# phase 22: the scale probe's shell (480: the reference's; fine table
# about 147 MB, 3x the H100's 50 MB L2)
SCALE_DIMS = 480


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def gbuf_np(out):
    """Trace output dict -> numpy, channels-last like the oracle."""
    res = {}
    for k, v in out.items():
        a = v.detach().cpu().numpy()
        if k in ("color", "normal", "albedo"):
            a = np.moveaxis(a, 0, -1)
        res[k] = a
    return res


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    from voxtracer_torch import native

    say(0, f"torch {torch.__version__} cuda {torch.version.cuda} "
           f"python {sys.version.split()[0]} devices "
           f"{torch.cuda.device_count()}; native scene-build library "
           f"loaded {native.loaded()}")
    print(smi, flush=True)
    return smi


def phase_build():
    from voxtracer_torch.ops import _build, trace

    t0 = time.perf_counter()
    _build.load()
    dt = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    say(1, f"built {os.path.basename(_build.library_path())} in {dt:.2f} s; "
           + " | ".join(ptxas))
    info = trace.kernel_info()
    say(1, f"trace kernel: {info['registers']} registers, "
           f"{info['spill_bytes']} spill bytes a thread "
           f"({info['local_bytes']} bytes of local memory, the accurate "
           f"cosf/sinf's stack frame), {info['shared_bytes']} shared bytes "
           f"a block, {info['blocks_per_sm']} blocks = "
           f"{info['warps_per_sm']} warps resident per SM")
    assert info["spill_bytes"] == 0 and info["warps_per_sm"] >= 24, info
    from voxtracer_torch.ops import denoise

    report = denoise_instances(_build.build_log())
    say(1, "denoise instances (registers, spill bytes, static shared bytes), "
           "by radius and the range quotient's corrections: "
           + ", ".join(f"r={r or 'run time'}/{steps} {v}"
                       for (r, steps), v in sorted(report.items())))
    say(1, "denoise tile, dynamic shared bytes a block: " + ", ".join(
        f"r={r} {denoise.tile_plan(1080, 1920, r).shared_bytes}"
        for r in (1, 2, 4, 8)))
    assert sorted(report) == [(r, steps)
                              for r in range(denoise.STATIC_RADII + 1)
                              for steps in (1, 2)], report
    assert all(v[1] == 0 for v in report.values()), report
    assert all(v[0] <= 80 for (r, _), v in report.items() if r >= 2), report
    stall = ptxas_entries(_build.build_log(), r"stall_kernelILi(\d)E")
    say(1, "stall kernel instances (registers, spill bytes, static shared "
           "bytes): " + ", ".join(f"{mode} {stall[str(i)]}" for i, mode in
                                  enumerate(("static", "ser", "ind"))))
    assert all(v[1] == 0 for v in stall.values()) and len(stall) == 3, stall


def ptxas_entries(log, pattern):
    """ptxas's report of each entry function in the build log whose
    mangled name matches ``pattern``, keyed by the match's group (a
    tuple where it has more than one): registers, spill bytes (stores +
    loads) and static shared bytes."""
    lines = log.splitlines()
    res = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*" + pattern, line)
        if not m:
            continue
        text = " ".join(lines[i + 1:i + 4])
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          text)
        smem = re.search(r"(\d+) bytes smem", text)
        res[m.groups() if len(m.groups()) > 1 else m.group(1)] = (
            int(re.search(r"Used (\d+) registers", text).group(1)),
            int(spill.group(1)) + int(spill.group(2)),
            int(smem.group(1)) if smem else 0)
    return res


def denoise_instances(log):
    """Each instance of the denoise kernel by radius (0: the radius at
    run time) and the range quotient's corrections: ``ptxas_entries`` of
    the by-value entry's instances, denoise_kernel<R, false, STEPS>."""
    return {(int(r), int(steps)): v for (r, steps), v in ptxas_entries(
        log, r"denoise_kernelILi(\d+)ELb0ELi(\d)E").items()}


def phase_golden():
    from voxtracer_torch.engine.camera import Camera
    from voxtracer_torch.engine.params import RenderParams, pack_trace_params
    from voxtracer_torch.engine.scene import SceneTables, load_scene
    from voxtracer_torch.ops import trace
    from voxtracer_torch.ops.noise import white_noise_buffer

    scene = load_scene("8x8x8")
    cam = Camera(position=np.array([2.0, 3.0, -4.0]),
                 direction=np.array([0.2, 0.1, 1.0]))
    w = h = 32
    noise = torch.from_numpy(white_noise_buffer(seed=7)).cuda()
    x = gbuf_np(trace.render_sample_cuda(
        SceneTables(scene, "cuda"),
        pack_trace_params(cam.rows(w, h), RenderParams()), noise, 1, h, w))
    torch.cuda.synchronize()
    g = np.load(os.path.join(HERE, "tests", "golden", "oracle_8x8x8_32.npz"))
    # parity bar (ROADMAP): node ids bit-exact; depth 1e-4 on 8x8x8;
    # at most 4 px beyond 1e-3 in color; albedo 1e-6.  Normals: the
    # table walk's hit t may differ from the oracle's dense DDA by an
    # ulp, which can flip a dominant-axis tie — measured 2 px for the
    # plain version on the CPU, pinned.
    flips = int((x["node"] != g["node"]).sum())
    agree = x["node"] == g["node"]
    hit = agree & (g["depth"] >= 0)
    np.testing.assert_allclose(x["depth"][hit], g["depth"][hit],
                               rtol=1e-4, atol=1e-4)
    n_normal = int((~(x["normal"] == g["normal"]).all(-1))[agree].sum())
    err = np.abs(x["color"] - g["color"]).max(-1)
    n_far = int((~((err < 1e-3) & agree)).sum())
    alb = float(np.abs(x["albedo"] - g["albedo"])[agree].max())
    say(2, f"golden 8x8x8 32x32: node flips {flips} (pinned 0), normal "
           f"mismatches {n_normal} (pinned <=2), color px beyond 1e-3 "
           f"{n_far} (pinned <=4), albedo max err {alb:.2e} (<=1e-6)")
    assert flips == 0 and n_normal <= 2 and n_far <= 4 and alb <= 1e-6


def single_voxel_scene():
    from voxtracer_torch.engine.scene import GridScene, VoxelList

    return GridScene.from_voxels(VoxelList(
        pos=np.array([[0, 0, 0]], dtype=np.int16),
        mrgb=np.array([[0, 200, 100, 50]], dtype=np.uint8)))


def compare_kernel_plain(label, tables, cam, w, h, noise):
    """Kernel vs plain on the same card inputs; returns the kernel's
    color max abs error."""
    from voxtracer_torch.engine.params import RenderParams, pack_trace_params
    from voxtracer_torch.ops import trace

    params = pack_trace_params(cam.rows(w, h), RenderParams())
    p = gbuf_np(trace.render_sample_plain(tables, params, noise, 1, h, w))
    k = gbuf_np(trace.render_sample_cuda(tables, params, noise, 1, h, w))
    torch.cuda.synchronize()
    # Primary geometry uses no transcendental, so node, depth, normal
    # and albedo must be bit-exact, and so must the ray and step counts
    # of the phases before the first hemisphere sample (b0, s0, b1).
    # Color: cos/sin/exp/log may round differently in the two builds,
    # which can turn a secondary ray at a grazing edge; at most 0.5% of
    # the pixels may differ by more than 1e-3.
    flips = int((k["node"] != p["node"]).sum())
    depth_err = float(np.abs(k["depth"] - p["depth"]).max())
    normal_eq = bool((k["normal"] == p["normal"]).all())
    albedo_eq = bool((k["albedo"] == p["albedo"]).all())
    err = np.abs(k["color"] - p["color"]).max(-1)
    n_far = int((err > 1e-3).sum())
    hits = float((p["depth"] >= 0).mean())
    eff = k["steps"].sum() / (32 * k["slots"][0])
    say(3, f"{label} {w}x{h}: hit fraction {hits:.3f}, node flips {flips}, "
           f"depth max err {depth_err:g}, normals equal {normal_eq}, albedo "
           f"equal {albedo_eq}, color max err {err.max():g}, px beyond 1e-3 "
           f"{n_far}, rays kernel {k['rays'].tolist()} plain "
           f"{p['rays'].tolist()}, steps kernel {k['steps'].tolist()} plain "
           f"{p['steps'].tolist()}, SIMT efficiency {eff:.3f}")
    assert hits > 0.0, "degenerate comparison: no hits"
    assert flips == 0 and depth_err == 0.0 and normal_eq and albedo_eq
    assert (k["rays"][:3] == p["rays"][:3]).all()
    assert (k["steps"][:3] == p["steps"][:3]).all()
    assert 0 < k["steps"].sum() <= 32 * k["slots"][0]
    assert n_far <= 0.005 * w * h
    return float(err.max())


def phase_plain():
    from voxtracer_torch.engine.camera import Camera
    from voxtracer_torch.engine.scene import SceneTables, load_scene
    from voxtracer_torch.ops.noise import blue_noise_buffer
    from voxtracer_torch.scene import grid

    noise = torch.from_numpy(blue_noise_buffer()).cuda()
    err = compare_kernel_plain(
        "single voxel", SceneTables(single_voxel_scene(), "cuda"),
        Camera(position=np.array([0.3, 0.2, -1.5])), 32, 32, noise)
    bench_cam = Camera(position=np.array(BENCH_POS),
                       direction=np.array(BENCH_DIR))
    menger = SceneTables(load_scene("menger"), "cuda")
    err = max(err, compare_kernel_plain("menger dedup bricks", menger,
                                        bench_cam, 320, 180, noise))
    # a size that is no multiple of the kernel's 16x16 block
    err = max(err, compare_kernel_plain("menger dedup bricks", menger,
                                        bench_cam, 333, 187, noise))
    # forcing the dedup threshold to 0 builds per-node (2, rows, 128)
    # brick tables for the same scene
    saved = grid.BRICK_DEDUP_MAX
    grid.BRICK_DEDUP_MAX = 0
    try:
        tables = SceneTables(load_scene("menger"), "cuda")
    finally:
        grid.BRICK_DEDUP_MAX = saved
    assert not tables.brick_dedup
    return max(err, compare_kernel_plain("menger per-node bricks", tables,
                                         bench_cam, 320, 180, noise))


def cuda_time(fn, n):
    """Mean ms of ``n`` calls of ``fn``, between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def phase_main(smi):
    from voxtracer_torch.engine.camera import Camera
    from voxtracer_torch.engine.params import pack_trace_params
    from voxtracer_torch.engine.pipeline import Renderer
    from voxtracer_torch.engine.scene import load_scene
    from voxtracer_torch.ops import trace

    cam = Camera(position=np.array(BENCH_POS), direction=np.array(BENCH_DIR))
    torch.cuda.reset_peak_memory_stats()
    r = Renderer(scene=load_scene("menger"), height=HEIGHT, width=WIDTH,
                 device="cuda", lean=True)

    kernels = frame_kernels()
    for k in kernels.values():
        k.launches = 0
    rays = torch.zeros(trace.N_PHASES, dtype=torch.int64, device="cuda")
    for _ in range(WARMUP):
        out = r.render(cam)
    torch.cuda.synchronize()
    bursts = []
    for _ in range(BURSTS):
        def burst():
            nonlocal out
            out = r.render(cam)
            rays.add_(out["rays"])
        bursts.append(cuda_time(burst, FRAMES))
    counts = {name: k.launches for name, k in kernels.items()}
    launches = counts["trace"]
    frames = WARMUP + BURSTS * FRAMES
    # a still frame at r = 0: the trace and the still epilogue
    assert counts == {"trace": frames, "temporal": 0, "denoise": 0,
                      "resample": 0, "stall": 0, "epilogue": frames,
                      "encode": 0, "trace_steps": 0}, counts
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    image = out["image"].cpu().numpy()
    depth = out["depth"].cpu().numpy()
    assert image.shape == (HEIGHT, WIDTH, 3) and image.dtype == np.uint8
    hit_frac = float((depth >= 0).mean())
    std = float(image.astype(np.float32).std())
    assert 0.5 < hit_frac <= 1.0, f"hit fraction {hit_frac}"
    assert std > 5.0, f"degenerate image, std {std}"
    assert r.still_sample == frames and r.frame_number == frames

    ms = statistics.median(bursts)
    rays_per_frame = rays.sum().item() / (BURSTS * FRAMES)
    mrays = rays_per_frame / (ms * 1e-3) / 1e6
    say(4, f"menger {WIDTH}x{HEIGHT} still, {frames} frames, trace "
           f"launches {launches}: burst ms/frame "
           f"{', '.join(f'{b:.3f}' for b in bursts)}; median {ms:.3f} ms "
           f"({1000.0 / ms:.2f} fps), {rays_per_frame:.0f} rays/frame, "
           f"{mrays:.1f} Mrays/s, peak {peak_mib:.0f} MiB, image std "
           f"{std:.1f}, hit fraction {hit_frac:.3f} [{smi}]")

    # the trace stage alone, kernel vs plain, on this frame's inputs
    params = pack_trace_params(cam.rows(WIDTH, HEIGHT), r.render_params)
    args = (r.tables, params, r.noise, r.frame_number + 1, HEIGHT, WIDTH)
    k_ms = cuda_time(lambda: trace.render_sample_cuda(*args), 10)
    p_ms = cuda_time(lambda: trace.render_sample_plain(*args), 1)
    k = gbuf_np(trace.render_sample_cuda(*args))
    p = gbuf_np(trace.render_sample_plain(*args))
    flips = int((k["node"] != p["node"]).sum())
    err = np.abs(k["color"] - p["color"]).max(-1)
    assert flips == 0 and (k["depth"] == p["depth"]).all()
    assert (err > 1e-3).sum() <= 0.005 * WIDTH * HEIGHT
    assert (k["rays"][:3] == p["rays"][:3]).all()
    assert (k["steps"][:3] == p["steps"][:3]).all(), (k["steps"], p["steps"])

    # two whole frames with the plain trace, then two kernel frames from
    # the same state: their images must agree
    state = {key: (v.clone() if torch.is_tensor(v) else v)
             for key, v in r.state.items()}
    n0 = r.frame_number
    images = []
    plain_frame_ms = cuda_time(
        lambda: images.append(eager_render(
            r, cam, trace=trace.render_sample_plain)["image"]), 2)
    r.state, r.frame_number = state, n0
    for _ in range(2):
        img_kernel = r.render(cam)["image"]
    diff = (img_kernel.int() - images[-1].int()).abs().cpu().numpy()
    n_px = int((diff > 2).any(-1).sum())
    say(4, f"trace stage alone: kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms; "
           f"frame with plain trace {plain_frame_ms:.1f} ms vs kernel "
           f"{ms:.3f} ms; trace color max err {err.max():g}, px beyond "
           f"1e-3 {int((err > 1e-3).sum())}; u8 px differing by >2 after 2 "
           f"frames {n_px} [{smi}]")
    assert n_px <= 0.005 * WIDTH * HEIGHT
    bound_ms, bound_by = tracebench.trace_bound(k, HEIGHT, WIDTH,
                                                r.noise.shape[0])
    entry = {"max_abs_err": float(err.max()), "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": bound_ms, "bound_by": bound_by}
    return entry, counts


def frame_kernels():
    """The launch-counting wrappers of the port's seven kernels and of
    the trace kernel's steps-map instance (phase 23), by name: every path
    zeroes and reads them all, those it must not launch too."""
    from voxtracer_torch.app import stallbench
    from voxtracer_torch.ops import (
        denoise,
        epilogue,
        reproject,
        temporal,
        trace,
    )

    return {
        "trace": trace.render_sample_cuda,
        "temporal": temporal.temporal_blend_reproject_cuda,
        "denoise": denoise.denoise_cuda,
        "resample": reproject.resample_cuda,
        "stall": stallbench.run_cuda,
        "epilogue": epilogue.still_epilogue_cuda,
        "encode": epilogue.encode_cuda,
        "trace_steps": trace.render_sample_steps_cuda,
    }


def phase_trace_sizes(smi):
    """The trace kernel alone at three frame sizes (blue noise, frame 1):
    time, steps per phase, SIMT efficiency and share of its bound."""
    for case in tracebench.cases():
        r = tracebench.measure(*case, torch.device("cuda"), tracebench.REPS)
        say(4, f"trace kernel alone, {r['scene']} {r['width']}x{r['height']}"
               f": {r['ms']:.4f} ms; rays per phase {r['rays']}; steps per "
               f"phase {r['steps']} ({sum(r['steps'])}); step slots "
               f"{r['slots']}, SIMT efficiency {r['simt_efficiency']:.3f}; "
               f"{r['ops']} operations; bound {r['bound_ms']:.4f} ms "
               f"({r['bound_by']}), share {r['share']:.3f} [{smi}]")
        assert r["device"] == smi and 0 < r["simt_efficiency"] <= 1.0, r


def trace_cuda(tables, noise, cam, w, h, frame=1):
    from voxtracer_torch.engine.params import RenderParams, pack_trace_params
    from voxtracer_torch.ops import trace

    return trace.render_sample_cuda(
        tables, pack_trace_params(cam.rows(w, h), RenderParams()), noise,
        frame, h, w)


def phase_temporal(smi):
    """Kernel vs plain at 1080p on monu9 G-buffers.  Returns the colour
    max abs error, the dolly frame's G-buffer and kernel blend (phase
    6's input) and each pose's temporal arguments (phase 9's)."""
    from voxtracer_torch.app import camera_paths
    from voxtracer_torch.engine.params import (
        TemporalParams,
        pack_temporal_params,
    )
    from voxtracer_torch.engine.scene import SceneTables, load_scene
    from voxtracer_torch.ops import temporal
    from voxtracer_torch.ops.noise import blue_noise_buffer

    w, h = 1920, 1080
    scene = load_scene("monu9")
    tables = SceneTables(scene, "cuda")
    noise = torch.from_numpy(blue_noise_buffer()).cuda()
    path = camera_paths.dolly(scene)
    # mid-path, where the dolly moves fastest
    old_cam = path(1.0)
    old = trace_cuda(tables, noise, old_cam, w, h)
    rng = np.random.default_rng(0)
    old_blend = torch.from_numpy(
        rng.uniform(0.02, 0.9, (h, w)).astype(np.float32)).cuda()
    max_err, dolly, poses = 0.0, None, []
    for label, cam in (("dolly", path(1.0 + 1 / 30)),
                       ("whip pan 10 deg", old_cam.pitched(10.0))):
        new = trace_cuda(tables, noise, cam, w, h, frame=2)
        args = (new["color"], new["normal"], new["depth"], old["color"],
                old_blend, old["depth"],
                pack_temporal_params(cam.rows(w, h), old_cam.rows(w, h),
                                     TemporalParams(), True))
        kc, kb = temporal.temporal_blend_reproject_cuda(*args)
        pc, pb = temporal.temporal_blend_reproject_plain(*args)
        torch.cuda.synchronize()
        # no transcendental: validity and next blend must be bit-exact,
        # colour within 1e-6
        flips = int((kb != pb).sum())
        err = float((kc - pc).abs().max())
        hit = new["depth"] >= 0
        kept = float(((pb < 0.5) & hit).sum() / hit.sum().clamp_min(1))
        k_ms = cuda_time(
            lambda: temporal.temporal_blend_reproject_cuda(*args), 20)
        p_ms = cuda_time(
            lambda: temporal.temporal_blend_reproject_plain(*args), 3)
        say(5, f"temporal {label} {w}x{h} monu9: hit fraction "
               f"{float(hit.float().mean()):.4f}, history kept on "
               f"{kept:.3f} of hits, next-blend mismatches {flips}, colour "
               f"max err {err:g}; kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms "
               f"[{smi}]")
        assert flips == 0 and err <= 1e-6 and kept > 0.0
        max_err = max(max_err, err)
        dolly = dolly or (cam, new, kc)
        poses.append((label, args, cam.rows(w, h), old_cam.rows(w, h)))
    return max_err, dolly, poses


def compare_denoise(args):
    """Kernel and plain version on the same inputs: the kernel's output,
    the plain one, the count of values beyond the bar and of values
    that differ at all."""
    from voxtracer_torch.ops import denoise

    k = denoise.denoise_cuda(*args)
    p = denoise.denoise_plain(*args)
    torch.cuda.synchronize()
    # expf/logf may round differently from torch's: 1e-6 absolute plus
    # 1e-6 relative
    n_far = int(((k - p).abs() > 1e-6 + 1e-6 * p.abs()).sum())
    return k, p, n_far, int((k != p).sum())


def phase_denoise(smi, dolly):
    """Kernel vs plain at 1080p on the dolly frame, r in {1, 2, 4, 8},
    and on a ragged 333x187 crop of it at r in {1, ..., 8, 12, 27, 32},
    at sigma_range 1.5, 0.3 and 2.75 (one, one and two corrections of the
    range quotient); the range quotient against IEEE division; then the
    kernel alone through denoisebench at 1080p and 4K.  Returns the max
    abs error."""
    from voxtracer_torch.engine.params import DenoiseParams, pack_denoise_params
    from voxtracer_torch.ops import denoise

    cam, g, blended = dolly
    h, w = g["depth"].shape
    max_err = 0.0
    cw, ch = 333, 187  # no multiple of the kernel's 32x32 tile
    crop = [t[..., :ch, :cw].contiguous()
            for t in (blended, g["normal"], g["depth"], g["albedo"], g["node"])]
    for sigma in (1.5, 0.3, 2.75):
        dp = DenoiseParams(sigma_range=sigma)
        steps = denoise.range_reciprocal(sigma).steps
        for radius in (1, 2, 4, 8):
            args = (blended, g["normal"], g["depth"], g["albedo"], g["node"],
                    pack_denoise_params(cam.rows(w, h), dp), radius)
            k, p, n_far, n_diff = compare_denoise(args)
            err = float((k - p).abs().max())
            finite = bool(torch.isfinite(p).all())
            k_ms = cuda_time(lambda: denoise.denoise_cuda(*args), 10)
            p_ms = cuda_time(lambda: denoise.denoise_plain(*args), 1)
            say(6, f"denoise r={radius} {w}x{h} sigma_range {sigma} "
                   f"({steps} correction{'s' * (steps > 1)}): max abs err "
                   f"{err:g}, values beyond 1e-6 abs+rel {n_far}, values "
                   f"differing {n_diff}, plain finite {finite}; kernel "
                   f"{k_ms:.4f} ms, plain {p_ms:.2f} ms [{smi}]")
            assert n_diff == 0 and finite
            max_err = max(max_err, err)
        crop_rows = []
        # 27 and 32: above the largest radius whose haloed tile fits
        for radius in (*range(1, 9), 12, 27, 32):
            args = (*crop, pack_denoise_params(cam.rows(cw, ch), dp), radius)
            k, p, n_far, n_diff = compare_denoise(args)
            err = float((k - p).abs().max())
            crop_rows.append(f"r={radius} {err:g}/{n_far}/{n_diff}")
            assert n_diff == 0 and bool(torch.isfinite(p).all()), radius
            max_err = max(max_err, err)
        say(6, f"denoise {cw}x{ch} crop, sigma_range {sigma} (max abs err / "
               f"values beyond the bar / values differing): "
               f"{', '.join(crop_rows)} [{smi}]")
    phase_quotient(smi)
    # random planes, and uniform ones (every tap between equal elements,
    # as between sky pixels): the kernel's time should not differ
    for planes in ("random", "uniform"):
        rc, rows = run_captured(6, denoisebench.main, ["--planes", planes])
        assert rc == 0 and len(rows) == 8, rows
        assert all(r["device"] == smi and r["share"] > 0 for r in rows), rows
        say(6, f"denoise kernel alone, {planes} planes (ms, share of "
               "bound): " + ", ".join(
                   f"{r['size']} r={r['radius']} {r['ms_per_call']:.4f} "
                   f"{r['share']:.3f}" for r in rows))
    return max_err


def phase_quotient(smi):
    """The range quotient against IEEE division over every non-negative
    float32 dividend: in detail at 1.5, 0.3, 2.75 and 7.75, then over the
    web viewer's 156 values."""
    from voxtracer_torch.ops import denoise

    tiny = 2.0**-52
    for sigma in (1.5, 0.3, 2.75, 7.75):
        t0 = time.perf_counter()
        got = denoise.quotient_check(sigma)
        dt = time.perf_counter() - t0
        steps = denoise.range_reciprocal(sigma).steps
        say(6, f"range quotient, sigma_range {sigma} ({steps} correction"
               f"{'s' * (steps > 1)}), all 2^31 non-negative dividends "
               f"against IEEE division: {got['differ']} differ, all tiny "
               f"(both quotients <= 2^-52: {got['top'] <= tiny}; the largest "
               f"{got['top']:g}); expf != 1 on [-2^-25, 0]: "
               f"{got['plateau']}; {dt:.2f} s [{smi}]")
        assert got["top"] <= tiny and got["plateau"] == 0, got
    web = [round(0.25 + 0.05 * k, 2) for k in range(156)]
    rows = {s: denoise.quotient_check(s) for s in web}
    two = sum(denoise.range_reciprocal(s).steps == 2 for s in web)
    worst = max(r["top"] for r in rows.values())
    say(6, f"range quotient over the web viewer's {len(web)} sigma_range "
           f"values ({two} take two corrections): dividends differing "
           f"{min(r['differ'] for r in rows.values())}-"
           f"{max(r['differ'] for r in rows.values())}, the largest quotient "
           f"among them {worst:g}; expf != 1 on [-2^-25, 0]: "
           f"{max(r['plateau'] for r in rows.values())} [{smi}]")
    assert worst <= tiny and all(r["plateau"] == 0 for r in rows.values())


def n_differ(a, b):
    """How many values of ``a`` and ``b`` differ: their bits (float32),
    with any NaN equal to any NaN, or their values (u8)."""
    if a.dtype == torch.uint8:
        return int((a != b).sum())
    nan = a.isnan() & b.isnan()
    return int(((a.view(torch.int32) != b.view(torch.int32)) & ~nan).sum())


def u8_max_diff(a, b):
    return int((a.int() - b.int()).abs().max()) if a.numel() else 0


def compare_still(planes, albedo, row):
    """The still epilogue kernel, by value and by row, with and without
    the linear, out of place and in place (into a copy of the history),
    against its plain version (the host row, out of place).  Returns the
    float32 values and u8 values that differ, and the u8 max diff."""
    from voxtracer_torch.engine.params import DeviceRow
    from voxtracer_torch.ops import epilogue

    dev_row = DeviceRow(torch.from_numpy(row[None].copy()).cuda()[0], row)
    want = epilogue.still_epilogue_plain(*planes, albedo, row, True)
    f32 = u8 = u8_max = 0
    for params in (row, dev_row):
        for keep, in_place in ((False, False), (True, False), (False, True),
                               (True, True)):
            history = [t.clone() for t in planes[3:]]
            got = epilogue.still_epilogue_cuda(
                *planes[:3], *(history if in_place else planes[3:]), albedo,
                params, keep, in_place=in_place)
            torch.cuda.synchronize()
            if in_place:  # the history holds blend, next blend, depth
                assert got[0] is history[0] and got[1] is history[1]
                f32 += n_differ(history[2], planes[2])
            for i, (a, b) in enumerate(zip(got, want)):
                if a is None:
                    assert i == 2 and not keep or albedo is None, (i, keep)
                    continue
                if a.dtype == torch.uint8:
                    u8 += n_differ(a, b)
                    u8_max = max(u8_max, u8_max_diff(a, b))
                else:
                    f32 += n_differ(a, b)
    return f32, u8, u8_max


def compare_encode(args):
    """The encode kernel (by value and by row where it modulates, with
    and without the linear) against its plain version on ``args``
    (linear, height, width[, albedo, host row]).  Returns the float32
    and u8 values that differ and the u8 max diff."""
    from voxtracer_torch.engine.params import DeviceRow
    from voxtracer_torch.ops import epilogue

    want_img, want_out = epilogue.encode_plain(*args, keep_linear=True)
    entries = [args]
    if len(args) > 3:
        row = args[4]
        entries.append((*args[:4], DeviceRow(
            torch.from_numpy(row[None].copy()).cuda()[0], row)))
    f32 = u8 = u8_max = 0
    for entry in entries:
        for keep in (False, True):
            img, out = epilogue.encode_cuda(*entry, keep_linear=keep)
            torch.cuda.synchronize()
            u8 += n_differ(img, want_img)
            u8_max = max(u8_max, u8_max_diff(img, want_img))
            if out is not None:
                f32 += n_differ(out, want_out)
            else:
                assert len(args) > 3 and not keep
    return f32, u8, u8_max


def nan_planes(h, w, rng):
    """Still-epilogue planes with NaN, +-inf, negative and > 1 values in
    every input plane (seeded)."""
    def plane(c, lo, hi):
        a = rng.uniform(lo, hi, (c, h, w) if c else (h, w)).astype(np.float32)
        flat = a.reshape(-1)
        for value in (np.nan, np.inf, -np.inf, -3.5, 7.25):
            flat[rng.integers(0, flat.size, flat.size // 50)] = value
        return torch.from_numpy(a).cuda()

    depth = plane(0, -1.0, 40.0)
    planes = (plane(3, -0.5, 2.5), plane(3, -1.0, 1.0), depth,
              plane(3, -0.5, 2.5), plane(0, 0.0, 1.2),
              depth + torch.from_numpy(
                  rng.uniform(-0.05, 0.05, (h, w)).astype(np.float32)).cuda())
    return planes, plane(3, -0.2, 1.5)


def phase_epilogue(smi):
    """Phase 19: the still-epilogue and encode kernels against their
    plain versions on the card, by value and by row, with and without
    the linear, out of place and in place, on the main path's planes
    (``renderbench.epilogue_cases``: menger 1280x720 at the bench camera,
    monu9 1920x1080 and castle 3840x2160 with history valid and invalid,
    monu9's dolly planes with both cameras, the encode of monu9's dolly
    temporal output at r = 0 and of its denoised frame at r = 2, and of
    the 720p and 4K still blends), a ragged 333x187, planes with NaN,
    +-inf, negative and > 1 values, a cropped encode, and every float32
    in [0, 1] through the encode: values that differ; then each timed
    case's times (``renderbench.time_epilogue_case``), plain time, bound
    and miss share.  Returns the epilogue's entry (config 2's case:
    menger 1280x720, history valid), the encode's cases and the largest
    u8 difference seen."""
    from voxtracer_torch.engine.camera import Camera
    from voxtracer_torch.engine.params import (
        DenoiseParams,
        RenderParams,
        TemporalParams,
        pack_frame_rows,
    )
    from voxtracer_torch.engine.scene import SceneTables, load_scene
    from voxtracer_torch.ops import epilogue
    from voxtracer_torch.ops.noise import blue_noise_buffer

    noise = torch.from_numpy(blue_noise_buffer()).cuda()
    rng = np.random.default_rng(19)

    def frame_row(cam_rows, old_rows, valid, tp=TemporalParams(),
                  dp=DenoiseParams()):
        return pack_frame_rows([cam_rows], old_rows, valid, 2,
                               RenderParams(), tp, dp)[0]

    cases = epilogue_cases()
    # untimed: menger's ragged 333x187 (frame 2 over frame 1, random old
    # blends) and planes with NaN, +-inf, negative and > 1 values
    menger = load_scene("menger")
    bench_cam = Camera(position=np.array(BENCH_POS),
                       direction=np.array(BENCH_DIR))
    cw, ch = 333, 187
    tables = SceneTables(menger, "cuda")
    old = trace_cuda(tables, noise, bench_cam, cw, ch, frame=1)
    new = trace_cuda(tables, noise, bench_cam, cw, ch, frame=2)
    blend = torch.from_numpy(
        rng.uniform(0.02, 1.0, (ch, cw)).astype(np.float32)).cuda()
    rows = bench_cam.rows(cw, ch)
    cases.append(still_case(
        "menger", (new["color"], new["normal"], new["depth"], old["color"],
                   blend, old["depth"]), new["albedo"],
        frame_row(rows, rows, True), True, timed=False))
    planes, albedo = nan_planes(ch, cw, rng)
    odd = (TemporalParams(sample_blending=0.3, maximum_blending=0.9,
                          blending_distance_cutoff=0.2),
           DenoiseParams(albedo_factor=0.35))
    cases.append(still_case("NaN/inf/negative/>1 planes", planes, albedo,
                            frame_row(rows, rows, True, *odd), True,
                            timed=False))
    nan_in, nan_alb = nan_planes(ch + 3, cw + 5, rng)
    for args in ((nan_in[0], ch, cw, nan_alb, frame_row(rows, rows, True,
                                                        *odd)),
                 (nan_in[0], ch, cw)):
        cases.append({"kernel": "encode", "size": f"{cw}x{ch}",
                      "case": f"NaN planes {cw + 5}x{ch + 3} cropped"
                      + (", modulated" if len(args) > 3 else ""),
                      "history_valid": True, "args": args, "timed": False})

    u8_worst = 0
    timed, encodes = {}, {}
    for c in cases:
        label = f"{c['kernel']} {c['case']} {c['size']}"
        if c["kernel"] == "still epilogue":
            label += f" history valid {c['history_valid']}"
            planes, albedo, row = c["args"][:6], c["args"][6], c["args"][7]
            f32, u8, u8_max = compare_still(planes, albedo, row)
            f32_b, _, _ = compare_still(planes, None, row)  # the blend alone
            line = (f"{label}: f32 values differing {f32} (blend alone "
                    f"{f32_b}), u8 values differing {u8} (max {u8_max})")
            assert f32 == 0 and f32_b == 0 and u8_max <= 1, (label, f32, u8)
            plain = epilogue.still_epilogue_plain
        else:
            f32, u8, u8_max = compare_encode(c["args"])
            line = (f"{label}: f32 values differing {f32}, u8 values "
                    f"differing {u8} (max {u8_max})")
            assert f32 == 0 and u8_max <= 1, (label, f32, u8)
            plain = epilogue.encode_plain
        u8_worst = max(u8_worst, u8_max)
        if c["timed"]:
            # device-only times (replayed, and in the frame's cache
            # state) beside the eager calls', the earlier yardstick
            t = time_epilogue_case(c)
            t["plain_ms"] = cuda_time(lambda: plain(*c["args"]), 3)
            t["miss_share"] = c["miss_share"]
            (timed if c["kernel"] == "still epilogue" else encodes)[
                label] = t
            line += (
                f"; miss share {c['miss_share']:.4f}, "
                f"{t['bytes_per_px']:.2f} B a pixel: replayed "
                f"{t['ms']:.4f} ms, in the frame's cache state "
                f"{t['frame_cache_ms']:.4f}, eager calls "
                f"{t['eager_ms']:.4f}, plain {t['plain_ms']:.3f}; bound "
                f"{t['bound_ms']:.4f} ({t['bound_by']}; share "
                f"{t['share']:.3f} / {t['share_frame_cache']:.3f} / "
                f"{t['share_eager']:.3f}), fixed bound "
                f"{t['fixed_bound_ms']:.4f} (share {t['fixed_share']:.3f})")
        say(19, f"{line} [{smi}]")
    # every float32 in [0, 1] (the clamp sends all others to 0, 1 or
    # NaN), in chunks of three 4096x4096 planes, and the specials
    top = int(np.float32(1.0).view(np.int32))
    chunk = 3 * 4096 * 4096
    u8_all = u8_all_max = 0
    for start in range(0, top + 1, chunk):
        bits = torch.arange(start, start + chunk, dtype=torch.int32,
                            device="cuda").clamp_max_(top)
        lin = bits.view(torch.float32).view(3, 4096, 4096)
        img, _ = epilogue.encode_cuda(lin, 4096, 4096)
        want, _ = epilogue.encode_plain(lin, 4096, 4096)
        u8_all += n_differ(img, want)
        u8_all_max = max(u8_all_max, u8_max_diff(img, want))
    special = torch.tensor(
        [np.nan, np.inf, -np.inf, -0.0, -1e-30, -5.0, 1.0000001, 3e38, 2.0],
        dtype=torch.float32, device="cuda").repeat(3, 1)[:, None, :]
    img, _ = epilogue.encode_cuda(special.contiguous(), 1, 9)
    want, _ = epilogue.encode_plain(special, 1, 9)
    u8_all += n_differ(img, want)
    u8_worst = max(u8_worst, u8_all_max)
    say(19, f"encode of every float32 in [0, 1] ({top + 1} values) and of "
            f"NaN, +-inf, -0, negatives and > 1: u8 values differing "
            f"{u8_all} (max {u8_all_max}) [{smi}]")
    assert u8_all_max <= 1 and int((img != want).sum()) == 0
    main = timed[f"still epilogue menger bench camera {WIDTH}x{HEIGHT} "
                 "history valid True"]
    entry = {"max_abs_err": float(u8_worst), **main, "times_by_case": timed}
    return entry, encodes, u8_worst


def drive_path(phase, label, scene_name, w, h, path_name, radius, warmup,
               bursts, frames, smi):
    """A moving camera path through ``Renderer(device="cuda")``: warm-up
    frames, then timed bursts continuing along the path; asserts the
    launch counts and checks the output; then each kernel of the path
    against its plain version on the next frame's inputs (the path's
    accumulated history) and 2 all-plain frames against 2 kernel frames
    from one state.  Returns (launches, kernel entries by name)."""
    from voxtracer_torch.app import camera_paths
    from voxtracer_torch.engine.params import (
        pack_denoise_params,
        pack_frame_rows,
        pack_temporal_params,
        pack_trace_params,
    )
    from voxtracer_torch.engine.pipeline import Renderer, camera_moved
    from voxtracer_torch.engine.scene import load_scene
    from voxtracer_torch.ops import denoise, epilogue, temporal, trace

    kernels = frame_kernels()
    scene = load_scene(scene_name)
    path = camera_paths.PATHS[path_name](scene)
    cams = (path(i / 30.0) for i in itertools.count())
    torch.cuda.reset_peak_memory_stats()
    r = Renderer(scene=scene, height=h, width=w, device="cuda",
                 denoise_radius=radius, lean=True)
    rays = torch.zeros(trace.N_PHASES, dtype=torch.int64, device="cuda")
    moving = 0
    out = None

    def step(count_rays):
        nonlocal moving, out
        cam = next(cams)
        moving += bool(r.state["history_valid"]
                       and camera_moved(r.state, cam.rows(w, h)))
        out = r.render(cam)
        if count_rays:
            rays.add_(out["rays"])

    for k in kernels.values():
        k.launches = 0
    for _ in range(warmup):
        step(False)
    torch.cuda.synchronize()
    times = [cuda_time(lambda: step(True), frames) for _ in range(bursts)]
    launches = {name: k.launches for name, k in kernels.items()}
    n = warmup + bursts * frames
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    assert moving == n - 1, f"{moving} moving frames of {n}"
    # the first frame is still: the still epilogue (at r >= 1 its blend
    # alone); every frame at r >= 1 and every moving one encodes
    want = {"trace": n, "temporal": moving, "denoise": n if radius else 0,
            "resample": 0, "stall": 0, "epilogue": n - moving,
            "encode": n if radius else moving, "trace_steps": 0}
    assert launches == want, f"launches {launches} != {want}"

    image = out["image"].cpu().numpy()
    depth = out["depth"].cpu().numpy()
    blend = r.state["accum_blend"].cpu().numpy()
    assert image.shape == (h, w, 3) and image.dtype == np.uint8
    assert np.isfinite(r.state["accum_color"].cpu().numpy()).all()
    hit = depth >= 0
    hit_frac = float(hit.mean())
    kept = float((blend[hit] < 0.5).mean()) if hit.any() else 0.0
    std = float(image.astype(np.float32).std())
    assert hit_frac > 0.01 and std > 1.0, (hit_frac, std)
    assert r.frame_number == n and r.still_sample == 1
    ms = statistics.median(times)
    rays_per_frame = rays.sum().item() / (bursts * frames)
    say(phase, f"{label} {w}x{h} {path_name} r={radius}, {n} frames "
               f"({moving} moving with history), launches {launches}: burst "
               f"ms/frame {', '.join(f'{t:.3f}' for t in times)}; median "
               f"{ms:.3f} ms ({1000.0 / ms:.2f} fps), {rays_per_frame:.0f} "
               f"rays/frame, {rays_per_frame / (ms * 1e-3) / 1e6:.1f} "
               f"Mrays/s, peak {peak_mib:.0f} MiB, hit fraction "
               f"{hit_frac:.4f}, history kept on {kept:.3f} of hits, image "
               f"std {std:.1f} [{smi}]")

    # each kernel of the path against its plain version on the next
    # frame's inputs: the trace's G-buffer, the accumulated history, and
    # the blend the denoise stage receives
    cam = path(n / 30.0)
    rows = cam.rows(w, h)
    targs = (r.tables, pack_trace_params(rows, r.render_params), r.noise,
             n + 1, h, w)
    g = trace.render_sample_cuda(*targs)
    p = trace.render_sample_plain(*targs)
    hargs = (g["color"], g["normal"], g["depth"], r.state["accum_color"],
             r.state["accum_blend"], r.state["old_depth"],
             pack_temporal_params(rows, r.state["old_cam"],
                                  r.temporal_params, True))
    kc, kb = temporal.temporal_blend_reproject_cuda(*hargs)
    pc, pb = temporal.temporal_blend_reproject_plain(*hargs)
    dargs = (kc, g["normal"], g["depth"], g["albedo"], g["node"],
             pack_denoise_params(rows, r.denoise_params), radius)
    torch.cuda.synchronize()
    # the bars of phases 3, 5 and 6
    flips = int((g["node"] != p["node"]).sum())
    cerr = (g["color"] - p["color"]).abs().amax(0)
    assert flips == 0 and torch.equal(g["depth"], p["depth"])
    assert int((cerr > 1e-3).sum()) <= 0.005 * w * h
    assert torch.equal(g["rays"][:3], p["rays"][:3])
    assert torch.equal(g["steps"][:3], p["steps"][:3]), (g["steps"], p["steps"])
    blend_eq = torch.equal(kb, pb)
    herr = float((kc - pc).abs().max())
    kept_next = int(((pb < 0.5) & (g["depth"] >= 0)).sum())
    assert blend_eq and herr <= 1e-6 and kept_next > 0, (blend_eq, herr,
                                                         kept_next)
    checks = (f"trace colour max err {float(cerr.max()):g}, px beyond 1e-3 "
              f"{int((cerr > 1e-3).sum())}; temporal next blend equal "
              f"{blend_eq}, colour max err {herr:g}, history kept on "
              f"{kept_next} px")
    stage = {
        "trace": cuda_time(lambda: trace.render_sample_cuda(*targs), 10),
        "trace plain": cuda_time(lambda: trace.render_sample_plain(*targs), 1),
        "temporal": cuda_time(
            lambda: temporal.temporal_blend_reproject_cuda(*hargs), 20),
        "temporal plain": cuda_time(
            lambda: temporal.temporal_blend_reproject_plain(*hargs), 3),
    }
    entries = {
        "trace": {"max_abs_err": float(cerr.max()), "ms": stage["trace"],
                  "plain_ms": stage["trace plain"]},
        "temporal": {"max_abs_err": herr, "ms": stage["temporal"],
                     "plain_ms": stage["temporal plain"]},
    }
    entries["temporal"]["bound_ms"], entries["temporal"]["bound_by"] = bound(
        64 * h * w, TEMPORAL_FLOPS_PER_PX * h * w, FP32_FLOPS_PER_S)
    if radius:
        kd, pd, n_far, n_diff = compare_denoise(dargs)
        derr = (kd - pd).abs()
        assert n_far == 0 and bool(torch.isfinite(pd).all()), n_far
        checks += (f"; denoise r={radius} max err {float(derr.max()):g}, "
                   f"values beyond 1e-6 abs+rel {n_far}, values differing "
                   f"{n_diff}")
        stage["denoise"] = cuda_time(lambda: denoise.denoise_cuda(*dargs), 20)
        stage["denoise plain"] = cuda_time(
            lambda: denoise.denoise_plain(*dargs), 1)
        entries["denoise"] = {"max_abs_err": float(derr.max()),
                              "ms": stage["denoise"],
                              "plain_ms": stage["denoise plain"]}
        (entries["denoise"]["bound_ms"],
         entries["denoise"]["bound_by"]) = denoisebench.denoise_bound(
             h, w, radius)
    # the encode of the frame: the blend modulated at r = 0, the
    # denoised frame at r >= 1
    frame_row = pack_frame_rows([rows], r.state["old_cam"], True, n + 1,
                                r.render_params, r.temporal_params,
                                r.denoise_params)[0]
    eargs = ((kc, h, w, g["albedo"], frame_row) if not radius
             else (kd, h, w))
    f32, u8, u8_max = compare_encode(eargs)
    assert f32 == 0 and u8_max <= 1, (f32, u8, u8_max)  # phase 19's bar
    checks += (f"; encode f32 values differing {f32}, u8 values differing "
               f"{u8}")
    t = time_epilogue_case(encode_case(label, eargs, g["depth"]))
    stage["encode"] = t["ms"]
    stage["encode in the frame's cache state"] = t["frame_cache_ms"]
    stage["encode, eager calls"] = t["eager_ms"]
    stage["encode plain"] = cuda_time(lambda: epilogue.encode_plain(*eargs),
                                      3)
    entries["encode"] = {"max_abs_err": float(u8_max),
                         "plain_ms": stage["encode plain"],
                         **{k: t[k] for k in ("ms", "frame_cache_ms",
                                              "eager_ms", "bound_ms",
                                              "bound_by")}}
    say(phase, "kernels alone on the next frame's inputs: "
               + ", ".join(f"{k} {v:.4f} ms" for k, v in stage.items())
               + f"; {checks} [{smi}]")

    compare_row_entries(phase, r, rows, n + 1, g, radius, smi)

    # 2 frames with every stage plain, then 2 kernel frames from the
    # same state along the same poses: their images must agree
    state = {key: (v.clone() if torch.is_tensor(v) else v)
             for key, v in r.state.items()}
    n0 = r.frame_number
    poses = [path((n + i) / 30.0) for i in range(2)]
    plain = dict(trace=trace.render_sample_plain,
                 temporal=temporal.temporal_blend_reproject_plain,
                 still_epilogue=epilogue.still_epilogue_plain,
                 encode=epilogue.encode_plain)
    if radius:
        plain["denoise"] = denoise.denoise_plain
    plain_images = []
    plain_ms = cuda_time(
        lambda: plain_images.append(eager_render(
            r, poses[len(plain_images)], **plain)["image"]), 2)
    r.state, r.frame_number = state, n0
    for cam in poses:
        img_kernel = r.render(cam)["image"]
    diff = (img_kernel.int() - plain_images[-1].int()).abs().cpu().numpy()
    n_px = int((diff > 2).any(-1).sum())
    say(phase, f"all-plain frame {plain_ms:.1f} ms vs kernel frame "
               f"{ms:.3f} ms; u8 px differing by >2 after 2 frames {n_px} "
               f"of {w * h} [{smi}]")
    assert n_px <= 0.005 * w * h
    return {name: k / n for name, k in launches.items()}, launches, entries


def compare_row_entries(phase, r, cam_rows, frame, g, radius, smi):
    """On the next frame of renderer ``r`` (camera rows ``cam_rows``,
    G-buffer ``g``, the accumulated history): each kernel's row-reading
    entry against its by-value entry, and the row-reading still blend
    and modulate against the forms reading Python numbers.  The row is
    the second of two on the device."""
    from voxtracer_torch.engine import params as P
    from voxtracer_torch.ops import denoise, epilogue, temporal, trace

    h, w = g["depth"].shape
    rows = P.pack_frame_rows(
        [r.state["old_cam"], cam_rows], r.state["old_cam"], True, frame - 1,
        r.render_params, r.temporal_params, r.denoise_params)
    row = rows[1]
    dev_rows = P.DeviceRow(torch.from_numpy(rows).cuda()[1], rows[0])
    vec = {"trace": row[P.ROW_TRACE:P.ROW_FRAME],
           "temporal": row[P.ROW_TEMPORAL:P.ROW_DENOISE],
           "denoise": row[P.ROW_DENOISE:P.ROW_KEEP_SAMPLE]}
    history = (r.state["accum_color"], r.state["accum_blend"],
               r.state["old_depth"])
    planes = (g["color"], g["normal"], g["depth"], *history)

    def trace_entry(params, n):
        return trace.render_sample_cuda(r.tables, params, r.noise, n, h, w)

    def temporal_entry(params):
        return temporal.temporal_blend_reproject_cuda(*planes, params)

    by_row, by_value = trace_entry(dev_rows, None), trace_entry(vec["trace"],
                                                                frame)
    assert all(torch.equal(by_row[k], by_value[k]) for k in by_value)
    assert torch.equal(by_value["node"], g["node"])
    rc, rb = temporal_entry(dev_rows)
    vc, vb = temporal_entry(vec["temporal"])
    assert torch.equal(rc, vc) and torch.equal(rb, vb)
    times = {
        "trace": (cuda_time(lambda: trace_entry(dev_rows, None), 10),
                  cuda_time(lambda: trace_entry(vec["trace"], frame), 10)),
        "temporal": (cuda_time(lambda: temporal_entry(dev_rows), 20),
                     cuda_time(lambda: temporal_entry(vec["temporal"]), 20)),
    }
    if radius:
        def denoise_entry(params):
            return denoise.denoise_cuda(vc, g["normal"], g["depth"],
                                        g["albedo"], g["node"], params, radius)

        assert torch.equal(denoise_entry(dev_rows),
                           denoise_entry(vec["denoise"]))
        times["denoise"] = (
            cuda_time(lambda: denoise_entry(dev_rows), 20),
            cuda_time(lambda: denoise_entry(vec["denoise"]), 20))
    # the epilogue kernels: the still epilogue on this frame's planes,
    # the encode of the blend at r = 0, each with the linear
    def still_entry(params):
        return epilogue.still_epilogue_cuda(*planes, g["albedo"], params, True)

    def encode_entry(params):
        return epilogue.encode_cuda(vc, h, w, g["albedo"], params, True)

    for entry in (still_entry, encode_entry):
        by_row, by_value = entry(dev_rows), entry(row)
        assert all(torch.equal(a, b) for a, b in zip(by_row, by_value)
                   if a is not None), entry.__name__
    times["still epilogue"] = (cuda_time(lambda: still_entry(dev_rows), 20),
                               cuda_time(lambda: still_entry(row), 20))
    times["encode"] = (cuda_time(lambda: encode_entry(dev_rows), 20),
                       cuda_time(lambda: encode_entry(row), 20))
    # the plain torch stages of a still frame and of r = 0
    sc, sb = temporal.temporal_blend_still_row(*planes, dev_rows.row)
    pc, pb = temporal.temporal_blend_still_planar(
        *planes, cam_rows, r.state["old_cam"], r.temporal_params, True)
    assert torch.equal(sc, pc) and torch.equal(sb, pb)
    assert torch.equal(
        denoise.modulate_row(vc, g["albedo"], dev_rows.row),
        denoise._modulate(vc, g["albedo"], vec["denoise"][14]))
    torch.cuda.synchronize()
    say(phase, "row-reading entries == by-value entries (trace, temporal"
               + (", denoise" if radius else "") + ", still epilogue, "
               "encode), row-reading still "
               "blend and modulate == the forms reading Python numbers; ms "
               "by row / by value: " + ", ".join(
                   f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in times.items())
               + f" [{smi}]")


def phase_sequence(label, scene_name, w, h, path_name, radius, burst, smi,
                   frames=FRAMES, timed=True):
    """The offline export path against the per-frame loop: two
    renderers from equal state, ``frames`` cameras of the path through
    ``render()`` and through ``render_sequence`` (``render_burst`` where
    ``burst``); frames, state, counters and launch counts equal.  Then
    ms/frame of both in turns.  Returns the sequence's launch counts
    and (ms/frame of the loop, of the sequence)."""
    from voxtracer_torch.app import camera_paths
    from voxtracer_torch.engine.pipeline import STATE_PLANES, Renderer
    from voxtracer_torch.engine.scene import load_scene

    kernels = frame_kernels()
    scene = load_scene(scene_name)
    if path_name == "mixed":
        orbit = camera_paths.orbit(scene)
        pose = [orbit(t / 30.0) for t in (0, 0, 1, 2, 2, 2, 3)]
        path = lambda i: pose[i % len(pose)]  # noqa: E731
    elif burst:
        cam = camera_paths.PATHS[path_name](scene)(0.0)
        path = lambda i: cam  # noqa: E731
    else:
        along = camera_paths.PATHS[path_name](scene)
        path = lambda i: along(i / 30.0)  # noqa: E731
    kw = dict(scene=scene, height=h, width=w, device="cuda",
              denoise_radius=radius, lean=True)
    loop, seq = Renderer(**kw), Renderer(**kw)
    at = {id(loop): 0, id(seq): 0}  # each renderer's place on the path

    def cams(r, n):
        at[id(r)] += n
        return [path(i) for i in range(at[id(r)] - n, at[id(r)])]

    def run_loop(n):
        return [loop.render(c)["image"] for c in cams(loop, n)]

    def run_seq(n):
        if burst:
            return seq.render_burst(cams(seq, n)[0], n)
        return seq.render_sequence(cams(seq, n))

    def counted(fn, n):
        for k in kernels.values():
            k.launches = 0
        out = fn(n)
        return out, {name: k.launches for name, k in kernels.items()}

    def same_state():
        return (all(torch.equal(loop.state[k], seq.state[k])
                    for k in STATE_PLANES)
                and np.array_equal(loop.state["old_cam"],
                                   seq.state["old_cam"])
                and (loop.frame_number, loop.still_sample)
                == (seq.frame_number, seq.still_sample))

    # the first sequence captures its graphs (one eager frame before
    # each); the second replays them and is the one whose launches are
    # held against the loop's
    want = run_loop(frames)
    got = run_seq(frames)
    assert torch.equal(got, want[-1] if burst else torch.stack(want))
    assert same_state()
    want, n_loop = counted(run_loop, frames)
    got, n_seq = counted(run_seq, frames)
    torch.cuda.synchronize()
    assert torch.equal(got, want[-1] if burst else torch.stack(want))
    assert same_state(), (loop.frame_number, seq.frame_number,
                          loop.still_sample, seq.still_sample)
    assert n_seq == n_loop and n_seq["trace"] == frames, (n_seq, n_loop)
    assert bool(n_seq["denoise"]) == bool(radius)
    assert n_seq["resample"] == 0 and n_seq["stall"] == 0, n_seq
    image = got if burst else got[-1]
    assert image.shape == (h, w, 3) and image.dtype == torch.uint8
    std = float(image.float().std())
    assert std > 1.0, std
    graphs = sorted(seq._runner.graphs)
    say(12, f"{label} {w}x{h} {path_name} r={radius}: "
            f"{'render_burst' if burst else 'render_sequence'} of {frames} "
            f"frames == {frames} render() calls (frames, state, counters); "
            f"graphs captured for reproject in {graphs}; launches of the "
            f"replayed sequence {n_seq} == the loop's; image std {std:.1f}")
    if not timed:
        return n_seq, None
    for fn in (run_loop, run_seq):
        fn(WARMUP)
    torch.cuda.synchronize()
    ms = {"loop": [], "sequence": []}
    for mode in ("loop", "sequence", "sequence", "loop"):
        fn = run_loop if mode == "loop" else run_seq
        for _ in range(BURSTS):
            ms[mode].append(cuda_time(lambda: fn(frames), 1) / frames)
    # the device activities (and copies among them) of one frame of
    # the sequence: those between its first and last frames' trace
    # launches in one profiled sequence
    from voxtracer_torch.app.profile import frame_activities

    activities, copies = frame_activities(lambda: run_seq(frames),
                                          torch.device("cuda"), frames)
    say(12, f"{label}: device activities a replayed frame {activities:g}, "
            f"copies among them {copies:g} (the row-reading launches' rows"
            + ("; a still frame blends into the carried state" if burst
               else "; a reprojecting frame copies its blend into it")
            + f") [{smi}]")
    if burst and not radius:  # trace's and still epilogue's rows only
        assert copies == 2, copies
    loop.render(path(at[id(loop)]))  # both still render after it
    seq.render(path(at[id(seq)]))
    # the sequence's host prologue: the cameras' rows, packed before the
    # first replay
    path_cams = [path(i) for i in range(frames)]
    t0 = time.perf_counter()
    for _ in range(20):
        seq._pack_sequence(path_cams)
    pack_us = (time.perf_counter() - t0) / 20 / frames * 1e6
    med = {k: statistics.median(v) for k, v in ms.items()}
    say(12, f"{label}: ms/frame in bursts of {frames}, in turns (loop, "
            "sequence, sequence, loop): loop "
            + ", ".join(f"{t:.3f}" for t in ms["loop"]) + " (median "
            f"{med['loop']:.3f}); sequence "
            + ", ".join(f"{t:.3f}" for t in ms["sequence"]) + " (median "
            f"{med['sequence']:.3f}); loop / sequence "
            f"{med['loop'] / med['sequence']:.2f}; the host packs a "
            f"sequence's rows in {pack_us:.1f} us a frame [{smi}]")
    return n_seq, (med["loop"], med["sequence"])


def phase_cli(smi):
    """The CLI on the card: batches, every frame as a PNG, a snapshot,
    a resumed run against an uninterrupted one."""
    from voxtracer_torch.app import cli

    base = ["--device", "cuda", "--scene", "menger", "--size",
            f"{WIDTH}x{HEIGHT}",
            "--camera-pos=" + ",".join(str(v) for v in BENCH_POS),
            "--camera-dir=" + ",".join(str(v) for v in BENCH_DIR)]
    with tempfile.TemporaryDirectory() as tmp:
        def at(name):
            return os.path.join(tmp, name)

        t0 = time.perf_counter()
        rc, _ = run_captured(13, cli.main, [
            *base, "--batch", "8", "--frames", "20", "--video-dir",
            at("frames"), "--save-snapshot", at("s.npz"), "--stats", "-o",
            at("a.png")])
        assert rc == 0
        assert sorted(os.listdir(at("frames"))) == [
            f"frame_{i:05d}.png" for i in range(20)]
        rc, _ = run_captured(13, cli.main, [
            *base, "--batch", "4", "--frames", "4", "--resume", at("s.npz"),
            "--video-dir", at("frames"), "-o", at("b.png")])
        assert rc == 0
        assert sorted(os.listdir(at("frames"))) == [
            f"frame_{i:05d}.png" for i in range(24)]
        rc, _ = run_captured(13, cli.main, [
            *base, "--frames", "24", "-o", at("whole.png")])
        assert rc == 0

        def read(name):
            with open(at(name), "rb") as f:
                return f.read()

        assert read("b.png") == read("whole.png") != read("a.png")
        assert read("b.png") == read(os.path.join("frames", "frame_00023.png"))
        assert read("a.png") == read(os.path.join("frames", "frame_00019.png"))
        say(13, "cli: --batch 8 --frames 20 --video-dir --save-snapshot, "
                "then --resume --batch 4 --frames 4: 24 PNGs; the resumed "
                "final image == an uninterrupted 24-frame run's; "
                f"{time.perf_counter() - t0:.1f} s [{smi}]")


def run_captured(phase, fn, argv):
    """``fn(argv)`` with its standard output captured; every line is
    printed with the phase tag, also when ``fn`` raises.  Returns the
    exit code and the JSON rows."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = fn(argv)
    finally:
        lines = out.getvalue().splitlines()
        for ln in lines:
            say(phase, ln)
    return rc, [json.loads(ln) for ln in lines if ln.startswith("{")]


def resampler_inputs(args):
    """The history stack and source coordinates that the reprojecting
    blend hands its resampler for these temporal arguments."""
    from voxtracer_torch.ops import reproject, temporal

    seen = {}

    def grab(hist, px_f, py_f):
        seen.update(hist=hist, px_f=px_f, py_f=py_f)
        return reproject.resample_plain(hist, px_f, py_f)

    temporal._blend_reproject(*args, grab)
    return seen["hist"], seen["px_f"], seen["py_f"]


def phase_resample(smi, poses):
    """The resample kernel against its plain version at 1920x1080, C=5,
    on phase 5's coordinates and on a field with non-finite entries.
    Returns its kernel entry (times from the dolly field)."""
    from voxtracer_torch.ops import reproject

    fields = [(f"monu9 {label}", *resampler_inputs(args))
              for label, args, _, _ in poses]
    _, hist, px_f, py_f = fields[0]
    bad_x, bad_y = px_f.clone(), py_f.clone()
    bad_x[0, :64] = float("nan")
    bad_y[1, :64] = float("inf")
    bad_x[2, :64] = float("-inf")
    bad_y[3, :64] = 1e30
    bad_x[4, :64] = -1e30
    fields.append(("dolly with NaN/inf/1e30 coordinates", hist, bad_x, bad_y))
    entry = None
    for label, hist, px_f, py_f in fields:
        ks, kok = reproject.resample_cuda(hist, px_f, py_f)
        ps, pok = reproject.resample_plain(hist, px_f, py_f)
        torch.cuda.synchronize()
        # no transcendental: bit-equal, NaN exactly where a coordinate
        # is not finite
        equal = torch.allclose(ks, ps, rtol=0.0, atol=0.0, equal_nan=True)
        err = float(torch.where(ks.isnan() & ps.isnan(), 0.0,
                                (ks - ps).abs()).max())
        nan_px = ks.isnan().any(0)
        finite = torch.isfinite(px_f) & torch.isfinite(py_f)
        h, w = px_f.shape
        inside = float(((px_f >= 0) & (px_f <= w) & (py_f >= 0)
                        & (py_f <= h)).float().mean())
        k_ms = cuda_time(lambda: reproject.resample_cuda(hist, px_f, py_f), 20)
        p_ms = cuda_time(lambda: reproject.resample_plain(hist, px_f, py_f), 5)
        say(9, f"resample {label} {w}x{h} C={hist.shape[0]}: coordinates "
               f"inside the image {inside:.4f}, bit-equal {equal}, max abs "
               f"err {err:g}, NaN px {int(nan_px.sum())}; kernel {k_ms:.4f} "
               f"ms, plain {p_ms:.3f} ms [{smi}]")
        assert equal and err == 0.0 and bool(kok.all()) and bool(pok.all())
        assert torch.equal(nan_px, ~finite)
        if entry is None:
            entry = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}
            channels = hist.shape[0]
            entry["bound_ms"], entry["bound_by"] = bound(
                (8 * channels + 9) * h * w,
                RESAMPLE_FLOPS_PER_PX_PLANE * channels * h * w,
                FP32_FLOPS_PER_S)
            entry["library_ms"], lib_err = grid_sample_yardstick(
                hist, px_f, py_f, ks, smi)
            entry["library_max_abs_diff"] = lib_err
    return entry


def grid_sample_yardstick(hist, px_f, py_f, kernel_out, smi):
    """One PyTorch call computing the resample: ``F.grid_sample`` with
    bilinear taps, border padding and aligned corners at the same pixel
    centres (the port never calls it).  Returns its time and its largest
    difference from the kernel's output."""
    import torch.nn.functional as F

    channels, h, w = hist.shape
    gx = (px_f - 0.5) * (2.0 / (w - 1)) - 1.0
    gy = (py_f - 0.5) * (2.0 / (h - 1)) - 1.0
    grid = torch.stack([gx, gy], dim=-1)[None]

    def call():
        return F.grid_sample(hist[None], grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    out = call()[0]
    diff = float((out - kernel_out).abs().max())
    ms = cuda_time(call, 20)
    say(9, f"F.grid_sample yardstick {w}x{h} C={channels}: {ms:.4f} ms, max "
           f"abs diff from the kernel {diff:g} [{smi}]")
    return ms, diff


def phase_temporal_blend(smi, poses):
    """The channels-last blend on CUDA tensors (which runs the resample
    kernel) against the reprojecting body around the plain resampler at
    1920x1080 on each pose of phase 5."""
    from voxtracer_torch.engine.params import TemporalParams
    from voxtracer_torch.ops import reproject, temporal

    hwc = lambda a: torch.movedim(a, 0, -1)  # noqa: E731
    for label, args, rows, old_rows in poses:
        color, normal, depth, old_color, old_blend, old_depth, _ = args
        blend_args = (hwc(color), hwc(normal), depth, hwc(old_color),
                      old_blend, old_depth, rows, old_rows, TemporalParams(),
                      True)

        def blend():
            return temporal.temporal_blend(*blend_args, reproject=True)

        def plain():
            return temporal._blend_reproject(*args, reproject.resample_plain)

        before = reproject.resample_cuda.launches
        kc, kb = blend()
        launched = reproject.resample_cuda.launches - before
        pc, pb = plain()
        torch.cuda.synchronize()
        equal = torch.equal(kc, hwc(pc)) and torch.equal(kb, pb)
        kept = int(((pb < 0.5) & (depth >= 0)).sum())
        k_ms = cuda_time(blend, 10)
        p_ms = cuda_time(plain, 10)
        h, w = depth.shape
        say(10, f"temporal_blend channels-last {label} {w}x{h}: == the "
                f"planar body with the plain resampler {equal}, resample "
                f"kernel launches {launched}, history kept on {kept} px; "
                f"with the kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms [{smi}]")
        assert equal and launched == 1 and kept > 0


def phase_stallbench(smi):
    """The stall kernel against its plain version on
    ``stallbench.check_cases()``; the default matrix through the CLI;
    ser:1 and static:1 against their plain versions at the CLI's trips;
    the bounds.  Returns (launches of the CLI run, kernel entry)."""
    from voxtracer_torch.app import stallbench

    tab, x = stallbench.make_inputs("cuda")
    cases = stallbench.check_cases()
    for case in cases:
        k, cycles = stallbench.run_cuda(tab, x, *case)
        p = stallbench.run_plain(tab, x, *case)
        torch.cuda.synchronize()
        assert torch.equal(k, p), case
        assert int(cycles.item()) > 0
    say(11, f"stallbench kernel == plain on {len(cases)} cases (every mode "
            f"at h in 1, 2, 4, 8 and 64 trips, the longest chains, odd "
            f"trips and sweeps)")

    stallbench.run_cuda.launches = 0
    rc, rows = run_captured(11, stallbench.main, ["--json"])
    launches = stallbench.run_cuda.launches
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    assert rc == 0 and len(rows) == len(stallbench.default_cases())
    assert launches == len(rows) * 6, launches  # warm + 5 timed each
    assert all(r["cycles_per_trip"] > 0 for r in rows)
    # the bound is the least time the card could take: no case beats it
    assert all(r["share"] <= 1 for r in rows), [
        (r["mode"], r["h"], r["pre"], r["mid"], r["share"]) for r in rows]
    by = {(r["mode"], r["h"], r["pre"], r["mid"]): r for r in rows}
    ser1, static1 = by[("ser", 1, 0, 0)], by[("static", 1, 0, 0)]
    default_trips = 16384
    plain_ms = {}
    for mode in ("ser", "static"):
        want = []
        plain_ms[mode] = cuda_time(lambda: want.append(stallbench.run_plain(
            tab, x, default_trips, mode, 1, 0, 0)), 1)
        k, _ = stallbench.run_cuda(tab, x, default_trips, mode, 1, 0, 0)
        torch.cuda.synchronize()
        assert torch.equal(k, want[0]), f"{mode}:1 at the CLI's trips"
    summary = ", ".join(
        f"{r['mode']}:{r['h']}:{r['pre']}:{r['mid']} {r['cycles_per_trip']}"
        + (f" ({r['stall_cycles_per_handoff']}/handoff)"
           if "stall_cycles_per_handoff" in r else "")
        for r in rows)
    say(11, f"cycles per trip (stall cycles per handoff): {summary}; ser:1 "
            f"kernel {ser1['ms']} ms, plain {plain_ms['ser']:.1f} ms at "
            f"{default_trips} trips, ser:1 and static:1 kernel == plain "
            f"there; launches {launches}; SM clock after the matrix "
            f"(current, max) {clock} [{smi}]")
    # the bound counted from what the probe computes (stall_work), over
    # one SM (the kernel is one block) and over the whole card; beside
    # it, for comparison with the kernel's first, ladder-walking version,
    # the old count of the TPU's ladder (a shared load and a select for
    # each of 24 rows an element), no bound of this kernel's: its ratio
    # to the time may exceed 1
    bound_ms, bound_by, card_ms = stallbench.stall_bound(
        default_trips, "ser", 1, 0, 0)
    ladder_ms = default_trips * 4096 * 2 * 24 / (
        LANE_OPS_PER_S / stallbench.N_SMS) * 1e3
    say(11, f"one-SM bound, {bound_by}: ser:1 {bound_ms:.4f} ms (share "
            f"{bound_ms / ser1['ms']:.4f}), static:1 {static1['bound_ms']} "
            f"ms (share {static1['share']}); whole card {card_ms:.6f} ms; "
            f"the ladder's count {ladder_ms:.4f} ms (count / time "
            f"{ladder_ms / ser1['ms']:.4f}) [{smi}]")
    return launches, {"max_abs_err": 0.0, "ms": ser1["ms"],
                      "plain_ms": plain_ms["ser"], "bound_ms": bound_ms,
                      "bound_by": bound_by, "static_ms": static1["ms"]}


def phase_harness(smi):
    """``voxtracer_torch.app.bench.main([])``: configs 1-6 at their full
    sizes.  Returns the launch counts of that run."""
    from voxtracer_torch.app import bench

    kernels = frame_kernels()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    rc, rows = run_captured(14, bench.main, [])
    seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    by = {}
    for r in rows:
        by.setdefault(r["config"], []).append(r)
    say(14, f"harness: rc {rc}, configs {sorted(by)}, {len(rows)} lines in "
            f"{seconds:.1f} s, launches {launches}")
    assert rc == 0 and sorted(by) == [1, 2, 3, 4, 5, 6]
    assert not any("error" in r for r in rows)
    assert all(r["device"] == smi for r in rows)
    assert all((n > 0) == (name not in ("stall", "trace_steps"))
               for name, n in launches.items()), launches
    assert by[1][0]["node_agreement"] >= 0.999, by[1]
    assert len(by[6]) == 15 and min(r["node_agreement"] for r in by[6]) >= 0.99
    for config in (2, 3, 4, 5):
        r = by[config][0]
        assert r["rays_per_frame"] > 0 and np.isfinite(r["ms_per_frame"])
    return launches


def phase_interactive(smi):
    """Phase 16: the web viewer's frames against an eager frame loop,
    a served stream read by a client, and the ibench rows.  Returns the
    seven kernels' launches per frame of the viewer loop."""
    from voxtracer_torch.app import camera_paths, ibench, web
    from voxtracer_torch.engine.pipeline import Renderer
    from voxtracer_torch.engine.scene import load_scene

    w, h, radius = 640, 360, 2
    scenes = {"chr_knight": load_scene("chr_knight"),
              "menger": load_scene("menger")}

    def renderer():
        return Renderer(scene=scenes["chr_knight"], height=h, width=w,
                        device="cuda", denoise_radius=radius, lean=True)

    # (a) scripted events through render_once == a loop of eager frames,
    # whose stages hold each kernel against its plain version on the
    # frame's own inputs
    viewer = web.WebViewer(renderer(), scenes=sorted(scenes))
    viewer.ctl.frame(camera_paths.static(scenes["chr_knight"])(0.0))
    plain = renderer()
    stages, held = hold_stages()
    published = []
    publish = viewer._publish

    def grab(img, rays):
        published.append((img.copy(), rays))
        publish(img, rays)

    viewer._publish = grab
    script = [
        [{"type": "grab", "grabbed": True}],
        [{"type": "keydown", "key": "w"}], [],
        [{"type": "keyup", "key": "w"}, {"type": "look", "dx": 30, "dy": -10}],
        [{"type": "look", "dx": -45, "dy": 4}],
        [{"type": "param", "name": "sun_strength", "value": 6.5}], [],
        [{"type": "param", "name": "denoise_radius", "value": 3}],
        [{"type": "look", "dx": 5, "dy": 0}],
        [{"type": "reset"}], [],
        [{"type": "size", "width": 320, "height": 180}], [],
        [{"type": "keydown", "key": "d"}, {"type": "keydown", "key": "shift"}],
        [{"type": "keyup", "key": "d"}, {"type": "keyup", "key": "shift"}],
        [{"type": "scene", "name": "menger"}], [],
        [{"type": "param", "name": "denoise_radius", "value": 2},
         {"type": "look", "dx": 8, "dy": 0}],
    ]
    kinds = set()
    for events in script:
        for ev in events:
            viewer.handle_event(ev)
            kinds.add(ev["type"])
            if ev["type"] == "scene":
                # the viewers keep the camera on a swap, and chr_knight's
                # pose lies inside menger's solid: every depth 0, so
                # log|depth| is -inf and the denoised frame NaN in both
                # versions.  Fly to menger's own pose instead.
                viewer.ctl.frame(
                    camera_paths.static(scenes[ev["name"]])(0.0))
        viewer.render_once()
        # the same frame from the plain loop: the viewer's camera and
        # parameters, its resets, resizes and scene swaps
        for ev in events:
            if ev["type"] == "reset":
                plain.reset_accumulation()
            elif ev["type"] == "size":
                plain.resize(ev["height"], ev["width"])
            elif ev["type"] == "scene":
                plain.set_scene(scenes[ev["name"]])
        r = viewer.renderer
        plain.render_params, plain.temporal_params = (r.render_params,
                                                      r.temporal_params)
        plain.denoise_params = r.denoise_params
        plain.denoise_radius = r.denoise_radius
        out = eager_render(plain, viewer.ctl.camera, **stages)
        img, rays = published[-1]
        want = out["image"].cpu().numpy()
        assert img.shape == want.shape and np.array_equal(img, want), (
            len(published), img.shape, want.shape)
        assert rays == int(out["rays"].sum()), (rays, out["rays"])
    sizes = sorted({img.shape[:2] for img, _ in published})
    assert all(held[k]["frames"] for k in held), held
    say(16, f"render_once through {len(script)} scripted frames "
            f"({', '.join(sorted(kinds))}; sizes {sizes}): every published "
            f"u8 frame and "
            f"its ray count == an eager frame loop over the same "
            f"cameras and parameters; that loop's kernels against their "
            f"plain versions on its inputs: "
            + ", ".join(f"{k} {v['frames']} frames, max err {v['err']:g}"
                        for k, v in held.items()) + f" [{smi}]")

    # (b) a real server and a client reading /stream
    import http.client
    import threading

    kernels = frame_kernels()
    viewer = web.WebViewer(renderer(), scenes=sorted(scenes))
    viewer.ctl.frame(camera_paths.static(scenes["chr_knight"])(0.0))
    server = web.serve(viewer, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    rays_published = [0, 0]
    publish = viewer._publish

    def count(img, rays):
        rays_published[0] += rays
        rays_published[1] += 1
        publish(img, rays)

    viewer._publish = count
    rendered = [0]
    render = viewer.renderer.render

    def counted_render(camera):
        rendered[0] += 1
        return render(camera)

    viewer.renderer.render = counted_render
    for k in kernels.values():
        k.launches = 0
    viewer.start()
    seconds = 3.0
    try:
        viewer.handle_event({"type": "grab", "grabbed": True})
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/stream")
        resp = conn.getresponse()
        stream_type = resp.getheader("Content-Type")
        mimes, frames = set(), []

        def part():
            assert resp.readline() == b"--vtframe\r\n"
            mime = resp.readline().split(b": ")[1].strip().decode()
            n = int(resp.readline().split(b": ")[1])
            assert resp.readline() == b"\r\n"
            data = resp.read(n)
            assert resp.read(2) == b"\r\n" and len(data) == n
            return mime

        for _ in range(5):  # warm: the first frames build nothing now
            part()
        viewer.reset_stage_stats()
        rays_published[:] = [0, 0]
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            viewer.handle_event({"type": "look", "dx": 3.0, "dy": 0.0})
            mimes.add(part())
            frames.append(time.perf_counter())
        elapsed = time.perf_counter() - t0
        state = viewer.state_json()
        stats = viewer.stage_stats()
        conn.close()
    finally:
        viewer.stop()
        server.shutdown()
        server.server_close()
    # the loop thread has ended: launches and frames are final
    launches = {name: k.launches for name, k in kernels.items()}
    loop_frames = rendered[0]
    assert stats["errors"] == 0 and len(frames) > 10, (stats, len(frames))
    assert stream_type == "multipart/x-mixed-replace; boundary=vtframe"
    per_frame = {name: n / loop_frames for name, n in launches.items()}
    assert launches["trace"] == launches["denoise"] == loop_frames, launches
    assert launches["encode"] == loop_frames, launches
    assert (launches["resample"] == launches["stall"]
            == launches["trace_steps"] == 0), launches
    assert 0 < launches["temporal"] < loop_frames, launches
    # at r = 2 a frame that does not reproject runs the still blend
    assert launches["epilogue"] + launches["temporal"] == loop_frames
    mrays_run = rays_published[0] / elapsed / 1e6
    say(16, f"serve() chr_knight {w}x{h} r={radius}: client read "
            f"{len(frames)} frames of /stream in {elapsed:.3f} s = "
            f"{len(frames) / elapsed:.1f} fps while posting look events; "
            f"{stream_type}, frames {sorted(mimes)}; published "
            f"{rays_published[1]} frames, exact {mrays_run:.2f} Mray/s over "
            f"the run (state_json, last 0.25 s window: fps {state['fps']}, "
            f"{state['mrays_per_s']} Mray/s; H*W*fps would say "
            f"{w * h * state['fps'] / 1e6:.2f}); stage_stats {stats}; "
            f"launches {launches} over the loop's {loop_frames} frames "
            f"(per frame {per_frame}) [{smi}]")

    # (c) the interactive benchmark's rows
    rc, rows = run_captured(16, ibench.main, ["--seconds", "3"])
    assert rc == 0 and [r["mode"] for r in rows] == ["web", "web", "tui",
                                                      "wall"], rows
    assert all(r["device"] == smi and r["fps"] > 0 for r in rows), rows
    return per_frame, {k: v["err"] for k, v in held.items()}


def hold_stages():
    """Frame stages (``render_frame``'s keywords) that launch each frame
    kernel and hold it against its plain version on the same inputs,
    with the bars of phases 3, 5, 6 and 19 and ``drive_path``.  The
    stages return the kernel's result.  Returns them, and the frames held
    and the largest error of each kernel, filled in as they run."""
    from voxtracer_torch.ops import denoise, epilogue, temporal, trace

    held = {k: {"frames": 0, "err": 0.0}
            for k in ("trace", "temporal", "denoise", "epilogue", "encode")}

    def note(name, err):
        held[name]["frames"] += 1
        held[name]["err"] = max(held[name]["err"], err)

    def trace_stage(tables, params, noise, frame, h, w):
        args = (tables, params, noise, frame, h, w)
        g = trace.render_sample_cuda(*args)
        p = trace.render_sample_plain(*args)
        cerr = (g["color"] - p["color"]).abs().amax(0)
        assert torch.equal(g["node"], p["node"])
        assert torch.equal(g["depth"], p["depth"])
        assert int((cerr > 1e-3).sum()) <= 0.005 * w * h
        assert torch.equal(g["rays"][:3], p["rays"][:3])
        assert torch.equal(g["steps"][:3], p["steps"][:3])
        note("trace", float(cerr.max()))
        return g

    def temporal_stage(*args):
        kc, kb = temporal.temporal_blend_reproject_cuda(*args)
        pc, pb = temporal.temporal_blend_reproject_plain(*args)
        err = float((kc - pc).abs().max())
        assert torch.equal(kb, pb) and err <= 1e-6, err
        note("temporal", err)
        return kc, kb

    def denoise_stage(*args):
        if args[-1] == 0:  # the modulate alone: no kernel
            return denoise.denoise(*args)
        k, p, n_far, _ = compare_denoise(args)
        assert n_far == 0 and bool(torch.isfinite(p).all()), n_far
        note("denoise", float((k - p).abs().max()))
        return k

    def held_outputs(name, got, want):
        """The kernel's outputs against the plain version's: float32
        bit-equal, u8 equal (``render()`` passes no ``dest``)."""
        pairs = [(a, b) for a, b in zip(got, want)
                 if a is not None and b is not None]
        assert sum(n_differ(a, b) for a, b in pairs) == 0, name
        note(name, float(max((u8_max_diff(a, b) for a, b in pairs
                              if a.dtype == torch.uint8), default=0)))
        return got

    def still_stage(*args, in_place=False):
        assert not in_place  # render() blends out of place
        return held_outputs("epilogue", epilogue.still_epilogue_cuda(*args),
                            epilogue.still_epilogue_plain(*args))

    def encode_stage(*args):
        return held_outputs("encode", epilogue.encode_cuda(*args),
                            epilogue.encode_plain(*args))

    return dict(trace=trace_stage, temporal=temporal_stage,
                denoise=denoise_stage, still_epilogue=still_stage,
                encode=encode_stage), held


def phase_reload(smi):
    """Phase 17: rebuild from a temporary copy of csrc/, then a broken
    source that keeps the last good library."""
    import shutil

    from voxtracer_torch.app import camera_paths
    from voxtracer_torch.engine.pipeline import Renderer
    from voxtracer_torch.engine.reload import KernelWatcher, renderer_hook
    from voxtracer_torch.engine.scene import load_scene
    from voxtracer_torch.ops import _build

    scene = load_scene("menger")
    cam = camera_paths.static(scene)(0.0)
    cams = [cam, cam.pitched(1.0), cam.pitched(2.0)]

    def frames(r):
        """A fresh loop of three frames and a replayed three-frame
        sequence from the same start (state and frame number), as u8
        numpy."""
        r.reset_accumulation()
        r.frame_number = 0
        loop = [r.render(c)["image"].cpu().numpy() for c in cams]
        r.reset_accumulation()
        r.frame_number = 0
        seq = r.render_sequence(cams).cpu().numpy()
        return np.stack(loop), seq

    r = Renderer(scene=scene, height=180, width=320, device="cuda",
                 denoise_radius=2, lean=True)
    base_loop, base_seq = frames(r)
    assert np.array_equal(base_loop, base_seq)
    first = _build.load()._name
    saved = _build.CSRC_DIR, _build.BUILD_DIR
    tmp = tempfile.mkdtemp(prefix="voxreload_")
    try:
        _build.CSRC_DIR = os.path.join(tmp, "csrc")
        _build.BUILD_DIR = os.path.join(tmp, "build")
        shutil.copytree(saved[0], _build.CSRC_DIR)
        watcher = KernelWatcher(on_reload=renderer_hook(r), debounce=0.0)
        assert not watcher.poll()

        def touch(name, text):
            path = os.path.join(_build.CSRC_DIR, name)
            with open(path, "a") as f:
                f.write(text)
            later = time.time() + 5
            os.utime(path, (later, later))

        touch("reproject.cu", "\n// hot-reload check\n")
        assert r._runner is not None
        t0 = time.perf_counter()
        assert watcher.poll()
        rebuild_s = time.perf_counter() - t0
        second = _build.load()._name
        assert second != first and r._runner is None and r._plan is None, (
            first, second)
        loop, seq = frames(r)
        assert np.array_equal(loop, base_loop) and np.array_equal(seq, base_seq)

        touch("trace.cu", "\nthis is not C++;\n")
        t0 = time.perf_counter()
        assert not watcher.poll()
        failed_s = time.perf_counter() - t0
        assert _build.load()._name == second
        loop, seq = frames(r)
        assert np.array_equal(loop, base_loop) and np.array_equal(seq, base_seq)
    finally:
        _build.CSRC_DIR, _build.BUILD_DIR = saved
        _build.load.cache_clear()
        shutil.rmtree(tmp, ignore_errors=True)
    assert _build.load()._name == first
    say(17, f"hot-reload from a copy of csrc/: comment appended to "
            f"reproject.cu -> rebuilt in {rebuild_s:.2f} s, new library "
            f"{os.path.basename(second)}, frame plan and sequence graphs "
            f"dropped, loop and "
            f"replayed frames == those of {os.path.basename(first)}; broken "
            f"trace.cu -> poll() False in {failed_s:.2f} s, the last good "
            f"library still loaded, next frames equal again [{smi}]")


def phase_whitted(smi):
    """Phase 18: the legacy Whitted mode through the CLI on the card at
    1280x720, then the card against the CPU at 160x90."""
    from voxtracer_torch.app import camera_paths, cli
    from voxtracer_torch.engine.scene import load_scene, load_voxels
    from voxtracer_torch.ops import whitted

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "whitted.png")
        t0 = time.perf_counter()
        rc, _ = run_captured(18, cli.main, [
            "--legacy-whitted", "--scene", "menger", "--size", "1280x720",
            "-o", out])
        seconds = time.perf_counter() - t0
        assert rc == 0 and os.path.getsize(out) > 10_000
    voxels = load_voxels("menger")
    cam = camera_paths.static(load_scene("menger"))(0.0)
    t0 = time.perf_counter()
    card = whitted.render_scene(voxels, cam, 160, 90, device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    host = whitted.render_scene(voxels, cam, 160, 90, device="cpu")
    err = (card.cpu() - host).abs()
    n_diff = int((err > 0).sum())
    # the bar of the port's comparison with the JAX package: 1e-5
    hit = float((host != whitted_sky(cam, 160, 90)).any(-1).float().mean())
    say(18, f"legacy whitted menger 1280x720 through cli.main on the card: "
            f"{seconds:.2f} s incl. the octree build and the PNG; 160x90 "
            f"card {card_s:.3f} s vs cpu: max abs err {float(err.max()):g} "
            f"(bar 1e-5), values differing {n_diff}, hit fraction "
            f"{hit:.3f} [{smi}]")
    assert float(err.max()) <= 1e-5 and hit > 0.05


def whitted_sky(cam, w, h):
    """The Whitted image of an empty scene (every pixel abs(dir))."""
    from voxtracer_torch.ops import whitted
    from voxtracer_torch.scene import VoxelList

    empty = VoxelList(pos=np.zeros((0, 3), np.int16),
                      mrgb=np.zeros((0, 4), np.uint8))
    return whitted.render_scene(empty, cam, w, h, device="cpu")


def mesh_path(scene_name, path_name, w, h):
    """The cameras of a path: frame i at ``path(i / 30)``; config 2's
    still camera is the bench camera."""
    from voxtracer_torch.app import camera_paths
    from voxtracer_torch.engine.camera import Camera
    from voxtracer_torch.engine.scene import load_scene

    scene = load_scene(scene_name)
    if path_name == "bench":
        cam = Camera(position=np.array(BENCH_POS),
                     direction=np.array(BENCH_DIR))
        return scene, lambda i: cam.rows(w, h)
    along = camera_paths.PATHS[path_name](scene)
    return scene, lambda i: along(i / 30.0).rows(w, h)


def mesh_case(label, scene_name, path_name, w, h, radius, devices, layout,
              smi, timed):
    """Phase 20, one case: ``MESH_FRAMES`` frames of the slab path
    (``voxtracer_torch.parallel``) on ``devices`` against the one-device
    ``render_frame`` loop from the same state: image, node, depth,
    linear and the final state bit-equal, every kernel launched once a
    slab and stage (the counters zeroed just before the slab frames and
    read just after).  Where ``timed``, ms/frame of both in turns
    (one-device, slabs, slabs, one-device) over bursts continuing along
    the path, and the row blocks the slab path copies a frame (windows,
    history, resort; a slab's own rows included) and how many of them
    crossed devices.  Returns the slab frames' launch counts."""
    from voxtracer_torch.engine.params import (
        DenoiseParams,
        RenderParams,
        TemporalParams,
    )
    from voxtracer_torch.engine.pipeline import (
        STATE_PLANES,
        camera_moved,
        init_state,
        render_frame,
    )
    from voxtracer_torch.engine.scene import SceneTables
    from voxtracer_torch.ops.noise import blue_noise_buffer
    from voxtracer_torch.parallel import (
        gather_state,
        make_mesh,
        scene_device_args,
        sharded_render_frame,
    )

    scene, cam_at = mesh_path(scene_name, path_name, w, h)
    mesh = make_mesh(devices)
    n = len(mesh)
    params = (RenderParams(), TemporalParams(), DenoiseParams())
    home = mesh[0]
    tables = SceneTables(scene, home)
    noise = torch.from_numpy(blue_noise_buffer()).to(home)
    fn, place = sharded_render_frame(mesh, height=h, width=w, radius=radius,
                                     layout=layout)
    m_tables, m_noise = scene_device_args(scene, mesh)
    one = init_state(h, w, home)
    slabs = place(one)
    kernels = frame_kernels()
    frame = 0
    moving = 0

    def one_frame(state, lean):
        return render_frame(state, tables, noise, cam_at(frame), *params,
                            frame + 1, h, w, radius=radius, lean=lean)

    def slab_frame(state, lean):
        return fn(state, m_tables, m_noise, cam_at(frame), *params,
                  frame + 1, lean=lean)

    def same(a, b):
        return all(torch.equal(x.to(home), y.to(home)) for x, y in zip(a, b))

    counts = {name: 0 for name in kernels}
    for _ in range(MESH_FRAMES):
        moving += bool(one["history_valid"]
                       and camera_moved(one, cam_at(frame)))
        one, want = one_frame(one, False)
        for k in kernels.values():
            k.launches = 0
        slabs, got = slab_frame(slabs, False)
        for name, k in kernels.items():
            counts[name] += k.launches
        frame += 1
        assert set(got) == set(want), (set(got), set(want))
        assert same([got[k] for k in want], [want[k] for k in want]), [
            k for k in want if not torch.equal(got[k].to(home), want[k])]
    whole = gather_state(slabs, home)
    assert same([whole[k] for k in STATE_PLANES],
                [one[k] for k in STATE_PLANES])
    assert np.array_equal(whole["old_cam"], one["old_cam"])
    frames = MESH_FRAMES
    expect = {"trace": n * frames, "temporal": n * moving,
              "denoise": n * frames if radius else 0, "resample": 0,
              "stall": 0, "epilogue": n * (frames - moving),
              "encode": n * (frames if radius else moving), "trace_steps": 0}
    assert counts == expect, (counts, expect)
    img = want["image"].float()
    assert float(img.std()) > 1.0
    say(20, f"{label} {w}x{h} {path_name} r={radius}, {n} {layout} slabs on "
            f"{sorted({str(d) for d in mesh})}: {frames} frames ({moving} "
            f"moving with history) == the one-device frames (image, node, "
            f"depth, linear, trace colour, normal, albedo, rays, state); "
            f"launches {counts} = slabs x frames of each stage")
    if not timed:
        return counts
    ms = {"one device": [], "slabs": []}

    def burst(mode):
        nonlocal one, slabs, frame
        for _ in range(MESH_BURST):
            if mode == "slabs":
                slabs, _ = slab_frame(slabs, True)
            else:
                one, _ = one_frame(one, True)
            frame += 1

    for mode in ("one device", "slabs", "slabs", "one device"):
        burst(mode)  # warm: the frames before the timed ones
        torch.cuda.synchronize()
        if mode == "slabs":
            fn.count.reset()
        ms[mode].append(cuda_time(lambda: burst(mode), 1) / MESH_BURST)
    per = MESH_BURST
    say(20, f"{label}: ms/frame in turns (one device, slabs, slabs, one "
            f"device), bursts of {MESH_BURST} after {MESH_BURST} warm "
            f"frames: one device "
            + ", ".join(f"{t:.4f}" for t in ms["one device"]) + "; slabs "
            + ", ".join(f"{t:.4f}" for t in ms["slabs"])
            + f"; row blocks copied a frame (windows, history, resort; own "
            f"rows included) {fn.count.copies / per:g}, "
            f"{fn.count.bytes / per / 2**20:.3f} MiB, of them "
            f"{fn.count.peer / per:g} device-to-device [{smi}]")
    return counts


def phase_mesh(smi):
    """Phase 20: the row-slab mesh (``voxtracer_torch.parallel``) on
    ``["cuda:0"] * n``: configs 2, 3 and 4 at full size, config 3 also at
    n = 3 (uneven slabs), config 4 also cyclic (1080 rows: no multiple of
    4 bands of 16), a ragged 333x187 at n = 8 r = 2 and a 64-row frame at
    n = 16 r = 8 (a halo taller than a slab); each against the
    one-device frames.  On a host with more than one card, the same on
    distinct devices.  Returns each case's launch counts."""
    count = torch.cuda.device_count()
    one_card = ["cuda:0"]
    say(20, f"CUDA devices: {count}")
    cases = {
        "config 2": ("config 2: menger", "menger", "bench", 1280, 720, 0, 4,
                     "contiguous", True),
        "config 3": ("config 3: chr_knight", "chr_knight", "orbit", 1280, 720,
                     0, 4, "contiguous", True),
        "config 3 n=3": ("config 3: chr_knight", "chr_knight", "orbit", 1280,
                         720, 0, 3, "contiguous", True),
        "config 4": ("config 4: monu9", "monu9", "dolly", 1920, 1080, 2, 4,
                     "contiguous", True),
        "config 4 cyclic": ("config 4: monu9", "monu9", "dolly", 1920, 1080,
                            2, 4, "cyclic", True),
        "ragged": ("ragged: chr_knight", "chr_knight", "orbit", 333, 187, 2,
                   8, "contiguous", False),
        "tall halo": ("tall halo: chr_knight", "chr_knight", "orbit", 128, 64,
                      8, 16, "contiguous", False),
    }
    launches = {}
    for key, (label, scene, path, w, h, r, n, layout, timed) in cases.items():
        launches[key] = mesh_case(label, scene, path, w, h, r, one_card * n,
                                  layout, smi, timed)
    if count > 1:
        devices = [f"cuda:{i}" for i in range(count)]
        for key, (label, scene, path, w, h, r, _, layout, _) in (
                ("config 3 distinct", cases["config 3"]),
                ("config 4 cyclic distinct", cases["config 4 cyclic"]),
                ("ragged distinct", cases["ragged"])):
            launches[key] = mesh_case(label, scene, path, w, h, r, devices,
                                      layout, smi, key != "ragged distinct")
    else:
        say(20, "one card: the distinct-device cases did not run")
    return launches


def zero_counts(kernels):
    for k in kernels.values():
        k.launches = 0


def read_counts(kernels):
    return {name: k.launches for name, k in kernels.items()}


def compact(row):
    """A report row for printing: floats to 6 decimals."""
    def f(v):
        if isinstance(v, float):
            return round(v, 6)
        if isinstance(v, list):
            return [f(x) for x in v]
        return v
    return json.dumps({k: f(v) for k, v in row.items()})


def phase_slabs(smi):
    """Phase 21: the slab probe (``app/slabprobe.py``) on menger 1280x720
    and castle 3840x2160, 4 and 8 devices, k in {1, 2, 3} contiguous
    slabs a device and the cyclic layout: each slab's trace bit-equal to
    the one-launch frame's rows (the probe raises where not), its device
    ms from CUDA-graph replays, the skew.  Returns the path's launches."""
    from voxtracer_torch.app import slabprobe
    from voxtracer_torch.engine.scene import load_scene

    kernels = frame_kernels()
    zero_counts(kernels)
    t0 = time.perf_counter()
    for name, w, h in SLAB_CASES:
        scene = load_scene(name)
        full_ms = None
        for n in (4, 8):
            for cyclic in (False, True):
                rows = slabprobe.probe(
                    scene, w, h, n, [1, 2, 3], torch.device("cuda"),
                    reps=SLAB_REPS, chain=SLAB_CHAIN, cyclic=cyclic,
                    full_ms=full_ms)
                full_ms = rows[0]["full_frame_ms"]
                for r in rows[1:]:
                    assert r["exact"] and all(
                        v > 0 for v in r.get("slab_ms", r["chip_ms"])), r
                    if cyclic:
                        assert r["pad_waste"] == 0.0 and r["h_pad"] == h, r
                    say(21, f"{name} {w}x{h} ndev {n}, one-launch frame "
                            f"{full_ms:.6f} ms: {compact(r)} [{smi}]")
    launches = read_counts(kernels)
    say(21, f"slab probe: {time.perf_counter() - t0:.1f} s, launches "
            f"{launches}")
    assert launches["trace"] > 0 and sum(launches.values()) == launches[
        "trace"], launches
    return launches


def phase_scale(smi):
    """Phase 22: the scale probe (``app/scaleprobe.py``): the synthetic
    shell at ``SCALE_DIMS``, its fine table past the L2; build seconds,
    table bytes, ms/frame of ``Renderer(lean=True)``, the trace alone and
    its share of its bound, and the plain trace's node agreement, exactly
    1.0.  Then menger at the same size with the bench camera, for the
    share of bound of tables inside the L2.  Returns the path's launches
    and the probe's figures."""
    from voxtracer_torch.app import scaleprobe
    from voxtracer_torch.engine.camera import Camera
    from voxtracer_torch.engine.params import RenderParams, pack_trace_params
    from voxtracer_torch.engine.scene import TABLES, SceneTables, load_scene
    from voxtracer_torch.ops.noise import blue_noise_buffer

    kernels = frame_kernels()
    zero_counts(kernels)
    res = scaleprobe.probe(SCALE_DIMS, 640, 360, 4, torch.device("cuda"),
                           plain=True, say=lambda m: say(22, f"{m} [{smi}]"))
    launches = read_counts(kernels)
    fine = res["table_bytes"]["packed_idx"]
    say(22, f"shell {SCALE_DIMS}^3: fine table {fine} bytes = "
            f"{fine / res['l2_bytes']:.3f} x the L2 ({res['l2_bytes']} "
            f"bytes), all tables {sum(res['table_bytes'].values())}; launches "
            f"{launches}")
    assert res["device"] == smi and fine > res["l2_bytes"], res
    assert res["node_agreement"] == 1.0 and res["disagreements"] == 0, res
    assert launches["trace"] > 0 and launches["epilogue"] > 0, launches
    tables = SceneTables(load_scene("menger"), "cuda")
    nbytes = sum(4 * getattr(tables, t).numel() for t in TABLES)
    cam = Camera(position=np.array(BENCH_POS), direction=np.array(BENCH_DIR))
    r, _ = scaleprobe.trace_alone(
        tables, pack_trace_params(cam.rows(640, 360), RenderParams()),
        torch.from_numpy(blue_noise_buffer()).cuda(), 360, 640)
    say(22, f"beside it, menger 640x360 with the bench camera (tables "
            f"{nbytes} bytes): trace {r['trace_ms']:.4f} ms, bound "
            f"{r['trace_bound_ms']:.4f} ms ({r['trace_bound_by']}), share "
            f"{r['trace_share']:.4f}; the shell: {res['trace_ms']:.4f} ms, "
            f"bound {res['trace_bound_ms']:.4f} ms ({res['trace_bound_by']}), "
            f"share {res['trace_share']:.4f} [{smi}]")
    return launches, res


def compare_steps_map(label, tables, cam, w, h, noise):
    """The steps-map instance against the shipped instance (every output
    and counter equal) and against the plain version's map (equal);
    each phase's map sums to its ``steps``."""
    from voxtracer_torch.engine.params import RenderParams, pack_trace_params
    from voxtracer_torch.ops import trace

    params = pack_trace_params(cam.rows(w, h), RenderParams())
    args = (tables, params, noise, 1, h, w)
    k = trace.render_sample_steps_cuda(*args)
    s = trace.render_sample_cuda(*args)
    p = trace.render_sample_plain(*args, steps_map=True)
    torch.cuda.synchronize()
    differ = [key for key in ("color", "normal", "depth", "albedo", "node",
                              "rays", "steps", "slots")
              if not torch.equal(k[key], s[key])]
    sums = k["steps_map"].sum(dim=(1, 2)).long()
    per_phase = (k["steps_map"] != p["steps_map"]).sum(dim=(1, 2)).tolist()
    err = int((k["steps_map"] - p["steps_map"]).abs().max())
    say(23, f"steps map {label} {w}x{h}: outputs differing from the shipped "
            f"instance's {differ}; map sums {sums.tolist()} == steps "
            f"{k['steps'].tolist()}; pixels differing from the plain map per "
            f"phase {per_phase}, max |diff| {err}")
    assert not differ and torch.equal(sums, k["steps"]), differ
    assert torch.equal(k["steps_map"], p["steps_map"]), per_phase


def full_size_against_plain(name, args, out):
    """A decay case's steps-map kernel output against the plain
    version's on the same inputs: the steps map, node, depth, normal,
    albedo and counters equal, the colour at phase 4's bar (over 1e-3 at
    no more than 0.5% of the pixels; ``expf``/``logf``/``cosf``/``sinf``
    round differently on the card).  Returns (the plain call's ms, the
    largest |kernel - plain| of the maps, of the colour)."""
    from voxtracer_torch.ops import trace

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = trace.render_sample_plain(*args, steps_map=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    h, w = args[4], args[5]
    per_phase = (out["steps_map"] != p["steps_map"]).sum(dim=(1, 2)).tolist()
    map_err = int((out["steps_map"] - p["steps_map"]).abs().max())
    cerr = (out["color"] - p["color"]).abs().amax(dim=0)
    color_err = float(cerr.max())
    beyond = int((cerr > 1e-3).sum())
    differ = [key for key in ("node", "depth", "normal", "albedo", "rays",
                              "steps")
              if not torch.equal(out[key], p[key])]
    say(23, f"{name} {w}x{h} against the plain version ({plain_ms:.1f} ms): "
            f"steps-map pixels differing per phase {per_phase}, max |diff| "
            f"{map_err}; outputs differing {differ}; colour max |diff| "
            f"{color_err:g}, px beyond 1e-3 {beyond}")
    assert torch.equal(out["steps_map"], p["steps_map"]), per_phase
    assert not differ and beyond <= 0.005 * w * h, (differ, beyond)
    return plain_ms, map_err, color_err


def phase_decay(smi):
    """Phase 23: the trace kernel's steps-map instance against the
    shipped instance and the plain version (single voxel, menger 320x180
    with the bench camera, menger 333x187), then the live-decay curve of
    each phase for menger 720p, monu9 1080p (dolly t=0) and castle 4K
    (``tracebench.cases``, blue noise, frame 1), each of these kernel
    outputs then held against the plain version's on the same inputs,
    then the shipped instance, the shipped instance with the map's
    zeroing and the steps-map instance timed at menger 720p in turns,
    and the shipped instances' registers and spills.  Returns the path's
    launches and the steps instance's entry for the kernels line, its
    error from the three full-size cases."""
    from voxtracer_torch.engine.camera import Camera
    from voxtracer_torch.engine.params import RenderParams, pack_trace_params
    from voxtracer_torch.engine.scene import SceneTables, load_scene
    from voxtracer_torch.ops import _build, trace
    from voxtracer_torch.ops.noise import blue_noise_buffer
    from voxtracer_torch.app.renderbench import graph_ms

    kernels = frame_kernels()
    noise = torch.from_numpy(blue_noise_buffer()).cuda()
    bench_cam = Camera(position=np.array(BENCH_POS),
                       direction=np.array(BENCH_DIR))
    menger = SceneTables(load_scene("menger"), "cuda")
    compare_steps_map(
        "single voxel", SceneTables(single_voxel_scene(), "cuda"),
        Camera(position=np.array([0.3, 0.2, -1.5])), 32, 32, noise)
    compare_steps_map("menger", menger, bench_cam, 320, 180, noise)
    compare_steps_map("menger", menger, bench_cam, 333, 187, noise)
    zero_counts(kernels)
    runs = []
    for name, scene, cam, w, h in tracebench.cases():
        tables = menger if name == "menger" else SceneTables(scene, "cuda")
        args = (tables, pack_trace_params(cam.rows(w, h), RenderParams()),
                noise, 1, h, w)
        out = trace.render_sample_steps(*args)
        runs.append((name, args, out))
        curve = trace.warp_decay(out["steps_map"])
        trips = sum(r["trips"] for r in curve)
        slots = int(out["slots"][0])
        say(23, f"live decay, {name} {w}x{h}: " + "; ".join(
            f"{ph} trips {r['trips']} " + " ".join(
                f"{c} {r[c]:.4f}" for c in trace.DECAY_COLUMNS)
            for ph, r in zip(("b0", "s0", "b1", "s1", "b2", "s2"), curve))
            + f"; warp trips {trips}, kernel slots {slots} (a warp that "
              f"reaches its count in pieces adds a slot each) [{smi}]")
        for r in curve:
            vals = [r[c] for c in trace.DECAY_COLUMNS]
            assert vals == sorted(vals) and 0 <= vals[0] and vals[-1] <= 1, r
        assert 0 < trips <= slots, (trips, slots)
    launches = read_counts(kernels)
    assert launches["trace_steps"] == 3 and sum(launches.values()) == 3, (
        launches)

    # the decay path's kernel outputs against the plain version's
    checked = {name: full_size_against_plain(name, args, out)
               for name, args, out in runs}
    plain_ms = checked["menger"][0]
    err = max(max(map_err, color_err) for _, map_err, color_err in
              checked.values())

    # the shipped instance, the shipped instance and a zeroed map of the
    # steps instance's size (the memset its wrapper adds), and the
    # steps-map instance at menger 720p, in turns, on the device alone
    # (CUDA-graph replays)
    name, args, out = runs[0]
    assert name == "menger" and args[4:] == (HEIGHT, WIDTH)
    variants = {
        "shipped": lambda: trace.render_sample_cuda(*args),
        "zeroed": lambda: (trace.render_sample_cuda(*args), torch.zeros(
            (trace.N_PHASES, HEIGHT, WIDTH), dtype=torch.int32,
            device="cuda")),
        "steps": lambda: trace.render_sample_steps_cuda(*args),
    }
    times = {k: [] for k in variants}
    for which in ("shipped", "zeroed", "steps", "steps", "zeroed",
                  "shipped"):
        times[which].append(graph_ms(variants[which], 20, 5))
    bound_ms, bound_by = tracebench.trace_bound(out, HEIGHT, WIDTH,
                                                noise.shape[0])
    ms = statistics.median(times["steps"])
    listed = {k: ", ".join(f"{t:.4f}" for t in v) for k, v in times.items()}
    say(23, f"menger {WIDTH}x{HEIGHT} (bench camera), in turns: shipped "
            f"instance {listed['shipped']} ms, shipped instance and the "
            f"map's memset {listed['zeroed']} ms, steps-map instance (its "
            f"memset included) {listed['steps']} ms; plain version with the "
            f"map {plain_ms:.1f} ms; bound {bound_ms:.4f} ms ({bound_by}) "
            f"[{smi}]")

    log = _build.build_log()
    inst = ptxas_entries(log, r"trace_kernelILb(\dELb\d)E")
    say(23, "trace instances (registers, spill bytes, static shared bytes): "
            + ", ".join(f"{k}: {v}" for k, v in sorted(inst.items()))
            + f"; phase 1's by-value instance {trace.kernel_info()}")
    # the shipped instances as they were before the steps-map instance:
    # 80 registers, no spills (the steps-map instance, an instrument, is
    # reported, not held to it)
    assert inst["0ELb0"][:2] == (80, 0) and inst["1ELb0"][:2] == (80, 0), inst
    assert trace.kernel_info()["registers"] == 80
    entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "shipped_ms": statistics.median(times["shipped"]),
             "shipped_and_memset_ms": statistics.median(times["zeroed"]),
             "registers": inst["0ELb1"][0], "spill_bytes": inst["0ELb1"][1]}
    return launches, entry


def phase_bake(smi):
    """Phase 24: the blue-noise baker (``ops/bluenoise.py``, plain torch)
    on the card: ``generate(8, 128)``, its seconds, and the JAX test's
    properties on every slice.  Returns the path's launches (none of the
    repo's kernels: the baker is torch ops)."""
    from voxtracer_torch.ops import bluenoise

    kernels = frame_kernels()
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    noise = bluenoise.generate(8, 128, seed=0, device="cuda")
    seconds = time.perf_counter() - t0
    launches = read_counts(kernels)
    n = 128 * 128
    freq = np.fft.fftfreq(128)
    fy, fx = np.meshgrid(freq, freq, indexing="ij")
    rad = np.sqrt(fy**2 + fx**2)
    ratios = []
    for s in range(noise.shape[0]):
        np.testing.assert_allclose(np.sort(noise[s].reshape(-1)),
                                   (np.arange(n) + 0.5) / n, atol=1e-6)
        pat = (noise[s] < 0.25).astype(np.float64)
        pat -= pat.mean()
        spec = np.abs(np.fft.fft2(pat)) ** 2
        ratios.append(spec[rad > 0.3].mean()
                      / spec[(rad < 0.15) & (rad > 0)].mean())
    say(24, f"generate(8, 128) on the card: {seconds:.2f} s; every slice a "
            f"permutation of (rank + 0.5) / N; high / low spectrum "
            f"{', '.join(f'{r:.1f}' for r in ratios)} (the JAX test's bar: "
            f"> 2); launches {launches} [{smi}]")
    assert noise.shape == (8, 128, 128) and min(ratios) > 2.0, ratios
    assert sum(launches.values()) == 0, launches
    return launches


def phase_tracing(smi):
    """Phase 25: the spans' and counters' card tests, the spans' cost
    on and off, and their device side in a profiled loop."""
    from torch.autograd import DeviceType

    from voxtracer_torch.app import profile
    from voxtracer_torch.engine.camera import Camera
    from voxtracer_torch.engine.pipeline import Renderer
    from voxtracer_torch.engine.scene import load_scene
    from voxtracer_torch.utils import timing
    from voxtracer_torch.utils.fetch import LookaheadFetch

    # --noconftest: tests/conftest.py imports JAX, which this card's
    # host need not have
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "--noconftest", "-m", "cuda",
         "-p", "no:cacheprovider", "tests/test_torch_tracing.py",
         "tests/test_torch_fetch_stream.py"],
        capture_output=True, text=True, cwd=HERE)
    summary = tests.stdout.strip().splitlines()[-1:]
    assert tests.returncode == 0, tests.stdout[-4000:] + tests.stderr[-2000:]

    def per_span(n):
        t0 = time.perf_counter()
        for _ in range(n):
            with timing.span("vt.render.pack"):
                pass
        return (time.perf_counter() - t0) / n

    off_ns = min(per_span(200_000) for _ in range(5)) * 1e9
    with torch.autograd.profiler.profile(use_kineto=True):
        on_us = min(per_span(2_000) for _ in range(3)) * 1e6

    r = Renderer(scene=load_scene("menger"), height=180, width=320,
                 device="cuda", denoise_radius=2, lean=True)
    fetch = LookaheadFetch()
    poses = [Camera(position=np.array([36.0 + i, 34.0, -5.0]),
                    direction=np.array([-16.0, -14.0, 25.0]))
             for i in range(6)]
    fetch.push(r.render(poses[0]))
    torch.cuda.synchronize()
    with torch.autograd.profiler.profile(use_device="cuda",
                                         use_kineto=True) as prof:
        for cam in poses[1:]:
            fetch.push(r.render(cam))
        fetch.flush()
        torch.cuda.synchronize()
    on_host = sum(e.device_type == DeviceType.CPU and e.name.startswith("vt.")
                  for e in prof.function_events)
    on_device = [e for e in prof.function_events
                 if e.device_type == DeviceType.CUDA
                 and e.name.startswith("vt.")]
    unflagged = [e.name for e in on_device
                 if not getattr(e, "is_user_annotation", False)]
    leaked = [e.name for e in profile.device_activities(prof.function_events)
              if e.name.startswith("vt.")]
    say(25, f"tracing tests on the card: {summary}; off path "
            f"{off_ns:.1f} ns a span, {8 * off_ns / 1e3:.3f} us for a "
            f"frame's 8 sites; on path {on_us:.2f} us a span under the "
            f"profiler; {on_host} vt.* events on the host, {len(on_device)} "
            f"on the device ({len(unflagged)} not flagged "
            f"is_user_annotation), {len(leaked)} among app/profile.py's "
            f"device activities [{smi}]")
    assert on_host and not unflagged and not leaked, (unflagged, leaked)


def phase_direct(smi):
    """Phase 26: the direct path against the eager stages on the card,
    bit for bit, and the host's time of each."""
    from voxtracer_torch.app.renderbench import direct_against_eager

    for scene, w, h, radius in (("menger", 1280, 720, 0),
                                ("monu9", 1920, 1080, 2)):
        got = direct_against_eager(scene, w, h, radius)
        fast, eager = got["counts"]["direct"], got["counts"]["eager"]
        launches = [{k: n for k, n in c.items() if k.startswith("launches.")}
                    for c in (fast, eager)]
        say(26, f"direct path {scene} {w}x{h} r={radius}: "
                f"{got['frames']} frames, {got['n_differ']} outputs or "
                f"state planes differ from the eager path's {got['differ']}; "
                f"launches {launches[0]} (eager {launches[1]}), "
                f"frames.direct {fast.get('frames.direct', 0)} / "
                f"{eager.get('frames.direct', 0)}; host us a render() "
                f"direct {got['host_us']['direct']} eager "
                f"{got['host_us']['eager']}; device ms a frame direct "
                f"{got['frame_ms']['direct']} eager {got['frame_ms']['eager']}"
                f" [{smi}]")
        assert got["n_differ"] == 0, got["differ"]
        assert launches[0] == launches[1], launches
        assert fast["frames.direct"] == got["frames"]
        assert "frames.direct" not in eager


def phase_scene_build(smi):
    """Phase 27: the scene tables built on the card against the host
    build, on the bowl, in turns."""
    from voxtracer_torch.engine.pipeline import counters
    from voxtracer_torch.engine.scene import TABLES, SceneTables, load_scene

    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "--noconftest", "-m", "cuda",
         "-p", "no:cacheprovider",
         "tests/test_torch_scene_device_build_cuda.py"],
        capture_output=True, text=True, cwd=HERE)
    summary = tests.stdout.strip().splitlines()[-1:]
    assert tests.returncode == 0, tests.stdout[-4000:] + tests.stderr[-2000:]

    card = torch.device("cuda")
    before = counters()
    scene = load_scene("default")
    load_us = counters()["scene.load_us"] - before["scene.load_us"]

    def host_build():
        t0 = time.perf_counter_ns()
        t = scene.device_tables()
        t1 = time.perf_counter_ns()
        out = {name: torch.from_numpy(np.ascontiguousarray(t[name])).to(card)
               for name in TABLES}
        torch.cuda.synchronize(card)
        return out, (t1 - t0) // 1000, (time.perf_counter_ns() - t1) // 1000

    def card_build():
        start = counters()
        tables = SceneTables(scene, card)
        grown = {k: v - start[k] for k, v in counters().items()}
        assert grown["scene.device_builds"] == 1, grown
        return ({name: getattr(tables, name) for name in TABLES},
                grown["scene.tables_us"], grown["scene.upload_us"])

    first, rows = None, []
    for side in ("host", "card", "card", "host", "host", "card"):
        torch.cuda.synchronize(card)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(card)
        held = torch.cuda.memory_allocated(card)
        tables, tables_us, upload_us = (
            host_build if side == "host" else card_build)()
        peak = torch.cuda.max_memory_allocated(card) - held
        first = first or tables
        same = all(torch.equal(tables[n], first[n]) for n in TABLES)
        rows.append({"side": side, "tables_us": tables_us,
                     "upload_us": upload_us,
                     "scene_build_s": (load_us + tables_us + upload_us) / 1e6,
                     "peak_bytes": peak, "bit_equal": same})
        del tables
    say(27, f"scene build tests on the card: {summary}; the bowl "
            f"{scene.values.shape}: load_us {load_us} once, then in turns "
            f"{json.dumps(rows)} [{smi}]")
    assert all(r["bit_equal"] for r in rows), rows


def check_no_jax_package():
    """The run imported nothing of the JAX package, JAX or Triton."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("voxtracer", "jax", "jaxlib", "triton"))
    say(15, f"modules of the JAX package, JAX or Triton imported: {bad}")
    assert not bad, bad


def main():
    smi = phase_device()
    phase_build()
    phase_golden()
    trace_err = phase_plain()
    main_trace, main_counts = phase_main(smi)
    per_frame = {"config 2": {name: n / (WARMUP + BURSTS * FRAMES)
                              for name, n in main_counts.items()}}
    phase_trace_sizes(smi)
    temporal_err, dolly, poses = phase_temporal(smi)
    denoise_err = phase_denoise(smi, dolly)
    epilogue_entry, encode_cases, epilogue_err = phase_epilogue(smi)
    per_frame["config 4"], launches, entries = drive_path(
        7, "config 4: monu9", "monu9", 1920, 1080, "dolly", 2, WARMUP, BURSTS,
        FRAMES, smi)
    per_frame["config 3"], _, config3 = drive_path(
        8, "config 3: chr_knight", "chr_knight", 1280, 720, "orbit", 0, WARMUP,
        2, 8, smi)
    entries["resample"] = phase_resample(smi, poses)
    phase_temporal_blend(smi, poses)
    launches["stall"], entries["stall"] = phase_stallbench(smi)
    sequence = {
        "config 2": phase_sequence("config 2: menger", "menger", WIDTH,
                                   HEIGHT, "static", 0, True, smi),
        "config 3": phase_sequence("config 3: chr_knight", "chr_knight", 1280,
                                   720, "orbit", 0, False, smi),
        "config 4": phase_sequence("config 4: monu9", "monu9", 1920, 1080,
                                   "dolly", 2, False, smi),
        "mixed": phase_sequence("mixed path: chr_knight", "chr_knight", 320,
                                180, "mixed", 2, False, smi, frames=7,
                                timed=False),
    }
    phase_cli(smi)
    launches["resample"] = phase_harness(smi)["resample"]
    viewer_per_frame, viewer_err = phase_interactive(smi)
    phase_reload(smi)
    phase_whitted(smi)
    mesh = phase_mesh(smi)
    slab_counts = phase_slabs(smi)
    scale_counts, _ = phase_scale(smi)
    decay_counts, entries["trace_steps"] = phase_decay(smi)
    bake_counts = phase_bake(smi)
    phase_tracing(smi)
    phase_direct(smi)
    phase_scene_build(smi)
    check_no_jax_package()
    # The trace's and the still epilogue's launches come from the main
    # path (config 2, phase 4), the trace's times and bound too, the
    # epilogue's from phase 19 at config 2's size; the temporal, denoise
    # and encode kernels' from config 4's frame, the resample kernel's
    # launches from the harness; each error is the largest of every
    # comparison of the kernel with its plain version (u8 values for the
    # epilogue and the encode, whose float32 outputs are bit-equal)
    launches["trace"] = main_counts["trace"]
    launches["epilogue"] = main_counts["epilogue"]
    # the steps-map instance's path is the decay phase's (23)
    launches["trace_steps"] = decay_counts["trace_steps"]
    entries["epilogue"] = epilogue_entry
    entries["encode"]["times_by_case"] = encode_cases
    entries["trace"] = {
        **main_trace, "max_abs_err": max(
            main_trace["max_abs_err"], trace_err,
            entries["trace"]["max_abs_err"])}
    for name, err in (("temporal", temporal_err), ("denoise", denoise_err),
                      ("encode", epilogue_err),
                      *((k, e["max_abs_err"]) for k, e in config3.items()),
                      *viewer_err.items()):
        entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], err)
    for name in entries:
        entries[name]["launches_per_frame"] = {
            config: counts[name] for config, counts in per_frame.items()}
    # this slice's path: the launches read around phase 12's replayed
    # sequences, which run five of the seven kernels and no other
    for name in entries:
        entries[name]["sequence_launches"] = {
            config: counts[name] for config, (counts, _) in sequence.items()}
        total = sum(entries[name]["sequence_launches"].values())
        assert (total > 0) == (name in SEQUENCE_KERNELS), (name, total)
        # phase 16's web viewer loop, chr_knight 640x360 r=2
        entries[name]["viewer_launches_per_frame"] = viewer_per_frame[name]
        # phase 20's slab frames, each case's counts read around them
        entries[name]["mesh_launches"] = {
            case: counts[name] for case, counts in mesh.items()}
        total = sum(entries[name]["mesh_launches"].values())
        assert (total > 0) == (name in SEQUENCE_KERNELS), (name, total)
        # phases 21-24's paths, each read around it
        for key, counts in (("slab_launches", slab_counts),
                            ("scale_launches", scale_counts),
                            ("decay_launches", decay_counts),
                            ("bake_launches", bake_counts)):
            entries[name][key] = counts[name]
    for name in ("trace", "temporal", "denoise", "stall", "epilogue",
                 "encode", "trace_steps"):
        entries[name]["library_ms"] = None  # no one PyTorch call computes it
    sources = {
        "trace": ("voxtracer_torch/csrc/trace.cu",
                  "voxtracer/ops/trace_pallas.py:2301"),
        "temporal": ("voxtracer_torch/csrc/temporal.cu",
                     "voxtracer/ops/temporal_pallas.py:516"),
        "denoise": ("voxtracer_torch/csrc/denoise.cu",
                    "voxtracer/ops/denoise_pallas.py:370"),
        "resample": ("voxtracer_torch/csrc/reproject.cu",
                     "voxtracer/ops/reproject_pallas.py:301"),
        "stall": ("voxtracer_torch/csrc/stallbench.cu",
                  "voxtracer/app/stallbench.py:171"),
        # no pallas_call: the XLA fusion of the frame's tail
        "epilogue": ("voxtracer_torch/csrc/epilogue.cu",
                     "voxtracer/engine/pipeline.py:467-481 (XLA fusion of "
                     "voxtracer/ops/temporal.py:104 and "
                     "voxtracer/ops/denoise_pallas.py:281-283 with the "
                     "encode)"),
        "encode": ("voxtracer_torch/csrc/epilogue.cu",
                   "voxtracer/engine/pipeline.py:552-553 (XLA fusion of "
                   "voxtracer/ops/tonemap.py:37)"),
        # the trace kernel's second instance: each pixel's steps a phase
        "trace_steps": ("voxtracer_torch/csrc/trace.cu",
                        "voxtracer/ops/trace_pallas.py:2301 (its live-decay "
                        "counters, :1322-1393)"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "launches_per_frame", "sequence_launches", "mesh_launches",
            "library_ms")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         **{k: entries[name][k] for k in keys},
         "share": entries[name]["bound_ms"] / entries[name]["ms"],
         **{k: v for k, v in entries[name].items() if k not in keys}}
        for name, (src, rep) in sources.items()
    ]
    assert all(k["launches"] > 0 for k in kernels), kernels
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
