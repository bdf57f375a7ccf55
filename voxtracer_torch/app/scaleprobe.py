"""Scale probe: a synthetic scene whose tables do not fit the card's L2.

Counterpart of :mod:`voxtracer.app.scaleprobe`.  Every shipped scene's
tables are about 1 MB (menger), far inside the H100's 50 MB L2; a dense
noisy shell of ``--dims``^3 (default 480: a fine table of about 147 MB)
makes the trace's table reads miss it, and its table addressing run at
sizes no shipped scene reaches.  Prints the scene's build seconds on the
host, each table's bytes beside the card's L2, the ms/frame of
``Renderer(lean=True)`` at ``--size`` (CUDA events around ``--frames``
frames after 2 warm ones), and the trace kernel alone on the frame's
first sample: its ms on the device alone (CUDA-graph replays, as
``app/slabprobe.py`` times a slab: at 640x360 eager calls time the
wrapper's host work, not the kernel) and its share of its bound
(``app/tracebench.py`` ``trace_bound``: the G-buffer and noise bytes and
the operations, a lower bound whatever part of the tables the rays
read; at the reference camera 4% of the pixels hit, so a count of every
table byte would be no bound).

``--plain`` (the reference's ``--xla``) also renders that sample with the
plain trace on the same device: node agreement with the kernel, which is
bit-equal to its plain version and must read exactly 1.0 (the reference's
0.970 compared two implementations), the disagreements by kind (hit/miss
flips, both-hit cell flips, |depth delta| at flips) and the speed ratio.

Run: python -m voxtracer_torch.app.scaleprobe [--dims 480] [--plain]
         [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..engine.camera import Camera
from ..engine.params import RenderParams, pack_trace_params
from ..engine.pipeline import Renderer
from ..engine.scene import TABLES
from ..ops import trace as trace_op
from ..scene import grid as grid_mod
from ..scene.grid import GridScene
from .bench import _stage_ms, device_label
from .renderbench import graph_ms
from .tracebench import trace_bound


def synthetic_shell(dims: int, seed: int = 3) -> GridScene:
    """A hollow noisy sphere shell of ``dims``^3 extent, ~1% emissive,
    its colours through the leaf quantizer real scenes take: enough
    distinct bricks and occupancy to defeat the brick dedup.  Leaves are
    made only at shell cells (host memory ~ the occupied cells, not
    ``dims``^3 per channel).  Bit-equal to the reference's."""
    rng = np.random.default_rng(seed)
    n = dims
    c = (n - 1) / 2.0
    g = np.arange(n, dtype=np.float32) - c
    d2 = (g[:, None, None] ** 2 + g[None, :, None] ** 2
          + g[None, None, :] ** 2)
    r = n * 0.47
    shell = (d2 < r * r) & (d2 > (r - 6.0) ** 2)
    idx = np.nonzero(shell)
    k = idx[0].size
    cols = rng.integers(40, 255, size=(k, 3), dtype=np.uint32)
    emis = (rng.random(k) < 0.01).astype(np.uint32)
    leaf = (
        np.uint32(1 << 31)
        | (emis << 30)
        | (emis << 24)
        | (cols[:, 0] << 16)
        | (cols[:, 1] << 8)
        | cols[:, 2]
    ).view(np.int32)
    leaf = grid_mod._quantize_leaves(leaf)
    values = np.zeros((n, n, n), dtype=np.int32)
    values[idx] = leaf
    origin = np.array([-int(c)] * 3, dtype=np.int32)
    mips = grid_mod._build_mips(values != 0, 6)
    return GridScene(values=values, origin=origin, mips=mips)


def shell_camera(dims: int) -> Camera:
    """The reference's view of the shell."""
    return Camera(
        position=np.array([dims * 0.75, dims * 0.55, -dims * 0.7]),
        direction=np.array([-0.6, -0.45, 1.0]),
    )


def l2_bytes(device) -> int | None:
    """The card's L2 size in bytes (None off the card)."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).L2_cache_size)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def frame_ms(renderer, cam, frames):
    """ms/frame of ``frames`` ``render()`` calls after 2 warm ones: CUDA
    events on the card, the host clock elsewhere."""
    for _ in range(2):
        renderer.render(cam)
    return _stage_ms(lambda: renderer.render(cam), renderer.device, frames)


def node_agreement(kernel, plain):
    """The share of pixels whose node ids agree, and the disagreements
    by kind: hit/miss flips, both-hit cell flips, |depth delta| at the
    flips (median and max; None without flips)."""
    nk, npl = kernel["node"].cpu().numpy(), plain["node"].cpu().numpy()
    d = nk != npl
    res = {"node_agreement": float((~d).mean()), "disagreements": int(d.sum()),
           "hit_miss_flips": 0, "both_hit_flips": 0,
           "depth_delta_p50": None, "depth_delta_max": None}
    if d.any():
        dd = np.abs(kernel["depth"].cpu().numpy()
                    - plain["depth"].cpu().numpy())[d]
        miss_k = nk[d] == trace_op.MISS_NODE
        miss_p = npl[d] == trace_op.MISS_NODE
        res.update(hit_miss_flips=int((miss_k ^ miss_p).sum()),
                   both_hit_flips=int((~miss_k & ~miss_p).sum()),
                   depth_delta_p50=float(np.median(dd)),
                   depth_delta_max=float(dd.max()))
    return res


def trace_alone(tables, params, noise, height, width, reps=5):
    """The trace of one sample (frame 1) on the tables' device: its ms
    (the mean of ``reps`` replays of a CUDA graph of 20 launches on the
    card; the host clock over ``reps`` calls elsewhere), its bound and
    share of it (None off the card), its counters, its output."""
    args = (tables, params, noise, 1, height, width)
    out = trace_op.render_sample(*args)
    device = tables.device
    if device.type == "cuda":
        ms = graph_ms(lambda: trace_op.render_sample(*args), 20, reps)
    else:
        ms = _stage_ms(lambda: trace_op.render_sample(*args), device, reps)
    bound_ms, bound_by = trace_bound(out, height, width, noise.shape[0])
    # a share of the card's bound only for a time taken on the card
    on_card = device.type == "cuda"
    return {"trace_ms": ms, "trace_bound_ms": bound_ms,
            "trace_bound_by": bound_by,
            "trace_share": bound_ms / ms if on_card else None,
            "rays": out["rays"].tolist(), "steps": out["steps"].tolist(),
            "hit_fraction": float((out["depth"] >= 0).float().mean())}, out


def probe(dims, width, height, frames, device, plain=False, say=print):
    """Builds the shell, renders it and returns the figures :func:`main`
    prints (each line also passed to ``say``)."""
    t0 = time.perf_counter()
    scene = synthetic_shell(dims)
    build_s = time.perf_counter() - t0
    cam = shell_camera(dims)
    r = Renderer(scene=scene, height=height, width=width, device=device,
                 lean=True)
    tables = r.tables
    table_bytes = {name: getattr(tables, name).numel() * 4 for name in TABLES}
    res = {"dims": dims, "width": width, "height": height,
           "build_s": build_s, "table_bytes": table_bytes,
           "table_shapes": {name: list(getattr(tables, name).shape)
                            for name in TABLES},
           "l2_bytes": l2_bytes(r.device), "device": device_label(r.device)}
    say(f"# scene {dims}^3 built in {build_s:.2f} s on the host; tables "
        + ", ".join(f"{k} {tuple(res['table_shapes'][k])} = {v / 1e6:.3f} MB"
                    for k, v in table_bytes.items())
        + f"; L2 {res['l2_bytes']} bytes ({res['device']})")
    res["ms_per_frame"] = frame_ms(r, cam, frames)
    say(f"Renderer(lean=True) on {r.device}: {res['ms_per_frame']:.4f} "
        f"ms/frame at {width}x{height}")

    params = pack_trace_params(cam.rows(width, height), RenderParams())
    args = (tables, params, r.noise, 1, height, width)
    alone, kernel = trace_alone(tables, params, r.noise, height, width)
    res.update(alone)
    say(f"trace alone: {res['trace_ms']:.4f} ms, bound "
        f"{res['trace_bound_ms']:.4f} ms ({res['trace_bound_by']}), share "
        f"{res['trace_share']}; hit fraction "
        f"{res['hit_fraction']:.4f}; rays {res['rays']} steps {res['steps']}")
    if plain:
        _sync(r.device)
        t0 = time.perf_counter()
        ref = trace_op.render_sample_plain(*args)
        _sync(r.device)
        res["plain_s"] = time.perf_counter() - t0
        res.update(node_agreement(kernel, ref))
        res["plain_over_kernel"] = res["plain_s"] * 1e3 / res["trace_ms"]
        say(f"plain trace: {res['plain_s']:.2f} s/sample; node agreement "
            f"{res['node_agreement']:.6f} ({res['disagreements']} px: "
            f"hit/miss flips {res['hit_miss_flips']}, both-hit cell flips "
            f"{res['both_hit_flips']}, |depth delta| at flips p50 "
            f"{res['depth_delta_p50']} max {res['depth_delta_max']}); "
            f"{res['plain_over_kernel']:.0f}x the kernel's time")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0], epilog=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dims", type=int, default=480)
    p.add_argument("--size", default="640x360")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--plain", action="store_true",
                   help="also trace one sample with the plain version on the "
                        "same device: node agreement and speed ratio")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    w, h = (int(v) for v in args.size.lower().split("x"))
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False")
    probe(args.dims, w, h, args.frames, device, args.plain,
          say=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
