"""Per-slab trace work skew of the row-slab mesh, measured on one card.

Counterpart of :mod:`voxtracer.app.slabprobe`.  The mesh
(``voxtracer_torch/parallel/mesh.py``) cuts the image's rows into slabs,
one a device; a frame's trace term runs at its slowest slab, so a
geometry-heavy slab gates the frame while a sky-heavy one idles.  On one
card the slabs run one after another, so each can be timed alone: this
probe times each slab's trace, the call the mesh makes for it
(``ops/trace.py`` ``render_sample(..., row0, row_stride)``, white noise
of seed 7 at frame 1, the static camera), and reports for each k in 1
and ``--interleave``:

* ``slab_ms``: each of the ``n * k`` contiguous slabs' device ms
  (``mesh.slab_bounds``: ``ceil(H / (n k))`` rows, the last one shorter,
  so no k is skipped), with its blocks of 16x16 threads and its waves
  (blocks over 132 SMs x the trace kernel's resident blocks per SM,
  ``ops/trace.py`` ``kernel_info``): a slab of a fraction of a wave
  pays the tail, not its work;
* ``chip_ms``: the slabs dealt round-robin (device c gets slabs c, c + n,
  ...), each device's sum, with ``max_ms``, ``mean_ms`` and their ratio
  ``skew`` (the frame's trace term runs at the max; balance would run at
  the mean);
* ``launch_ovh_ms``: what each launch beyond the one full-frame launch
  costs, ``max((sum(slab_ms) - full_ms) / (n k - 1), 0)`` (the reference
  divides by ``n k``, ``slabprobe.py:200``), and ``fused_max_ms``, the
  max with ``k - 1`` of those taken off each device (one launch a device
  for its k slabs).

``--cyclic`` times the cyclic layout instead, as the mesh runs it
(``SlabFrame``): device c traces its bands c, c + n, ... of 16 rows in
one launch (``row_stride = n``, ``mesh.cyclic_heights``).  No row past
the image is traced, so ``h_pad`` is the height and ``pad_waste`` 0.0
(the reference pads to ``n * block``).

Every slab's G-buffer is checked against the same rows of the
one-launch frame, bit for bit, and the slabs' ray and step counters
against the frame's (``exact``): a slab that traced other rows would
time other work.

Time: on the card, ``--chain`` calls captured into one CUDA graph,
replayed ``--reps`` times between CUDA events, the mean (the device
alone; the reference chains dispatches to hide a network round trip);
on the CPU (``--device cpu``, the plain version) the host clock.
Not carried over: ``--tile`` (the TPU's tile height) and the noise
pre-roll (the port indexes noise by image row).

Run: python -m voxtracer_torch.app.slabprobe --scene menger
     python -m voxtracer_torch.app.slabprobe --scene castle \\
         --size 3840x2160 --ndev 4 --interleave 2,3 [--cyclic] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..engine.params import RenderParams, pack_trace_params
from ..engine.scene import SceneTables, load_scene
from ..ops import trace as trace_op
from ..ops.noise import white_noise_buffer
from ..parallel.mesh import cyclic_heights, slab_bounds
from . import camera_paths
from .renderbench import graph_ms

FRAME = 1
GBUF = ("color", "normal", "depth", "albedo", "node")


def slab_fn(tables, noise, params, width, slab_h, row_stride=1):
    """``row0 -> slab G-buffer``: the trace of ``slab_h`` rows at the
    mesh's call shape (``row_stride > 1``: the cyclic layout's bands)."""
    def fn(row0):
        return trace_op.render_sample(tables, params, noise, FRAME, slab_h,
                                      width, row0, row_stride)
    return fn


def contiguous_slabs(height, n_slabs):
    """``(row0, rows)`` of each contiguous slab (``mesh.slab_bounds``)."""
    return [(a, b - a) for a, b in slab_bounds(height, n_slabs)]


def cyclic_slabs(height, n):
    """``(row0, rows)`` of each device's one launch in the cyclic layout
    (row stride ``n``)."""
    return [(c * trace_op.BLOCK_ROWS, rows)
            for c, rows in enumerate(cyclic_heights(height, n))]


def time_slabs(fns, device, reps, chain):
    """The ms a call of each zero-argument ``fn``: on the card the mean
    over ``reps`` replays of a CUDA graph of ``chain`` calls
    (``renderbench.graph_ms``: the device alone, the wrapper's host work
    runs at the capture), on the CPU the best of ``reps`` runs of
    ``chain`` calls by the host clock."""
    ms = []
    for fn in fns:
        if device.type == "cuda":
            ms.append(graph_ms(fn, chain, reps))
            continue
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(chain):
                fn()
            best = min(best, (time.perf_counter() - t0) * 1e3 / chain)
        ms.append(best)
    return ms


def check_slabs(full, outs, slabs, row_stride=1):
    """Each slab's G-buffer equals the same image rows of the one-launch
    frame ``full`` (``ops/trace.py`` ``image_rows``), and the slabs' ray
    and step counters add up to the frame's.  Raises where not."""
    for (row0, rows), out in zip(slabs, outs):
        idx = torch.from_numpy(
            trace_op.image_rows(rows, row0, row_stride)).to(
                full["node"].device)
        for key in GBUF:
            if not torch.equal(out[key], full[key].index_select(-2, idx)):
                raise AssertionError(
                    f"slab row0={row0} rows={rows} stride={row_stride}: "
                    f"{key} differs from the frame's rows")
    for key in ("rays", "steps"):
        total = sum(out[key] for out in outs)
        if not torch.equal(total, full[key]):
            raise AssertionError(f"slabs' {key} {total.tolist()} != the "
                                 f"frame's {full[key].tolist()}")
    return True


def slab_waves(width, heights, device):
    """Each launch's blocks of 16x16 threads and its waves on the card
    (blocks over SMs x resident blocks per SM; None off the card)."""
    blocks = [-(-width // trace_op.BLOCK_COLS) * -(-h // trace_op.BLOCK_ROWS)
              for h in heights]
    if device.type != "cuda":
        return blocks, None
    per_wave = (torch.cuda.get_device_properties(device).multi_processor_count
                * trace_op.kernel_info()["blocks_per_sm"])
    return blocks, [b / per_wave for b in blocks]


def launch_overhead(slab_ms, full_ms):
    """What each launch beyond the frame's one costs: ``n`` slabs are
    ``n - 1`` launches more than the one full-frame launch."""
    n = len(slab_ms)
    return max((sum(slab_ms) - full_ms) / (n - 1), 0.0) if n > 1 else 0.0


def contiguous_row(k, n, width, slabs, ms, full_ms, device):
    """The report row of ``n * k`` contiguous slabs dealt round-robin."""
    ovh = launch_overhead(ms, full_ms)
    chip = [sum(ms[c::n]) for c in range(n)]
    fused = [c - (k - 1) * ovh for c in chip]
    blocks, waves = slab_waves(width, [rows for _, rows in slabs], device)
    return dict(
        k=k, slab_h=max(rows for _, rows in slabs),
        slab_rows=[rows for _, rows in slabs], launch_ovh_ms=ovh,
        slab_ms=ms, slab_blocks=blocks, slab_waves=waves, chip_ms=chip,
        max_ms=max(chip), mean_ms=sum(chip) / n,
        skew=max(chip) / (sum(chip) / n), fused_max_ms=max(fused),
        exact=True,
    )


def cyclic_row(n, width, height, slabs, ms, device):
    """The report row of the cyclic layout, one launch a device."""
    heights = [rows for _, rows in slabs]
    blocks, waves = slab_waves(width, heights, device)
    h_pad = sum(heights)
    return dict(
        layout="cyclic", block=trace_op.BLOCK_ROWS, h_pad=h_pad,
        slab_h=max(heights), chip_rows=heights,
        pad_waste=h_pad / height - 1, chip_ms=ms, chip_blocks=blocks,
        chip_waves=waves, max_ms=max(ms), mean_ms=sum(ms) / n,
        skew=max(ms) / (sum(ms) / n), exact=True,
    )


def probe(scene, width, height, n, ks, device, reps=5, chain=32,
          cyclic=False, full_ms=None, emit=None):
    """The rows :func:`main` prints (each also passed to ``emit`` as it
    is made), for a scene already loaded."""
    tables = SceneTables(scene, device)
    noise = torch.from_numpy(white_noise_buffer(seed=7)).to(device)
    cam = camera_paths.static(scene)(0.0)
    params = pack_trace_params(cam.rows(width, height), RenderParams())
    full_fn = slab_fn(tables, noise, params, width, height)
    full = full_fn(0)
    if full_ms is None:
        full_ms = time_slabs([lambda: full_fn(0)], device, reps,
                             max(4, chain // 4))[0]
    rows = [dict(full_frame_ms=full_ms, width=width, height=height, ndev=n)]

    def measure(slabs, row_stride):
        fns = [(lambda f=slab_fn(tables, noise, params, width, h, row_stride),
                r=r0: f(r)) for r0, h in slabs]
        check_slabs(full, [fn() for fn in fns], slabs, row_stride)
        return time_slabs(fns, device, reps, chain)

    def add(row):
        rows.append(row)
        if emit is not None:
            emit(row)

    if emit is not None:
        emit(rows[0])
    if cyclic:
        slabs = cyclic_slabs(height, n)
        add(cyclic_row(n, width, height, slabs, measure(slabs, n), device))
        return rows
    for k in ks:
        slabs = contiguous_slabs(height, n * k)
        add(contiguous_row(k, n, width, slabs, measure(slabs, 1), full_ms,
                           device))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", default="menger")
    p.add_argument("--size", default="1280x720", help="WxH")
    p.add_argument("--ndev", type=int, default=8)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--chain", type=int, default=32,
                   help="calls captured into a timed graph (card) or timed "
                        "together (CPU)")
    p.add_argument("--interleave", default="2,3,5",
                   help="comma list of k (thin slabs per device) to project")
    p.add_argument("--json", action="store_true")
    p.add_argument("--cyclic", action="store_true",
                   help="time the cyclic layout instead: one row_stride=n "
                        "launch per device")
    p.add_argument("--no-base", action="store_true",
                   help="skip the contiguous k=1 row")
    p.add_argument("--full-ms", type=float, default=None,
                   help="known full-frame single-launch ms (not re-timed)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    w, h = (int(v) for v in args.size.lower().split("x"))
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False")
    ks = ([] if args.no_base else [1]) + [
        int(v) for v in args.interleave.split(",") if v]

    def emit(row):
        print(json.dumps(row) if args.json else row, flush=True)

    rows = probe(load_scene(args.scene), w, h, args.ndev, ks, device,
                 args.reps, args.chain, args.cyclic, args.full_ms, emit)
    good = [r for r in rows if "k" in r]
    if not args.json and len(good) > 1:
        base, best = good[0], min(good, key=lambda r: r["max_ms"])
        print(f"\ncontiguous k={base['k']} skew {base['skew']:.3f} (frame "
              f"trace term {base['max_ms']:.4f} ms); best layout "
              f"k={best['k']}: skew {best['skew']:.3f}, "
              f"{best['max_ms']:.4f} ms "
              f"({base['max_ms'] / best['max_ms']:.3f}x vs k={base['k']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
