"""Direct microbenchmark of the vector→scalar handoff stall on the card.

Counterpart of :mod:`voxtracer.app.stallbench`.  One (32, 128) int32
tile runs ``trips`` trips of dependent integer work and serve sweeps
over a 256 x 128 table; the modes differ only in where each sweep's
window base comes from:

* ``static`` — the loop counter: no handoff (the control);
* ``ser`` — the minimum over the tile of the sweep's row addresses, ``h``
  times in series (each address depends on the last sweep);
* ``ind`` — ``h`` such minima from the trip-entry tile, all reduced
  before any sweep uses one.

``--pre K`` puts K dependent ops ahead of the reduce, ``--mid K``
between the reduce and its use.  On the card the minimum is a warp
reduction, a shared-memory combine and a block barrier
(``csrc/stallbench.cu``), so ``(ser - static) cycles / h`` is the cost of
one handoff there.  Cycles come from ``clock64()`` read inside the
kernel, times from CUDA events.

* :func:`run_plain` — the kernel's computation in plain torch ops (the
  reference the kernel is held against; any device).
* :func:`run_cuda` — the kernel; returns the tile and its cycle count.
* :func:`run_case` — one timed case on the card.

Run (needs a CUDA GPU; there is no interpreted mode):

    python -m voxtracer_torch.app.stallbench [--trips N] [--reps N]
        [--json] [--case mode:h[:pre[:mid]] ...]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

WIN = 24  # rows per serve window
M_ROWS = 256  # serve-table rows
TILE_H, TILE_W = 32, 128  # the tile the kernel computes
MAX_H = 8  # sweeps per trip the kernel accepts
A = 1103515245
MODES = ("static", "ser", "ind")


def make_inputs(device):
    """The table and tile of the reference's ``run_case``: the same
    ``default_rng(7)`` draws, in the same order."""
    rng = np.random.default_rng(7)
    tab = rng.integers(0, 1 << 20, size=(M_ROWS, 128), dtype=np.int32)
    x = rng.integers(0, 1 << 20, size=(TILE_H, TILE_W), dtype=np.int32)
    return (torch.from_numpy(tab).to(device), torch.from_numpy(x).to(device))


def _check(tab, x, trips, mode, h, pre, mid):
    if tuple(tab.shape) != (M_ROWS, 128) or tab.dtype != torch.int32:
        raise ValueError(f"tab must be ({M_ROWS}, 128) int32, got "
                         f"{tuple(tab.shape)} {tab.dtype}")
    if tuple(x.shape) != (TILE_H, TILE_W) or x.dtype != torch.int32:
        raise ValueError(f"x must be ({TILE_H}, {TILE_W}) int32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device != tab.device:
        raise ValueError(f"x on {x.device}, tab on {tab.device}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not 1 <= h <= MAX_H:
        raise ValueError(f"h must be in [1, {MAX_H}], got {h}")
    if min(trips, pre, mid) < 0:
        raise ValueError("trips, pre and mid must be >= 0")


def _wrap(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _vchain(v, n, salt):
    # dependent int chain: one plane-op per round, int32 wrap
    for i in range(n):
        v = _wrap(v.to(torch.int64) * A + (12345 + 97 * salt + i))
    return v


def _sweep(tab, waddr, base):
    """tab[waddr >> 7, waddr & 127] where that row lies in
    [base, base + WIN), else 0 (the serve sweep's result)."""
    rows = waddr >> 7
    off = rows - base
    g = tab[rows.long(), (waddr & 127).long()]
    return torch.where((off >= 0) & (off < WIN), g, 0)


def run_plain(tab, x, trips, mode, h, pre, mid):
    """The kernel's (32, 128) int32 output ``x + y`` with plain torch ops
    (the transcription of the reference's ``_make_kernel``)."""
    _check(tab, x, trips, mode, h, pre, mid)
    mod = M_ROWS * 128
    y = x ^ 0x5A5A5A5A
    for k in range(trips):
        y = _vchain(y, pre, 1)
        if mode == "ind":
            waddrs, bases = [], []
            for c in range(h):
                waddr = _wrap((x >> 1).to(torch.int64) * (2 * c + 1)
                              + 131 * c) % mod
                bases.append(torch.clamp((waddr >> 7).min(), 0, M_ROWS - WIN))
                waddrs.append(waddr)
            y = _vchain(y, mid, 2)
            acc = torch.zeros_like(x)
            for waddr, base in zip(waddrs, bases):
                acc = acc ^ _sweep(tab, waddr, base)
            x = x ^ acc
        else:
            for c in range(h):
                waddr = ((x >> 1) + 131 * c) % mod
                if mode == "ser":
                    base = torch.clamp((waddr >> 7).min(), 0, M_ROWS - WIN)
                else:
                    base = (k * (7 + 6 * c)) % (M_ROWS - WIN)
                y = _vchain(y, mid, 2 + c)
                x = x ^ _sweep(tab, waddr, base)
        x = x ^ (y >> 16)
    return _wrap(x.to(torch.int64) + y)


def run_cuda(tab, x, trips, mode, h, pre, mid):
    """The hand-written kernel (csrc/stallbench.cu): returns ``(out
    (32, 128) int32, cycles (1,) int64)``, the cycles that thread 0 read
    with ``clock64()`` around the trip loop.  Launches on the current
    stream and does not synchronise."""
    _check(tab, x, trips, mode, h, pre, mid)
    if tab.device.type != "cuda":
        raise ValueError(f"CUDA kernel given tensors on {tab.device}")
    if not (tab.is_contiguous() and x.is_contiguous()):
        raise ValueError("stallbench inputs must be contiguous")
    from ..ops import _build

    launch = _build.load().vt_stall_launch
    out = torch.empty_like(x)
    cycles = torch.empty(1, dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(tab.data_ptr(), x.data_ptr(), trips, MODES.index(mode),
                     h, pre, mid, out.data_ptr(), cycles.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"stallbench kernel launch failed: cudaError {err}")
    run_cuda.launches += 1
    return out, cycles


run_cuda.launches = 0


def run_case(mode, h, pre, mid, trips, reps):
    """One case on the card: a warm launch, then the best of ``reps``
    launches timed with CUDA events; the cycles are that launch's own."""
    if not torch.cuda.is_available():
        raise RuntimeError("stallbench needs a CUDA GPU")
    tab, x = make_inputs("cuda")
    run_cuda(tab, x, trips, mode, h, pre, mid)
    best_ms, best_cycles = float("inf"), None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, cycles = run_cuda(tab, x, trips, mode, h, pre, mid)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        if ms < best_ms:
            best_ms, best_cycles = ms, int(cycles.item())
    return dict(
        mode=mode, h=h, pre=pre, mid=mid,
        ms=round(best_ms, 4),
        cycles_per_trip=round(best_cycles / max(1, trips), 1),
    )


def parse_case(text):
    """``mode:h[:pre[:mid]]`` -> (mode, h, pre, mid)."""
    parts = text.split(":")
    if not 2 <= len(parts) <= 4 or parts[0] not in MODES:
        raise ValueError(f"case must be mode:h[:pre[:mid]] with mode in "
                         f"{MODES}, got {text!r}")
    nums = [int(v) for v in parts[1:]] + [0] * (4 - len(parts))
    return (parts[0], *nums)


def default_cases():
    return (
        # baseline linearity in sweep count
        [("static", hh, 0, 0) for hh in (1, 2, 4)]
        # direct serial cycles/handoff
        + [("ser", hh, 0, 0) for hh in (1, 2, 4)]
        # pairing probe: do independent handoffs pipeline?
        + [("ind", hh, 0, 0) for hh in (2, 4)]
        # latency-hiding probe: work between reduce and use
        + [("ser", 1, 0, mm) for mm in (64, 128, 256)]
        + [("static", 1, 0, mm) for mm in (64, 128, 256)]
        # drain-depth probe: in-flight work ahead of the reduce
        + [("ser", 1, pp, 0) for pp in (128, 512)]
        + [("static", 1, pp, 0) for pp in (128, 512)]
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trips", type=int, default=16384)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--json", action="store_true")
    p.add_argument(
        "--case", action="append", default=None,
        help="mode:h[:pre[:mid]] (repeat); default = full matrix",
    )
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stallbench runs the kernel on a CUDA GPU; "
                         "torch.cuda.is_available() is False")
    try:
        cases = ([parse_case(s) for s in args.case] if args.case
                 else default_cases())
    except ValueError as e:
        raise SystemExit(str(e))

    # every case first, so that each is compared with the static case of
    # its own (h, pre, mid) wherever the matrix has one, in any order
    rows = [run_case(mode, h, pre, mid, args.trips, args.reps)
            for mode, h, pre, mid in cases]
    static_at = {(r["h"], r["pre"], r["mid"]): r["cycles_per_trip"]
                 for r in rows if r["mode"] == "static"}
    for r in rows:
        key = (r["h"], r["pre"], r["mid"])
        base = static_at.get(key) or static_at.get((1, 0, 0))
        if r["mode"] != "static" and base is not None:
            extra = r["cycles_per_trip"] - base
            r["stall_cycles_total"] = round(extra, 1)
            r["stall_cycles_per_handoff"] = round(extra / r["h"], 1)
        print(json.dumps(r) if args.json else r, flush=True)
    if not args.json:
        print(f"\ncycles/handoff = (mode cycles/trip - matching static) / h; "
              f"cycles from clock64() in the kernel on "
              f"{torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
