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

Bound (``bound_ms``; ``share`` = bound / ms): the program is one block
on one SM, so what the probe computes (:func:`stall_work`) over one
SM's rates: its lane operations over one SM's issue rate (4 x 32 lanes
at 1.98 GHz), its gathered table words over one SM's shared memory (128
B a clock), whichever is larger.  ``bound_card_ms`` is the same work
over the whole card's rates.

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

from .tracebench import HBM_BYTES_PER_S, LANE_OPS_PER_S

WIN = 24  # rows per serve window
M_ROWS = 256  # serve-table rows
TILE_H, TILE_W = 32, 128  # the tile the kernel computes
MAX_H = 8  # sweeps per trip the kernel accepts
A = 1103515245
MODES = ("static", "ser", "ind")

# One SM of the H100 SXM (LANE_OPS_PER_S is 132 SMs' issue rate): its
# shared memory serves 32 banks x 4 bytes a clock at 1.98 GHz
N_SMS = 132
SMEM_BYTES_PER_S = 128 * 1.98e9

# Lane operations of one element's sweep beyond its address, at the
# least: the window test, its word's predicated load and predicated xor
# (the masked address always lies in the table, so nothing else guards
# the load).  A static base is known before the address: it folds into
# the address's multiply-add and the window test is one compare; a base
# from a minimum comes after, and the test is a subtract and a compare.
SWEEP_OPS = {"static": 3, "ser": 4, "ind": 4}


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


def stall_work(trips, mode, h, pre, mid):
    """What the probe computes for the (32, 128) tile, as the least
    number of lane operations (one-instruction steps: a multiply-add, a
    mask, a compare, a load, a three-input minimum) that its definition
    (``_make_kernel``; :func:`run_plain`) needs: ``ops``, and ``words``,
    the table words its sweeps gather.

    Per element and trip: each chain op ``v * A + c`` one multiply-add;
    per sweep the address, two (the multiply-add ``x * 2 + 524 c`` or,
    for ``ind``, ``(x >> 1) * (8 c + 4) + 524 c``, and the mask: 4 x the
    address mod 2^17; ``ind`` shifts ``x`` once for all its sweeps
    beyond the first), then ``SWEEP_OPS``, not the TPU's 24-row ladder;
    the fold ``x ^ (y >> 16)``, two.  A minimum over the tile (``ser``,
    ``ind``) takes half an operation an element, a three-input minimum
    (``__vimin3_u32``, a DPX instruction of sm_90) taking in two;
    ``ind``'s words xor into ``x`` as ``ser``'s do, its addresses all
    known before.  Once: ``y``'s seed and the output's
    sum.  The scalar base arithmetic and the loop are not counted.
    ``words`` counts one word an element and sweep, more than the run's
    data needs where an element lies outside the window; it never binds
    (a word is 1/32 of one SM's shared-memory clock, the sweep's 5 or
    more operations 5/128 or more of its issue clock)."""
    n = TILE_H * TILE_W
    chains = pre + mid * (1 if mode == "ind" else h)
    addrs = 2 * h + int(mode == "ind" and h > 1)
    per_elem = chains + addrs + h * SWEEP_OPS[mode] + 2
    mins = 0 if mode == "static" else h * n // 2
    return dict(ops=trips * (n * per_elem + mins) + 2 * n,
                words=n * trips * h)


def stall_bound(trips, mode, h, pre, mid):
    """``(bound_ms, bound_by, bound_card_ms)``: the least time of
    :func:`stall_work` on one SM (the kernel is one block), the larger
    of its operations over one SM's issue rate (``"operations"``) and
    its gathered words over one SM's shared memory (``"bytes"``); and
    the same on the whole card, as if the work spread over its 132 SMs.
    The table and the tile through device memory, once each, count too
    (they never bind)."""
    w = stall_work(trips, mode, h, pre, mid)
    hbm_ms = (M_ROWS * 128 + 2 * TILE_H * TILE_W) * 4 / HBM_BYTES_PER_S * 1e3

    def on(sms):
        ops_ms = w["ops"] / (LANE_OPS_PER_S / N_SMS * sms) * 1e3
        smem_ms = 4 * w["words"] / (SMEM_BYTES_PER_S * sms) * 1e3
        return max((ops_ms, "operations"), (max(smem_ms, hbm_ms), "bytes"))

    bound_ms, bound_by = on(1)
    return bound_ms, bound_by, on(N_SMS)[0]


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
    if tab.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned (int4 loads)")
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


def check_cases(trips=64):
    """``(trips, mode, h, pre, mid)`` on which the kernel is held against
    :func:`run_plain`: every mode at h in {1, 2, 4, 8}, the matrix's
    longest chains, ``ind`` with long ones, odd trip and sweep counts
    (the handoff's buffers cycle by two), and static past 232 trips (its
    bases cycle by the trip count mod 232)."""
    return ([(trips, mode, hh, 0, 0) for mode in MODES
             for hh in (1, 2, 4, MAX_H)]
            + [(trips, "ser", 2, 3, 5), (trips, "ser", 1, 512, 0),
               (trips, "ser", 1, 0, 256), (trips, "ind", 4, 512, 256)]
            + [(37, "ser", 3, 1, 2), (37, "ind", 5, 2, 1),
               (37, "static", 7, 0, 3), (37, "ser", 1, 0, 0),
               (241, "static", MAX_H, 0, 1)])


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


def add_columns(rows, trips):
    """Each row's bound and share (:func:`stall_bound` at ``trips``), and
    for a ``ser`` or ``ind`` row its stall cycles against the static case
    of its own (h, pre, mid), else ``static:1``'s, wherever in ``rows``
    that case is."""
    static_at = {(r["h"], r["pre"], r["mid"]): r["cycles_per_trip"]
                 for r in rows if r["mode"] == "static"}
    for r in rows:
        key = (r["h"], r["pre"], r["mid"])
        base = static_at.get(key) or static_at.get((1, 0, 0))
        if r["mode"] != "static" and base is not None:
            extra = r["cycles_per_trip"] - base
            r["stall_cycles_total"] = round(extra, 1)
            r["stall_cycles_per_handoff"] = round(extra / r["h"], 1)
        bound_ms, bound_by, card_ms = stall_bound(trips, r["mode"], *key)
        r.update(bound_ms=round(bound_ms, 4), bound_by=bound_by,
                 share=round(bound_ms / r["ms"], 4),
                 bound_card_ms=round(card_ms, 6))
    return rows


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
    rows = add_columns([run_case(mode, h, pre, mid, args.trips, args.reps)
                        for mode, h, pre, mid in cases], args.trips)
    for r in rows:
        print(json.dumps(r) if args.json else r, flush=True)
    if not args.json:
        print(f"\ncycles/handoff = (mode cycles/trip - matching static) / h; "
              f"cycles from clock64() in the kernel on "
              f"{torch.cuda.get_device_name(0)}; bound over one SM's "
              f"issue and shared memory, share = bound / ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
