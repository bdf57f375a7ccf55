"""Runs of cells one after another, each a process of its own, as the
check makes them; prints each run's result line and, per cell and
metric, the median and the spread (the distance between the first and
third quartiles, ``statistics.quantiles(values, n=4)``, over the median)
of each set of runs.  Not part of a benchmark run: the tool that sets
the bounds and the limits.

    python3 benchmark/series.py --cells A B --seeds 1 2 3 [--sets 2]
        [--seconds 10] [--trace 0] [--control 0] [--out FILE.jsonl]

``--sets 2`` runs the seeds twice, the same seeds in both sets; each
run's line goes to ``--out`` as it ends.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values):
    """(median, IQR over median) of ``values``."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def one(cell, seed, seconds, trace, control, timeout):
    cmd = [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
           "--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    if control:
        cmd += ["--control", "1"]
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    wall = time.perf_counter() - t
    lines = p.stdout.strip().splitlines()
    try:
        res = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        res = None
    return {"cell": cell, "seed": seed, "trace": trace, "rc": p.returncode,
            "wall_s": wall, "result": res,
            "stderr_tail": p.stderr[-1500:] if p.returncode or res is None
            else p.stderr[-400:]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cells", nargs="+", required=True)
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--timeout", type=float, default=360)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    runs = []
    for cell in args.cells:
        for s in range(args.sets):
            for seed in args.seeds:
                r = one(cell, seed, args.seconds, args.trace, args.control,
                        args.timeout)
                r["set"] = s
                runs.append(r)
                line = json.dumps(r)
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
    for cell in args.cells:
        for s in range(args.sets):
            rs = [r["result"] for r in runs if r["cell"] == cell
                  and r["set"] == s and r["result"]]
            names = sorted({k for r in rs for k in r["metrics"]})
            for k in names:
                vals = [r["metrics"][k]["value"] for r in rs
                        if k in r["metrics"]]
                med, sp = spread(vals)
                print(f"SUMMARY {cell} set {s} {k}: n {len(vals)} median "
                      f"{med!r} spread {sp:.5f} values {vals}", flush=True)
            ok = [r["correct"] for r in rs]
            print(f"SUMMARY {cell} set {s} correct {ok}", flush=True)
            ctl = [r["control_correct"] for r in rs if "control_correct" in r]
            if ctl:
                print(f"SUMMARY {cell} set {s} control_correct {ctl}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
