"""Versions of the stall kernel's source timed in turns on one card.

Each ``--source NAME=PATH[:DEFINE,...]`` is a ``.cu`` file with the
stall kernel's C entry ``vt_stall_launch``: the port's
``voxtracer_torch/csrc/stallbench.cu``, an older copy of it (``git show
REV:voxtracer_torch/csrc/stallbench.cu``), or another version, with
optional ``-D`` defines.  Each is built alone with the port's nvcc
flags, all compilers started together.  ``voxtracer_torch.app.
stallbench.run_cuda`` then launches it in place of the port's library:
every version is first held against ``run_plain`` on
``stallbench.check_cases()`` and on ser:1 and static:1 at the timed
trips (equal, or the run fails); then each runs the cases (the CLI's
default matrix unless ``--case``) with ``stallbench.run_case`` in turns,
A B ... B A, one JSON line a version, pass and case, with the CLI's
columns (``stallbench.add_columns``), the card's name and power limit,
its SM clock after the pass, and ``clock_ghz``, the kernel's cycles over
its event time (a lower bound of the clock it ran at).  ``--sass DIR``
writes each library's ``cuobjdump -sass`` there.

Run from the repository's root, on the card:

    python -m tools.stallturns --source old=prev/stallbench.cu \\
        --source new=voxtracer_torch/csrc/stallbench.cu [--sass DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from unittest import mock

import torch

from voxtracer_torch.app import stallbench
from voxtracer_torch.app.bench import device_label
from voxtracer_torch.ops import _build

OUT_DIR = os.path.join(_build.BUILD_DIR, "turns")


def build(sources):
    """``{name: CDLL}``, each ``(name, path, defines)`` built into a
    library of its own; prints ptxas's registers and spills."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = []
    for name, path, defines in sources:
        lib = os.path.join(OUT_DIR, f"lib{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
               *(f"-D{d}" for d in defines), "-o", lib, path]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        print(json.dumps({"source": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
        cdll = ctypes.CDLL(lib)
        p, i = ctypes.c_void_p, ctypes.c_int
        cdll.vt_stall_launch.argtypes = [p] * 2 + [i] * 5 + [p] * 3
        cdll.vt_stall_launch.restype = ctypes.c_int
        libs[name] = (cdll, lib)
    return libs


def sm_clock():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--source", action="append", required=True,
                   help="NAME=PATH[:DEFINE,...] (repeat)")
    p.add_argument("--trips", type=int, default=16384)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--case", action="append", default=None,
                   help="mode:h[:pre[:mid]] (repeat); default = full matrix")
    p.add_argument("--sass", default=None, help="directory for the SASS")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stallturns runs the kernels on a CUDA GPU")
    sources = []
    for text in args.source:
        name, _, rest = text.partition("=")
        path, _, defines = rest.partition(":")
        sources.append((name, path, [d for d in defines.split(",") if d]))
    names = [name for name, _, _ in sources]
    assert len(set(names)) == len(names) and all(names), names
    cases = ([stallbench.parse_case(s) for s in args.case] if args.case
             else stallbench.default_cases())

    libs = build(sources)
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        for name, (_, lib) in libs.items():
            with open(os.path.join(args.sass, f"{name}.sass"), "w") as f:
                subprocess.run([cuobjdump, "-sass", lib], stdout=f, check=True)

    def on(name):
        return mock.patch.object(_build, "load", lambda: libs[name][0])

    tab, x = stallbench.make_inputs("cuda")
    checks = stallbench.check_cases() + [(args.trips, "ser", 1, 0, 0),
                                         (args.trips, "static", 1, 0, 0)]
    for case in checks:
        want = stallbench.run_plain(tab, x, *case)
        for name in names:
            with on(name):
                got, _ = stallbench.run_cuda(tab, x, *case)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, case)
    print(json.dumps({"equal_to_plain_cases": len(checks), "sources": names}),
          flush=True)

    device = device_label(torch.device("cuda"))
    for run, name in enumerate(names + names[::-1]):
        with on(name):
            rows = stallbench.add_columns(
                [stallbench.run_case(*case, args.trips, args.reps)
                 for case in cases], args.trips)
        clock = sm_clock()
        for r in rows:
            r.update(source=name, run=run, trips=args.trips, device=device,
                     sm_clock=clock, clock_ghz=round(
                         r["cycles_per_trip"] * args.trips / (r["ms"] * 1e6),
                         4))
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
