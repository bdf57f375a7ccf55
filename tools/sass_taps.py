"""The instructions a kernel's innermost loops issue per tap, from SASS.

``cuobjdump -sass`` of a built kernel library; for each function whose
mangled name matches ``--function`` (a regular expression), each innermost
loop (the range of a backward branch that holds no other) with its
instructions (NOPs left out), its ``MUFU.EX2`` (one an ``expf``: one a
tap of the denoise kernel) and its ``LDS``.  One JSON line a function:
the loops, and over the loops with the most ``EX2`` the instructions
per ``EX2`` (``per_tap``: least, median, most).

    python -m tools.sass_taps [--library PATH] [--function REGEX]

By default the library ``voxtracer_torch/ops/_build.py`` builds from the
current sources (on the card, where nvcc is), and the denoise kernel's
by-value instances at r = 2 and 8.  Run from the repository's root.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys

FUNCTION = re.compile(r"^\s*Function : (\S+)")
INSTRUCTION = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
TARGET = re.compile(r"\bBRA(?:\.\S+)?\s+(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)")


def functions(sass: str):
    """{mangled name: [(address, instruction text, branch target's
    address or None)]}."""
    parsed, name = {}, None
    for line in sass.splitlines():
        m = FUNCTION.match(line)
        if m:
            name = m.group(1)
            parsed[name] = ([], {}, [])  # rows, labels, labels pending
            continue
        if name is None:
            continue
        rows, labels, pending = parsed[name]
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTRUCTION.match(line)
        if m:
            addr = int(m.group(1), 16)
            labels.update((label, addr) for label in pending)
            pending.clear()
            rows.append((addr, m.group(2)))
    out = {}
    for name, (rows, labels, _) in parsed.items():
        out[name] = []
        for addr, text in rows:
            t = TARGET.search(text)
            target = None
            if t:
                target = (labels.get(t.group(1)) if t.group(1).startswith(".")
                          else int(t.group(1), 16))
            out[name].append((addr, text, target))
    return out


def opcode(text: str) -> str:
    words = text.split()
    return words[1] if words and words[0].startswith("@") else words[0]


def loops(rows):
    """Each innermost loop: (first address, last address, instructions,
    MUFU.EX2, LDS)."""
    spans = sorted({(t, a) for a, _, t in rows if t is not None and t <= a})
    inner = [(s, e) for s, e in spans
             if not any((s2, e2) != (s, e) and s <= s2 and e2 <= e
                        for s2, e2 in spans)]
    res = []
    for s, e in inner:
        ops = [opcode(text) for a, text, _ in rows if s <= a <= e]
        ops = [o for o in ops if o != "NOP"]
        res.append((s, e, len(ops), sum(o == "MUFU.EX2" for o in ops),
                    sum(o.startswith("LDS") for o in ops)))
    return res


def summary(name: str, rows) -> dict:
    found = loops(rows)
    most = max((ex2 for _, _, _, ex2, _ in found), default=0)
    per = sorted(n / ex2 for _, _, n, ex2, _ in found if most and ex2 == most)
    return {
        "function": name,
        "instructions": sum(opcode(t) != "NOP" for _, t, _ in rows),
        "loops": [{"at": hex(s), "instructions": n, "ex2": x, "lds": d}
                  for s, _, n, x, d in found],
        "ex2_most": most,
        "per_tap": ([per[0], statistics.median(per), per[-1]]
                    if per else None),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--library", default=None)
    p.add_argument("--function", default=r"denoise_kernelILi[28]ELb0E")
    args = p.parse_args(argv)
    lib = args.library
    if lib is None:
        from voxtracer_torch.ops import _build

        lib = _build.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    pattern = re.compile(args.function)
    found = 0
    for name, rows in sorted(functions(sass).items()):
        if pattern.search(name):
            print(json.dumps(summary(name, rows)), flush=True)
            found += 1
    if not found:
        print(f"no function matches {args.function}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
