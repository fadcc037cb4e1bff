"""The instructions in the loops of a CUDA library's machine code (SASS).

``cuobjdump -sass`` lists each kernel's instructions by address. A branch
to an earlier address closes a loop, from its target to the branch; this
module finds those loops in every kernel and counts the instructions in
each by opcode (``HMMA`` the tensor cores' matrix products, ``FADD``,
``FMUL``, ``FFMA`` the float32 pipe, ``SHFL`` the warp shuffles). A loop's
range includes the loops nested in it. For the layout probe's kernels the
loops are the repeat loops (the compiler may unroll one into a main loop
of several repeats and a remainder loop of one), so their counts show
what each repeat computes.

Run on a machine with the CUDA toolkit, after the kernels are built::

    python -m aligator_tpu_torch.probes.sass_loops [--source NAME] [--sass FILE]

(``--source`` a ``csrc/`` source, default ``layout_probe``; ``--sass`` a
saved ``cuobjdump -sass`` listing instead of the built library).
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path
from typing import Dict, List, Tuple

OPS = ("HMMA", "FFMA", "FADD", "FMUL", "SHFL")
_FUNC = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"\b0x([0-9a-f]+)")


def label(name: str) -> str:
    """A short name for a mangled kernel or device function of the port's
    sources: its identifier (past the file-local namespaces) and integer
    template arguments."""
    if not name.startswith("_ZN"):
        return name[:60]
    pos = 3
    while True:
        m = re.match(r"\d+", name[pos:])
        if not m:
            return name[:60]
        n = int(m.group(0))
        ident = name[pos + len(m.group(0)):pos + len(m.group(0)) + n]
        pos += len(m.group(0)) + n
        if not ident.startswith(("_INTERNAL_", "_GLOBAL__N_")):
            break
    args = re.match(r"I((?:Lin?\d+E)+)E", name[pos:])
    if args:
        vals = [v.replace("n", "-") for v in re.findall(r"Li(n?\d+)E", args.group(1))]
        ident += "<" + ", ".join(vals) + ">"
    return ident


Code = List[Tuple[int, str, int]]  # (address, opcode, branch target or -1)


def parse(text: str) -> Dict[str, Code]:
    """Each function's instructions: address, opcode without its
    modifiers, and a branch's target address (-1 for other opcodes)."""
    funcs: Dict[str, Code] = {}
    code: Code = []
    for line in text.splitlines():
        f = _FUNC.search(line)
        if f:
            code = funcs.setdefault(f.group(1), [])
            continue
        m = _INSTR.search(line)
        if m:
            op = m.group(2).split(".")[0]
            t = _TARGET.search(m.group(3)) if op in ("BRA", "BRX") else None
            code.append((int(m.group(1), 16), op, int(t.group(1), 16) if t else -1))
    return funcs


def loops(code: Code) -> List[Tuple[int, int]]:
    """(first, last) address of each loop, closed by a branch backwards,
    in the order of their first address; not the branch to itself that
    ends a kernel's code after its last EXIT."""
    return sorted({(t, a) for a, op, t in code if 0 <= t < a})


def counts(code: Code, lo: int = 0, hi: int = 1 << 62) -> Counter:
    """Instructions with addresses in [lo, hi], by opcode."""
    return Counter(op for a, op, _ in code if lo <= a <= hi)


def report(text: str) -> List[dict]:
    """Every function with its instruction count and its loops, each loop
    with its range, its instruction count and its ``OPS`` counts."""
    rows = []
    for name, code in parse(text).items():
        rows.append(dict(function=label(name), instructions=len(code), loops=[
            dict(first=lo, last=hi, instructions=sum(c.values()),
                 **{op: c[op] for op in OPS})
            for lo, hi in loops(code) for c in [counts(code, lo, hi)]]))
    return rows


def lines(rows: List[dict]) -> List[str]:
    out = []
    for r in rows:
        parts = [f"loop [{lp['first']:#06x}, {lp['last']:#06x}] {lp['instructions']} "
                 "instructions: " + ", ".join(f"{op} {lp[op]}" for op in OPS)
                 for lp in r["loops"]]
        out.append(f"sass {r['function']}: {r['instructions']} instructions; "
                   + ("; ".join(parts) if parts else "no loop"))
    return out


def cuobjdump(path: Path) -> str:
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([exe, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default="layout_probe")
    ap.add_argument("--sass", type=Path, help="a saved cuobjdump -sass listing")
    args = ap.parse_args(argv)
    if args.sass:
        text = args.sass.read_text()
    else:
        from aligator_tpu_torch.utils import cuda_build
        cuda_build.build_all()
        text = cuobjdump(cuda_build._target(args.source))
    for line in lines(report(text)):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
