"""Static instruction counts of the port's kernels, read off their SASS.

    python -m apdmvs_tpu_torch.sass_counts [NAME ...] [--dump DIR]

Builds the named kernel libraries (default: every source of
``ops/_build.SOURCES``), disassembles each with ``cuobjdump -sass`` and
prints one line a kernel function: its instruction count and the counts of
a few classes (global loads and stores, shared-memory accesses, 64-bit
address arithmetic, FP32 arithmetic, conversions, branches). These are
counts of the code, not of what runs: a loop body counts once. With
``--dump`` it also writes each library's whole SASS to ``DIR/<name>.sass``,
to read a loop body by eye. Needs the CUDA toolkit (``nvcc`` and
``cuobjdump``), not a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess

from apdmvs_tpu_torch.ops import _build

_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
_FUNC = re.compile(r"Function : (\S+)")
_FP32 = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK", "MUFU")


def classify(op: str) -> str:
    """The class of one SASS opcode (with its modifiers, e.g. ``LDG.E.U16``)."""
    base, *mods = op.split(".")
    if base == "LDG":
        return "global_load"
    if base in ("STG", "RED", "ATOMG"):
        return "global_store"
    if base in ("LDS", "STS", "LDSM", "LDGSTS"):
        return "shared"
    # the high halves of 64-bit addresses: wide multiplies and carry-ins
    if op.startswith("IMAD.WIDE") or (base in ("IADD3", "IMAD", "LEA") and "X" in mods):
        return "addr64"
    if base in _FP32:
        return "fp32"
    if base in ("F2F", "F2I", "I2F", "FRND", "I2FP", "F2FP"):
        return "convert"
    if base in ("BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "WARPSYNC", "BAR"):
        return "branch_sync"
    return "other"


def sass_of(so_path: str) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout


def counts(sass: str):
    """function name -> Counter of instruction classes (plus ``total``)."""
    out, cur = {}, None
    for line in sass.splitlines():
        fn = _FUNC.search(line)
        if fn:
            cur = out.setdefault(fn.group(1), collections.Counter())
            continue
        m = _INSTR.search(line)
        if m and cur is not None and m.group(1) != "NOP":
            cur[classify(m.group(1))] += 1
            cur["total"] += 1
    return out


def _demangle(names):
    tool = shutil.which("c++filt")
    if tool is None:
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    return dict(zip(names, res.stdout.splitlines())) if res.returncode == 0 else {
        n: n for n in names}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="apdmvs_tpu_torch.sass_counts",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", default=list(_build.SOURCES))
    ap.add_argument("--dump", default=None, help="directory for each library's whole SASS")
    args = ap.parse_args(argv)
    _build.build_all(args.names)
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
    for name in args.names:
        sass = sass_of(_build._so_path(name))
        if args.dump:
            with open(os.path.join(args.dump, f"{name}.sass"), "w") as f:
                f.write(sass)
        per_fn = counts(sass)
        readable = _demangle(list(per_fn))
        for fn, c in per_fn.items():
            print(f"SASS {name} {readable[fn]} " + json.dumps(dict(sorted(c.items()))))


if __name__ == "__main__":
    main()
