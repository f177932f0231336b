#!/usr/bin/env python3
"""Registers, stack and spills of every CUDA kernel of the port, as the
compiler reports them (``-Xptxas -v``), built from each of several
checkouts, and the kernels whose figures differ between them.

Run on a machine with nvcc, from the repository root:

    python3 tests/compare_ptxas.py --trees build/parent,.

(each tree a checkout, e.g. a ``git archive`` of another commit unpacked
into a git-ignored directory). Prints one JSON line per tree (its kernel
count, the spilling kernels) and one with the kernels of the first tree
whose registers, stack or spills differ in another, and the kernels only
one tree has.

    python3 tests/compare_ptxas.py --sass [NAME_REGEX]

prints, for each kernel of this tree's library whose name matches
NAME_REGEX (default: the level kernels), its global loads by SASS form
(``cuobjdump -sass``): ``LDG.E...CONSTANT`` is a load through the
read-only (non-coherent) cache, the form a level launch must not use for
the vectors it writes. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

BUILD = ("from iifea_tpu_torch.ops import stencil_kernels as sk; "
         "print(sk.build().with_suffix('.log'))")
# the anonymous namespace of a mangled name carries a hash of its source's
# contents (_GLOBAL__N__<hash>_15_stencil2d_rn_cu_<hash>): kept to the
# source's name, so that a kernel whose source changed elsewhere compares
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?_cu)_[0-9a-f]{8}")


def report(tree: Path) -> dict:
    """{kernel: (registers, stack, spill stores, spill loads)} of the
    library built from ``tree``'s sources."""
    from chip_smoke import ptxas_report

    log = subprocess.run([sys.executable, "-c", BUILD], cwd=tree,
                         capture_output=True, text=True, check=True)
    rows = ptxas_report(Path(tree, log.stdout.strip()).read_text())
    return {ANON.sub(r"\1", r["kernel"]): (
        r.get("registers"), r.get("stack"), r.get("spill_stores"),
        r.get("spill_loads")) for r in rows}


def sass_loads(pattern: str) -> None:
    """One JSON line per kernel whose (mangled) name matches ``pattern``:
    its LDG instructions counted by form."""
    import shutil
    from collections import Counter

    lib = subprocess.run([sys.executable, "-c", BUILD.replace(
        ".with_suffix('.log')", "")], cwd=HERE, capture_output=True,
        text=True, check=True).stdout.strip()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    name, loads = None, Counter()

    def flush():
        if name is not None and re.search(pattern, name):
            print(json.dumps({"kernel": ANON.sub(r"\1", name),
                              "ldg": dict(sorted(loads.items()))}),
                  flush=True)

    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            flush()
            name, loads = m.group(1), Counter()
            continue
        m = re.search(r"\bLDG(\.[\w.]+)?", line)
        if m:
            loads["LDG" + (m.group(1) or "")] += 1
    flush()


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--sass"]:
        sass_loads(args[1] if len(args) > 1 else "level")
        return
    if args[:1] != ["--trees"] or len(args) != 2:
        sys.exit("usage: compare_ptxas.py --trees DIR,DIR[,...] | --sass "
                 "[NAME_REGEX]")
    trees = [Path(t).resolve() for t in args[1].split(",")]
    reports = [report(t) for t in trees]
    for t, rep in zip(trees, reports):
        print(json.dumps({"tree": str(t), "kernels": len(rep),
                          "spilling": [k for k, v in rep.items()
                                       if v[2] or v[3]]}), flush=True)
    first = reports[0]
    print(json.dumps({
        "differ": {k: [rep.get(k) for rep in reports] for k in first
                   if any(k in rep and rep[k] != first[k]
                          for rep in reports[1:])},
        "only_in": {str(t): sorted(set(rep) - set(first))
                    for t, rep in zip(trees[1:], reports[1:])},
        "missing_from": {str(t): sorted(set(first) - set(rep))
                         for t, rep in zip(trees[1:], reports[1:])}}),
        flush=True)


if __name__ == "__main__":
    main()
