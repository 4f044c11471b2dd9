"""Compare the machine code of two versions of one CUDA source, kernel by
kernel.

    python3 -m vproxy_tpu_torch.tools.sass_diff OLD.cu NEW.cu \
        [--rename PATTERN REPLACEMENT ...]

Builds both with nvcc (the flags of ops/fused_cuda.py NVCC_FLAGS, as a
cubin), dumps their SASS with cuobjdump and prints, per kernel of OLD,
its instruction count in each and how alike the two opcode sequences
are (difflib's ratio, 1.0000: the same opcodes in the same order;
registers and operands are not compared). A kernel's name drops the
hash nvcc gives an anonymous namespace, so a kernel keeps its name
across edits of its file; `--rename` pairs a kernel of OLD with the
kernel of NEW named re.sub(PATTERN, REPLACEMENT, its name) (a template
parameter added, say); a kernel only NEW has is listed apart. Use it
when a change must leave some instances as they were: adding a field to
a kernel's argument struct, or wrapping its body in a function, has
changed a kernel's code (PERF.md). Needs nvcc and cuobjdump (the CUDA
toolkit of the card host).
"""
from __future__ import annotations

import argparse
import difflib
import os
import re
import subprocess
import sys
import tempfile


def functions(sass: str) -> dict:
    """cuobjdump -sass text -> {kernel name: [opcode, ...]}: predicates
    and operands dropped, the anonymous namespace's hash replaced by
    ANON."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "ANON",
                      part.split()[0])
        ops = []
        for line in part.splitlines():
            m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(.*?);", line)
            if m:
                ops.append(re.sub(r"^@!?U?P\w+\s+", "", m.group(1).strip())
                           .split()[0])
        out[name] = ops
    return out


def compare(old: dict, new: dict, renames=()) -> list:
    """-> [(kernel, old count, new count or None, ratio or None)] for
    every kernel of `old` (its name in `new` after the (pattern,
    replacement) `renames`), then (kernel, None, new count, None) for
    every kernel of `new` no kernel of `old` was paired with."""
    rows, paired = [], set()
    for name, ops in sorted(old.items()):
        to = name
        for pattern, replacement in renames:
            to = re.sub(pattern, replacement, to)
        if to in new:
            paired.add(to)
            sm = difflib.SequenceMatcher(a=ops, b=new[to], autojunk=False)
            rows.append((name, len(ops), len(new[to]), sm.ratio()))
        else:
            rows.append((name, len(ops), None, None))
    rows += [(name, None, len(ops), None) for name, ops in
             sorted(new.items()) if name not in paired]
    return rows


def sass_of(source: str, workdir: str) -> str:
    """nvcc `source` into a cubin, then its SASS text."""
    from vproxy_tpu_torch.ops import fused_cuda as FC
    nvcc = FC._nvcc()
    flags = [f for f in FC.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                   "-fPIC")]
    cubin = os.path.join(workdir, os.path.basename(source) + ".cubin")
    subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, source], check=True,
                   capture_output=True)
    dump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    return subprocess.run([dump, "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rename", nargs=2, action="append", default=[],
                    metavar=("PATTERN", "REPLACEMENT"))
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        old = functions(sass_of(args.old, os.path.join(tmp)))
        os.makedirs(os.path.join(tmp, "new"))
        new = functions(sass_of(args.new, os.path.join(tmp, "new")))
    for name, a, b, ratio in compare(old, new, args.rename):
        print(f"{name}: old {a} new {b} "
              f"{'' if ratio is None else f'ratio {ratio:.4f}'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
