"""Where B9's time goes: csrc/dense_match.cu built whole and in two cut
variants, timed on the same tables and batches in one process.

    python3 -m vproxy_tpu_torch.tools.dense_split [--out FILE]

The variants are this checkout's csrc/dense_match.cu with a few lines
replaced (PATCHES; the tool stops when one of them is not in the
source exactly once, as after an edit of the kernel):

* whole: the kernel as it is;
* staging: every tile staged and waited for, no rule compared;
* compare: only the block's first tile staged, then compared once for
  every tile of its range (the same shared memory each time).

The tables are chip_smoke.py's (configuration (a), 100,000 `mk_rules`
hint rules; (b), 50,000 routes and the 5,000-rule ACL) and the batches
phase_dense_times' at B = 16 / 512 / 4096. Each time is the profiler's
device time of the kernel, L2-warm and after a 256 MB write (cold).
Prints a JSON line per (table, batch, variant), the card's name and
power limit, and writes the rows to FILE (default dense_split.json).
Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# per cut variant, the (old, new) lines it replaces in dense_match.cu:
# "staging" stages every tile through the two-slot ring and compares no
# rule; "compare" stages no further tile and compares the first slot
# for every tile of the block's range
PATCHES = {
    "staging": [
        ("#pragma unroll 1\n    for (int j = 0; j < TILE; ++j) {",
         "#pragma unroll 1\n    for (int j = 0; j < 0; ++j) {"),
        ("    for (int j = 0; j < nt; ++j) {\n      const uint4 e",
         "    for (int j = 0; j < 0; ++j) {\n      const uint4 e"),
        ("    if (__syncthreads_and(done)) {", "    if (__syncthreads_and(0)) {")],
    "compare": [
        ("    if (t + 1 < t1) {  // tile t + 1 lands",
         "    if (false) {  // tile t + 1 lands"),
        ("    const uint4* slot = ring + ((t - t0) & 1) * a.stage_vec;",
         "    const uint4* slot = ring;"),
        ("    if (t0 + CTILE < r1) {", "    if (false) {"),
        ("    const uint4* slot = ring + (n & 1) * stage_vec;",
         "    const uint4* slot = ring;")],
}


def variant(src: str, name: str) -> str:
    """The source of variant `name` ("whole": as it is)."""
    for old, _ in PATCHES["staging"] + PATCHES["compare"]:
        if src.count(old) != 1:
            raise SystemExit(f"dense_split: {old.strip()!r} is not in "
                             "dense_match.cu once: update PATCHES to the "
                             "kernel")
    for old, new in PATCHES.get(name, []):
        src = src.replace(old, new)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="dense_split.json")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("dense_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.ops import tables as T
    from vproxy_tpu_torch.ops.matchers import table_arrays
    from vproxy_tpu_torch.rules.ir import Proto
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with open(DC.SOURCE) as f:
        src = f.read()
    work = os.path.join(root, "vproxy_tpu_torch", "_build", "split")
    os.makedirs(work, exist_ok=True)
    paths = {}
    for name in ("whole", "staging", "compare"):
        paths[name] = os.path.join(work, f"dense_match_{name}.cu")
        with open(paths[name], "w") as f:
            f.write(variant(src, name))
    with ThreadPoolExecutor(3) as ex:
        libs = dict(zip(paths, ex.map(
            lambda n: FC.build_library(paths[n], f"libdense_{n}", "split"),
            paths)))
    handles = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        for kind, st in (("hint", DC._DenseHintArgs),
                         ("cidr", DC._DenseCidrArgs)):
            fn = getattr(lib, f"vproxy_dense_{kind}")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(st), ctypes.c_int, ctypes.c_void_p]
        handles[name] = lib
        print(json.dumps({"variant": name, "ptxas": CS._ptxas(path)}),
              flush=True)

    device = torch.device("cuda")
    rules = CS.mk_rules(CS.N_RULES)
    ht = CS.dense_prepared(table_arrays(T.compile_hint_rules(rules)),
                           device, hint=True)
    nets = CS.route_nets(CS.N_ROUTES, CS.ROUTE_SEED)
    rt = CS.dense_prepared(table_arrays(T.compile_cidr_rules(nets)),
                           device, hint=False)
    acl = CS.acl_rules(CS.N_ACL, CS.ACL_SEED)
    at = CS.dense_prepared(table_arrays(T.compile_acl(acl, Proto.TCP)),
                           device, hint=False)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    rows = []
    for b in CS.TIME_BATCHES:
        q = CS.dense_hint_batch(CS.mk_queries(rules, b, 2600 + b), b, device)
        rq = CS.cidr_batch([(a, None) for a, _ in CS.cidr_queries(
            nets, b, 2700 + b)], b, device)
        aq = CS.cidr_batch(CS.acl_queries(acl, b, 2800 + b), b, device)
        cases = (("hint", CS.KERNEL_B9_HINT,
                  lambda: DC.hint_dense_cuda(ht, q)),
                 ("routes", CS.KERNEL_B9_CIDR,
                  lambda: DC.cidr_dense_cuda(rt, *rq)),
                 ("acl", CS.KERNEL_B9_CIDR,
                  lambda: DC.cidr_dense_cuda(at, *aq)))
        for table, kernel, fn in cases:
            for name, lib in handles.items():
                DC._LIB = lib
                warm = CS.device_ms(fn, 20, kernel, 1)
                cold = CS.device_ms(lambda: (flush.zero_(), fn()), 10,
                                    kernel, 1)
                row = {"table": table, "batch": b, "variant": name,
                       "ms": warm, "cold_ms": cold, "card": smi}
                rows.append(row)
                print(json.dumps(row), flush=True)
    DC._LIB = None
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "rows": rows}, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
