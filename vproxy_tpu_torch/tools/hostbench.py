"""hostbench: the native epoll HTTP load tool, built from the port.

`native/hostbench.cpp` is the port's copy of the reference's load tool
(line for line; only `//` comment text differs). This module builds it
and drives it:

* `build_tool()` compiles it with g++ -O2 ... -ldl at first use into
  `_build/hostbench_<hash>` beside the package (which .gitignore
  lists): keyed by the source's content and the compiler's flags, under
  a lock file (concurrent processes build it once), written to a
  temporary name and renamed into place, as net/vtl.py builds libvtl;
* `start_server()` starts `hostbench server 0` and returns the process
  and the port it bound;
* `run_client(...)` runs one client (keep-alive, short-connection or
  TLS) and returns its JSON line;
* `serve_through_lb(...)`: a port TcpLB (http-splice, lanes off) with
  one Host hint rule in front of `backends` hostbench servers, and one
  client run through it. The LB's classify runs on the device that
  utils/torchenv.default_device picks, through ClassifyService.

The benchmark that times the host path is not here.

    python -m vproxy_tpu_torch.tools.hostbench [--secs S] [--conns N]
        [--pipeline P] [--backends B] [--device cpu]

prints serve_through_lb's result as one JSON line. Without a GPU it
raises unless the CPU is asked for (`--device cpu` or
VPROXY_TPU_TORCH_DEVICE=cpu).
"""
from __future__ import annotations

import argparse
import errno
import fcntl
import hashlib
import json
import os
import subprocess
import sys
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "hostbench.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O2",)
LIBS = ("-ldl",)
HOST = "bench.example.com"  # the Host header of hostbench.cpp's REQ


def build_tool(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Compile `source` once; -> `<build_dir>/hostbench_<content hash>`.
    The hash covers the source, the compiler and its flags, so an edited
    source builds a new binary and an unchanged one is reused. One
    process builds under the lock file while the others wait. Raises
    OSError when the compiler is missing or fails."""
    cxx = os.environ.get("CXX", "g++")
    with open(source, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(
        src + " ".join((cxx, *CXX_FLAGS, *LIBS)).encode()).hexdigest()[:16]
    binary = os.path.join(build_dir, f"hostbench_{tag}")
    if os.path.exists(binary):
        return binary
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".hostbench.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(binary):
            return binary
        tmp = f"{binary}.{os.getpid()}.tmp"
        try:
            r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, source, *LIBS],
                               capture_output=True, text=True)
        except OSError as e:
            raise OSError(e.errno, f"hostbench: cannot run {cxx}: {e}") \
                from e
        if r.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise OSError(errno.EIO, f"hostbench: {cxx} failed "
                          f"({r.returncode}): {r.stderr[-2000:]}")
        os.replace(tmp, binary)
    return binary


def start_server(binary: str = None) -> tuple:
    """`hostbench server 0` -> (process, the port it listens on)."""
    p = subprocess.Popen([binary or build_tool(), "server", "0"],
                         stdout=subprocess.PIPE, text=True)
    line = p.stdout.readline()
    try:
        port = json.loads(line)["listening"]
    except (ValueError, KeyError):
        p.kill()
        p.wait(10)
        raise RuntimeError(f"hostbench server did not start: {line!r}")
    return p, port


def run_client(port, conns, secs, pipeline, tls_sni=None, short=False,
               binary: str = None) -> dict:
    """One client run against 127.0.0.1:port -> its JSON line
    ({"reqs", "secs", "rps", "errors", "conns", "pipeline"})."""
    binary = binary or build_tool()
    if short:
        cmd = [binary, "shortclient", "127.0.0.1", str(port), str(conns),
               str(secs)]
    elif tls_sni is None:
        cmd = [binary, "client", "127.0.0.1", str(port), str(conns),
               str(secs), str(pipeline)]
    else:
        cmd = [binary, "tlsclient", "127.0.0.1", str(port), tls_sni,
               str(conns), str(secs), str(pipeline)]
    out = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                         timeout=secs + 60)
    return json.loads(out.stdout.strip().splitlines()[-1])


def serve_through_lb(secs: float = 3.0, conns: int = 16,
                     pipeline: int = 4, backends: int = 2) -> dict:
    """`backends` hostbench servers behind a port TcpLB (http-splice,
    lanes off, one ServerGroup under a Host hint rule for HOST), one
    `client` run of `secs` through it. Each accepted connection's head
    is classified through ClassifyService against the Upstream's
    matcher on the default device. -> the client's line, with the
    device, the classify queries answered and the servers' hits."""
    from ..components.elgroup import EventLoopGroup
    from ..components.servergroup import HealthCheckConfig, ServerGroup
    from ..components.tcplb import TcpLB
    from ..components.upstream import Upstream
    from ..rules.ir import HintRule
    from ..rules.service import ClassifyService
    from ..utils.torchenv import default_device
    device = default_device()
    binary = build_tool()
    procs, elg, group, lb = [], None, None, None
    try:
        ports = []
        for _ in range(backends):
            p, port = start_server(binary)
            procs.append(p)
            ports.append(port)
        elg = EventLoopGroup("hostbench", 2)
        group = ServerGroup("hostbench-g", elg, HealthCheckConfig(
            timeout_ms=500, period_ms=200, up=1, down=100), "wrr")
        for i, port in enumerate(ports):
            group.add(f"b{i}", "127.0.0.1", port)
        deadline = time.monotonic() + 10
        while sum(s.healthy for s in group.servers) < backends:
            if time.monotonic() > deadline:
                raise TimeoutError("hostbench servers never came healthy")
            time.sleep(0.02)
        ups = Upstream("hostbench-u")
        ups.add(group, annotations=HintRule(host=HOST))
        lb = TcpLB("hostbench-lb", elg, elg, "127.0.0.1", 0, ups,
                   protocol="http-splice", lanes=0)
        lb.start()
        q0 = ClassifyService.get().stats.queries
        res = run_client(lb.bind_port, conns, secs, pipeline, binary=binary)
        res["classify_queries"] = ClassifyService.get().stats.queries - q0
        res["device"] = str(device)
        res["backends"] = backends
        return res
    finally:
        if lb is not None:
            lb.stop()
        if group is not None:
            group.close()
        if elg is not None:
            elg.close()
        for p in procs:
            p.kill()
            p.wait(10)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--secs", type=float, default=3.0)
    ap.add_argument("--conns", type=int, default=16)
    ap.add_argument("--pipeline", type=int, default=4)
    ap.add_argument("--backends", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="serve on this torch device (default: "
                    "VPROXY_TPU_TORCH_DEVICE, else cuda; no GPU raises "
                    "unless cpu is asked for)")
    args = ap.parse_args(argv)
    from ._fleetlib import select_device
    select_device(args.device)
    res = serve_through_lb(args.secs, args.conns, args.pipeline,
                           args.backends)
    print(json.dumps(res))
    return 0 if res["errors"] == 0 and res["reqs"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
