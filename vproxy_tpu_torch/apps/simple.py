"""Simple mode — one-liner load balancer.

Parity: reference `vproxyx/Simple.java:257` (`-Deploy=Simple bind 80
backend h1:80,h2:80 ssl cert key protocol ...`): builds the full
resource graph (upstream, server-group, tcp-lb, controllers) from one
command line. `gen` prints the equivalent config script and exits —
same flag as the reference.

The port's copy of vproxy_tpu/apps/simple.py, same arguments and script.

Usage:
  python -m vproxy_tpu_torch simple bind <port> backend <ip:port,...>
      [protocol tcp|http|h2|...] [ssl <cert.pem> <key.pem>] [gen]
"""
from __future__ import annotations

import sys
from typing import List, Optional

from ..control.app import Application
from ..control.command import CmdError, Command


def build_script(bind: int, backends: List[str], protocol: str,
                 ssl: Optional[tuple]) -> List[str]:
    lines = [
        "add upstream ups0",
        "add server-group sg0 timeout 2000 period 5000 up 2 down 3",
        "add server-group sg0 to upstream ups0 weight 10",
    ]
    for i, b in enumerate(backends):
        lines.append(f"add server svr{i} to server-group sg0 "
                     f"address {b} weight 10")
    lb = f"add tcp-lb lb0 address 0.0.0.0:{bind} upstream ups0"
    if protocol != "tcp":
        lb += f" protocol {protocol}"
    if ssl is not None:
        lines.append(f"add cert-key ck0 cert {ssl[0]} key {ssl[1]}")
        lb += " cert-key ck0"
    lines.append(lb)
    return lines


def parse_args(argv: List[str]):
    bind = None
    backends: List[str] = []
    protocol = "tcp"
    ssl = None
    gen = False
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "bind":
            bind = int(argv[i + 1])
            i += 2
        elif a == "backend":
            backends = [b.strip() for b in argv[i + 1].split(",") if b.strip()]
            i += 2
        elif a == "protocol":
            protocol = argv[i + 1]
            i += 2
        elif a == "ssl":
            ssl = (argv[i + 1], argv[i + 2])
            i += 3
        elif a == "gen":
            gen = True
            i += 1
        else:
            raise ValueError(f"unknown simple-mode argument {a!r}")
    if bind is None or not backends:
        raise ValueError("simple mode needs `bind <port>` and "
                         "`backend <ip:port,...>`")
    return bind, backends, protocol, ssl, gen


def run(argv: List[str]) -> int:
    try:
        bind, backends, protocol, ssl, gen = parse_args(argv)
    except (ValueError, IndexError) as e:
        print(f"simple: {e}", file=sys.stderr)
        return 1
    script = build_script(bind, backends, protocol, ssl)
    if gen:
        print("\n".join(script))
        return 0
    app = Application.create()
    try:
        for line in script:
            Command.execute(app, line)
    except CmdError as e:
        print(f"simple: {e}", file=sys.stderr)
        app.close()
        return 1
    print(f"simple-mode lb on 0.0.0.0:{bind} -> {','.join(backends)} "
          f"protocol {protocol}")
    import threading
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    app.close()
    return 0
