"""HelloWorld — smoke-test echo servers.

Parity: reference `vproxyx/HelloWorld.java:206`: starts a TCP echo
server and a UDP echo server on the given (or random) port, prints
what it receives, echoes back with a greeting — a "does the runtime
work on this machine" check.

The port's copy of vproxy_tpu/apps/helloworld.py, same names and
behaviour; run() exits 0 on SIGTERM as on SIGINT, its loop closed.
"""
from __future__ import annotations

import sys
from typing import List

from ..net.connection import Connection, Handler, ServerSock
from ..net.eventloop import SelectorEventLoop
from ..net.udp import UdpServer

GREETING = b"hello from vproxy-tpu\n"


class _Echo(Handler):
    def on_data(self, conn, data):
        conn.write(GREETING + data)

    def on_eof(self, conn):
        conn.close_graceful()

    def on_closed(self, conn, err):
        pass


def start(loop: SelectorEventLoop, port: int):
    """Returns (tcp_server, udp_server, actual_port)."""
    def mk():
        def on_accept(fd, ip, p):
            c = Connection(loop, fd, (ip, p))
            c.set_handler(_Echo())
        return ServerSock(loop, "0.0.0.0", port, on_accept)
    tcp = loop.call_sync(mk)
    actual = tcp.port

    class UH:
        def on_data(self, conn, data):
            conn.write(GREETING + data)

        def on_closed(self, conn, err):
            pass

    udp = UdpServer(loop, "0.0.0.0", actual,
                    lambda c: c.set_handler(UH()))
    return tcp, udp, actual


def run(argv: List[str]) -> int:
    port = int(argv[0]) if argv else 0
    loop = SelectorEventLoop("helloworld")
    loop.loop_thread()
    try:
        _tcp, _udp, actual = start(loop, port)
    except OSError as e:
        print(f"helloworld: bind failed: {e}", file=sys.stderr)
        loop.close()
        return 1
    print(f"helloworld: echo on tcp/udp 0.0.0.0:{actual}", flush=True)
    wait_for_stop()
    loop.close()
    return 0


def wait_for_stop() -> None:
    """Block until SIGINT or SIGTERM: the caller then closes its loop
    and returns, so the process exits 0 with no loop thread left."""
    import signal
    import threading
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()
