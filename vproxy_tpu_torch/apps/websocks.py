"""Deployable WebSocks apps (reference -Deploy=WebSocksProxyServer /
-Deploy=WebSocksProxyAgent, vproxyx/WebSocksProxyServer.java:347 /
WebSocksProxyAgent.java:398).

Usage:
  python -m vproxy_tpu_torch websocks server <port> user1:pass1[,user2:pass2...]
         [kcp] [root=<dir>] [redirect=<url>]
  python -m vproxy_tpu_torch websocks agent <socks-port> <server-host:port>
         <user:pass> [kcp] [rule=<domain-or-:port-or-/re/-or-*>]...
         [connect=<port>] [pac=<port>]

The port's copy of vproxy_tpu/apps/websocks.py, same names and behaviour.
"""
from __future__ import annotations

import signal
import threading

from ..components.elgroup import EventLoopGroup


def run(argv: list[str]) -> int:
    if not argv or argv[0] not in ("server", "agent"):
        print(__doc__)
        return 1
    mode = argv.pop(0)
    import os
    elg = EventLoopGroup("websocks", os.cpu_count() or 1)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())

    if mode == "server":
        from ..websocks.server import WebSocksProxyServer
        port = int(argv.pop(0))
        users = dict(u.split(":", 1) for u in argv.pop(0).split(","))
        kw = {}
        for a in argv:
            if a == "kcp":
                kw["kcp"] = True
            elif a.startswith("root="):
                kw["page_root"] = a[5:]
            elif a.startswith("redirect="):
                kw["redirect"] = a[9:]
        srv = WebSocksProxyServer("websocks", elg.next(), "0.0.0.0", port,
                                  users, **kw)
        srv.start()
        print(f"websocks server on :{srv.bind_port} "
              f"({'tcp+kcp' if kw.get('kcp') else 'tcp'})")
        stop.wait()
        srv.stop()
    else:
        from ..websocks.agent import WebSocksProxyAgent, WebSocksServerRef
        socks_port = int(argv.pop(0))
        host, _, p = argv.pop(0).rpartition(":")
        user, _, password = argv.pop(0).partition(":")
        kcp = "kcp" in argv
        rules = [a[5:] for a in argv if a.startswith("rule=")] or ["*"]
        connect = next((int(a[8:]) for a in argv
                        if a.startswith("connect=")), None)
        pac = next((int(a[4:]) for a in argv if a.startswith("pac=")), None)
        agent = WebSocksProxyAgent(
            elg, [WebSocksServerRef(host, int(p), user, password, kcp=kcp)],
            proxy_rules=rules, socks_port=socks_port,
            http_connect_port=connect, pac_port=pac)
        print(f"websocks agent: socks5 on 127.0.0.1:{agent.socks_port}"
              + (f", http-connect {agent.http_connect_port}"
                 if agent.http_connect_port else "")
              + (f", pac {agent.pac_port}" if agent.pac_port else ""))
        stop.wait()
        agent.close()
    elg.close()
    return 0
