"""ServerAddressUpdater — periodic re-resolve of hostname backends.

Parity: reference `app/ServerAddressUpdater.java:171`: servers added by
hostname keep their `host_name`; this updater re-resolves each name on
a period and swaps the server's IP in place (ServerGroup.replace_ip)
when DNS moved it — health checks restart against the new address.
Resolution happens on a dedicated thread (getaddrinfo blocks); the
swap itself is the group's own thread-safe admin call.

The port's copy of vproxy_tpu/components/updater.py, same names and behaviour.
"""
from __future__ import annotations

import socket
import threading
from typing import Callable, Dict, Iterable, Optional

DEFAULT_PERIOD_S = 60.0


def _resolve_all(host: str, want_v6: bool) -> list[str]:
    try:
        fam = socket.AF_INET6 if want_v6 else socket.AF_INET
        infos = socket.getaddrinfo(host, None, fam, socket.SOCK_STREAM)
    except OSError:
        return []
    return [i[4][0] for i in infos]


class ServerAddressUpdater:
    """groups: callable returning the live ServerGroup iterable (so the
    updater always sees the current resource graph)."""

    def __init__(self, groups: Callable[[], Iterable],
                 period_s: float = DEFAULT_PERIOD_S):
        self.groups = groups
        self.period_s = period_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run,
                                        name="server-address-updater",
                                        daemon=True)
        self._thread.start()

    def check_once(self) -> Dict[str, str]:
        """One pass; returns {group/server: new_ip} for every swap."""
        changed: Dict[str, str] = {}
        for g in list(self.groups()):
            for s in list(g.servers):
                if not s.host_name:
                    continue
                # swap only when the current IP left the record set —
                # multi-A round-robin answers must not flap the server
                ips = _resolve_all(s.host_name, ":" in s.ip)
                if ips and s.ip not in ips:
                    new_ip = ips[0]
                    try:
                        g.replace_ip(s.name, new_ip)
                        changed[f"{g.alias}/{s.name}"] = new_ip
                    except KeyError:
                        pass  # removed concurrently
        return changed

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            self.check_once()

    def close(self) -> None:
        self._stop.set()
