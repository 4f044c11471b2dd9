"""Daemon — supervisor for crash-restart and zero-downtime reload.

Parity: reference `vproxyx/Daemon.java:15-70`: forks a child running
the real app, watches its health, restarts it if it dies; SIGUSR2
launches a NEW child first (binds overlap via SO_REUSEPORT /
noStartupBindCheck), then stops the old one once the new one is up —
zero-downtime config reload.

The port's copy of vproxy_tpu/apps/daemon.py, same names and behaviour.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional

CHECK_INTERVAL_S = 1.0
RESTART_DELAY_S = 1.0
RELOAD_GRACE_S = 5.0


class Daemon:
    def __init__(self, child_args: List[str]):
        self.child_args = child_args
        self.child: Optional[subprocess.Popen] = None
        self.stopping = False
        self.reload_requested = False
        self._lock = threading.Lock()

    def _spawn(self) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "vproxy_tpu_torch",
               "noStdIOController"] + self.child_args
        return subprocess.Popen(cmd)

    def request_reload(self, *_a) -> None:
        self.reload_requested = True

    def request_stop(self, *_a) -> None:
        self.stopping = True

    def _do_reload(self) -> None:
        """new child first, old child second (reuseport overlap)."""
        old = self.child
        new = self._spawn()
        t0 = time.time()
        while time.time() - t0 < RELOAD_GRACE_S:
            if new.poll() is not None:  # new child died: keep the old
                print("daemon: reload failed, new child exited "
                      f"{new.returncode}; keeping old", file=sys.stderr)
                return
            time.sleep(0.2)
        self.child = new
        if old is not None and old.poll() is None:
            old.send_signal(signal.SIGTERM)
            try:
                old.wait(timeout=10)
            except subprocess.TimeoutExpired:
                old.kill()
        print("daemon: reloaded", file=sys.stderr)

    def run(self) -> int:
        signal.signal(signal.SIGTERM, self.request_stop)
        signal.signal(signal.SIGINT, self.request_stop)
        if hasattr(signal, "SIGUSR2"):
            signal.signal(signal.SIGUSR2, self.request_reload)
        self.child = self._spawn()
        print(f"daemon: child pid {self.child.pid}", file=sys.stderr)
        while not self.stopping:
            time.sleep(CHECK_INTERVAL_S)
            if self.reload_requested:
                self.reload_requested = False
                self._do_reload()
                continue
            if self.child.poll() is not None:
                print(f"daemon: child exited {self.child.returncode}, "
                      "restarting", file=sys.stderr)
                time.sleep(RESTART_DELAY_S)
                if not self.stopping:
                    self.child = self._spawn()
        if self.child is not None and self.child.poll() is None:
            self.child.send_signal(signal.SIGTERM)
            try:
                self.child.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.child.kill()
        return 0


def run(argv: List[str]) -> int:
    return Daemon(argv).run()
