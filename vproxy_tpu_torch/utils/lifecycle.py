"""Process lifecycle state — the graceful-drain flag.

One process-global tri-state consulted by every surface that must agree
during shutdown:

* `/healthz` (utils/metrics inspection server AND the HttpController)
  flips from `ok` to `draining` with a 503 so upstream LBs steer away;
* TcpLB/Socks5 accept paths shed raced-in accepts once draining;
* main.py's SIGTERM path and the `drain` operator command both funnel
  through Application.request_drain(), which sets this.

Kept in utils (not control/) because the data plane and the metrics
surface must read it without importing the control plane.

The port's copy of vproxy_tpu/utils/lifecycle.py, same names and behaviour.
"""
from __future__ import annotations

import threading
import time

STATE_OK = "ok"
STATE_DRAINING = "draining"

_lock = threading.Lock()
_state = STATE_OK
_drain_started_mono: float = 0.0


def state() -> str:
    return _state


def is_draining() -> bool:
    return _state == STATE_DRAINING


def set_draining() -> bool:
    """Flip to draining; returns False if already draining (idempotent —
    SIGTERM and the `drain` command may race)."""
    global _state, _drain_started_mono
    with _lock:
        if _state == STATE_DRAINING:
            return False
        _state = STATE_DRAINING
        _drain_started_mono = time.monotonic()
    return True


def drain_age_s() -> float:
    """Seconds since drain started (0.0 when not draining)."""
    if not is_draining():
        return 0.0
    return time.monotonic() - _drain_started_mono


def reset() -> None:
    """Test hook: back to ok (a real process never un-drains)."""
    global _state, _drain_started_mono
    with _lock:
        _state = STATE_OK
        _drain_started_mono = 0.0
