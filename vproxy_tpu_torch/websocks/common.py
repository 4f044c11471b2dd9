"""WebSocks wire protocol helpers (handshake, auth, frames).

The protocol (reference doc/websocks.md:1-160): WebSocket (RFC 6455)
upgrade carrying HTTP Basic auth with a minute-salted password hash,
then a fixed 10-byte "maximum payload length" binary-frame header from
each side, then plain SOCKS5 (RFC 1928) inside what the gateway
believes is one giant WebSocket frame. PONG (0x8a 0x00) keeps pooled
connections alive.

Server-side behavior parity: websocks/WebSocksProtocolHandler.java:540;
client side: WebSocksProxyAgentConnectorProvider.java:826.

The port's copy of vproxy_tpu/websocks/common.py, same names and behaviour.
"""
from __future__ import annotations

import base64
import hashlib
import os
import time
from typing import Optional

WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# FIN + binary opcode, no mask, 64-bit extended payload = 2^63-1
# (doc/websocks.md "WebSocket Maximum Payload Length Frame": signed
# bytes {130, 127, 127, -1, -1, -1, -1, -1, -1, -1})
MAX_PAYLOAD_FRAME = bytes([130, 127, 127] + [255] * 7)

# FIN + PONG opcode, no mask, zero payload (doc/websocks.md "PONG")
PONG_FRAME = bytes([0x8A, 0x00])


def accept_key(client_key: str) -> str:
    """RFC 6455 §1.3 Sec-WebSocket-Accept."""
    d = hashlib.sha1((client_key + WS_GUID).encode()).digest()
    return base64.b64encode(d).decode()


def _minute_now_ms() -> int:
    return int(time.time() * 1000) // 60_000 * 60_000


def password_hash(password: str, minute_ms: int) -> str:
    """base64(sha256(base64(sha256(pass)) + str(minute))) per the spec."""
    inner = base64.b64encode(hashlib.sha256(password.encode()).digest())
    outer = hashlib.sha256(inner + str(minute_ms).encode()).digest()
    return base64.b64encode(outer).decode()


def auth_header(user: str, password: str,
                minute_ms: Optional[int] = None) -> str:
    m = _minute_now_ms() if minute_ms is None else minute_ms
    tok = base64.b64encode(
        f"{user}:{password_hash(password, m)}".encode()).decode()
    return f"Basic {tok}"


def validate_auth(header: Optional[str], users: dict) -> Optional[str]:
    """-> authenticated username, or None. Accepts the +-1 minute skew
    windows the spec requires of servers."""
    if not header or not header.startswith("Basic "):
        return None
    try:
        dec = base64.b64decode(header[6:]).decode()
        user, _, got = dec.partition(":")
    except Exception:
        return None
    pwd = users.get(user)
    if pwd is None or not got:
        return None
    now = _minute_now_ms()
    for m in (now - 60_000, now, now + 60_000):
        if password_hash(pwd, m) == got:
            return user
    return None


def upgrade_request(host: str, user: str, password: str,
                    client_key: Optional[str] = None) -> bytes:
    if client_key is None:
        # RFC 6455 4.1: a randomly selected 16-byte nonce per connection
        # (a constant key would fingerprint the tunnel)
        client_key = base64.b64encode(os.urandom(16)).decode()
    return (f"GET / HTTP/1.1\r\n"
            f"Upgrade: websocket\r\n"
            f"Connection: Upgrade\r\n"
            f"Host: {host}\r\n"
            f"Sec-WebSocket-Key: {client_key}\r\n"
            f"Sec-WebSocket-Version: 13\r\n"
            f"Sec-WebSocket-Protocol: socks5\r\n"
            f"Authorization: {auth_header(user, password)}\r\n"
            f"\r\n").encode()


def upgrade_response(client_key: str) -> bytes:
    return (f"HTTP/1.1 101 Switching Protocols\r\n"
            f"Upgrade: websocket\r\n"
            f"Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept_key(client_key)}\r\n"
            f"Sec-WebSocket-Protocol: socks5\r\n"
            f"\r\n").encode()
