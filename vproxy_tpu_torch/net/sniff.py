"""ClientHello SNI sniffer — parse without consuming.

The native TLS splice path (components/tcplb.py) must pick the
certificate AND classify the backend BEFORE the handshake runs in C, so
the accept loop MSG_PEEKs the socket (vtl.recv_peek) and this parser
extracts server_name from the raw ClientHello, leaving every byte
queued for the C-side SSL_do_handshake. Mirrors what the reference's
unwrap buffer learns from the handshake (SSLUnwrapRingBuffer.java:
174-186 -> SSLContextHolder.choose) — done ahead of time instead.

parse_client_hello_sni(buf) -> (sni | None, complete):
  complete=False  — not enough bytes yet (peek again after more arrive)
  complete=True   — verdict final: sni string, or None (no SNI
                    extension / not a parsable TLS ClientHello)

The port's copy of vproxy_tpu/net/sniff.py, same names and behaviour.
"""
from __future__ import annotations

from typing import Optional, Tuple

MAX_HELLO = 16384


def parse_client_hello_sni(buf: bytes) -> Tuple[Optional[str], bool]:
    if len(buf) < 5:
        return None, False
    if buf[0] != 0x16:          # not a TLS handshake record
        return None, True
    if buf[1] != 0x03:          # SSLv2/garbage
        return None, True
    rec_len = int.from_bytes(buf[3:5], "big")
    # the ClientHello may span records only in pathological cases; treat
    # the first record as the parse unit (openssl clients fit easily)
    body = buf[5:5 + rec_len]
    if len(body) < rec_len:
        return None, len(buf) >= MAX_HELLO
    if len(body) < 4 or body[0] != 0x01:   # handshake type ClientHello
        return None, True
    hs_len = int.from_bytes(body[1:4], "big")
    hello = body[4:4 + hs_len]
    if len(hello) < hs_len:
        return None, True      # record complete but hello spans records
    try:
        off = 2 + 32            # client_version + random
        sid_len = hello[off]
        off += 1 + sid_len
        cs_len = int.from_bytes(hello[off:off + 2], "big")
        off += 2 + cs_len
        comp_len = hello[off]
        off += 1 + comp_len
        if off + 2 > len(hello):
            return None, True   # no extensions block
        ext_total = int.from_bytes(hello[off:off + 2], "big")
        off += 2
        end = min(off + ext_total, len(hello))
        while off + 4 <= end:
            etype = int.from_bytes(hello[off:off + 2], "big")
            elen = int.from_bytes(hello[off + 2:off + 4], "big")
            off += 4
            if etype == 0:      # server_name
                ext = hello[off:off + elen]
                if len(ext) < 5:
                    return None, True
                # list_len(2) + type(1) + name_len(2) + name
                if ext[2] != 0:
                    return None, True
                nlen = int.from_bytes(ext[3:5], "big")
                name = ext[5:5 + nlen]
                try:
                    return name.decode("ascii"), True
                except UnicodeDecodeError:
                    return None, True
            off += elen
        return None, True       # parsed fine, no SNI sent
    except IndexError:
        return None, True
