"""First-match CIDR lookups: vswitch RouteTable (the first route in list
order whose network holds the address) and SecurityGroup (the first TCP
rule in order whose network holds the address and whose port range
holds the port, else the group's default).

"Holds" is vproxy's Network.maskMatch with its mixed-length cases, for
an address of L bytes against a network of R address bytes and M mask
bytes:
* L = R = 16, M = 4:  the first 4 bytes under the mask;
* L = 4, R = 16, M = 4: never;
* L = 4, R = 16, M = 16: the address under the mask's last 4 bytes, and
  the network's first 12 bytes are ::0.0 or ::ffff (v4-compatible or
  v4-mapped);
* otherwise the last min(L, R, M) bytes under the mask, and where
  L > R the address's first 12 bytes are ::0.0 or ::ffff.
Each case is evaluated over every network at once with NumPy.
"""
from __future__ import annotations

import numpy as np


def _u32(rows: np.ndarray) -> np.ndarray:
    return rows.astype(np.uint32) @ np.array([1 << 24, 1 << 16, 1 << 8, 1],
                                              np.uint32)


def _low_ok(first12: bytes) -> bool:
    return first12[:10] == bytes(10) and first12[10:12] in (b"\0\0",
                                                            b"\xff\xff")


class CidrReference:
    def __init__(self, nets: list, ranges: list | None = None):
        """nets: [(ip, mask)] in order; ranges: [(min_port, max_port)]
        per network for an ACL, None for routes (no port gate)."""
        n = len(nets)
        self.n = n
        rlen = np.array([len(ip) for ip, _m in nets])
        mlen = np.array([len(m) for _ip, m in nets])
        ip16 = np.zeros((n, 16), np.uint8)
        m16 = np.zeros((n, 16), np.uint8)
        for k, (ip, m) in enumerate(nets):
            ip16[k, :len(ip)] = np.frombuffer(ip, np.uint8)
            m16[k, :len(m)] = np.frombuffer(m, np.uint8)
        low = np.array([len(ip) == 16 and _low_ok(ip[:12]) for ip, _m in nets])
        self.v4 = rlen == 4                      # R = M = 4
        self.v6m4 = (rlen == 16) & (mlen == 4)   # R = 16, M = 4
        self.v6m16 = (rlen == 16) & (mlen == 16)
        self.v6m16_low = self.v6m16 & low
        # the four big-endian 4-byte words of each ip / mask
        self.ip_w = [_u32(ip16[:, 4 * k:4 * k + 4]) for k in range(4)]
        self.m_w = [_u32(m16[:, 4 * k:4 * k + 4]) for k in range(4)]
        if ranges is not None:
            self.lo = np.array([r[0] for r in ranges])
            self.hi = np.array([r[1] for r in ranges])
        else:
            self.lo = self.hi = None

    def holds(self, addr: bytes) -> np.ndarray:
        """bool [n]: which networks hold addr."""
        a = np.frombuffer(addr, np.uint8)
        if len(addr) == 4:
            w = int(_u32(a[None])[0])
            ok = self.v4 & ((w & self.m_w[0]) == self.ip_w[0])
            ok |= self.v6m16_low & ((w & self.m_w[3]) == self.ip_w[3])
            return ok
        ws = [int(_u32(a[None, 4 * k:4 * k + 4])[0]) for k in range(4)]
        ok = self.v6m4 & ((ws[0] & self.m_w[0]) == self.ip_w[0])
        full = self.v6m16.copy()
        for k in range(4):
            full &= (ws[k] & self.m_w[k]) == self.ip_w[k]
        ok |= full
        if _low_ok(addr[:12]):
            ok |= self.v4 & ((ws[3] & self.m_w[0]) == self.ip_w[0])
        return ok

    def first(self, addr: bytes, port=None, last: bool = False) -> int:
        """Index of the first network that holds addr (and, for an ACL
        with a port, whose range holds the port); -1 for none.
        last=True is the control: the last such network in list order
        instead of the stated first."""
        ok = self.holds(addr)
        if port is not None and self.lo is not None:
            ok &= (self.lo <= port) & (port <= self.hi)
        if not ok.any():
            return -1
        if last:
            return int(len(ok) - 1 - np.argmax(ok[::-1]))
        return int(np.argmax(ok))
