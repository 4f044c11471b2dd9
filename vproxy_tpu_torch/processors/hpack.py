"""HPACK (RFC 7541) header compression for the h2 processor.

Functional analog of the reference's vendored twitter hpack
(com/twitter/hpack/Decoder.java, Encoder.java). The constant tables
below are the RFC 7541 appendices verbatim: Appendix A static table,
Appendix B Huffman codes.

The port's copy of vproxy_tpu/processors/hpack.py, same names and behaviour.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

# ---------------------------------------------------------------- constants

# RFC 7541 Appendix A — indices 1..61
STATIC_TABLE: list[tuple[bytes, bytes]] = [(n.encode(), v.encode()) for n, v in [
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""),
    ("expires", ""), ("from", ""), ("host", ""), ("if-match", ""),
    ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""),
    ("location", ""), ("max-forwards", ""), ("proxy-authenticate", ""),
    ("proxy-authorization", ""), ("range", ""), ("referer", ""),
    ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
    ("via", ""), ("www-authenticate", ""),
]]

# RFC 7541 Appendix B — Huffman code for each of 256 byte values + EOS
HUFFMAN_CODES = [
    8184, 8388568, 268435426, 268435427, 268435428, 268435429, 268435430,
    268435431, 268435432, 16777194, 1073741820, 268435433, 268435434,
    1073741821, 268435435, 268435436, 268435437, 268435438, 268435439,
    268435440, 268435441, 268435442, 1073741822, 268435443, 268435444,
    268435445, 268435446, 268435447, 268435448, 268435449, 268435450,
    268435451, 20, 1016, 1017, 4090, 8185, 21, 248, 2042, 1018, 1019, 249,
    2043, 250, 22, 23, 24, 0, 1, 2, 25, 26, 27, 28, 29, 30, 31, 92, 251,
    32764, 32, 4091, 1020, 8186, 33, 93, 94, 95, 96, 97, 98, 99, 100, 101,
    102, 103, 104, 105, 106, 107, 108, 109, 110, 111, 112, 113, 114, 252,
    115, 253, 8187, 524272, 8188, 16380, 34, 32765, 3, 35, 4, 36, 5, 37, 38,
    39, 6, 116, 117, 40, 41, 42, 7, 43, 118, 44, 8, 9, 45, 119, 120, 121,
    122, 123, 32766, 2044, 16381, 8189, 268435452, 1048550, 4194258, 1048551,
    1048552, 4194259, 4194260, 4194261, 8388569, 4194262, 8388570, 8388571,
    8388572, 8388573, 8388574, 16777195, 8388575, 16777196, 16777197,
    4194263, 8388576, 16777198, 8388577, 8388578, 8388579, 8388580, 2097116,
    4194264, 8388581, 4194265, 8388582, 8388583, 16777199, 4194266, 2097117,
    1048553, 4194267, 4194268, 8388584, 8388585, 2097118, 8388586, 4194269,
    4194270, 16777200, 2097119, 4194271, 8388587, 8388588, 2097120, 2097121,
    4194272, 2097122, 8388589, 4194273, 8388590, 8388591, 1048554, 4194274,
    4194275, 4194276, 8388592, 4194277, 4194278, 8388593, 67108832,
    67108833, 1048555, 524273, 4194279, 8388594, 4194280, 33554412,
    67108834, 67108835, 67108836, 134217694, 134217695, 67108837, 16777201,
    33554413, 524274, 2097123, 67108838, 134217696, 134217697, 67108839,
    134217698, 16777202, 2097124, 2097125, 67108840, 67108841, 268435453,
    134217699, 134217700, 134217701, 1048556, 16777203, 1048557, 2097126,
    4194281, 2097127, 2097128, 8388595, 4194282, 4194283, 33554414,
    33554415, 16777204, 16777205, 67108842, 8388596, 67108843, 134217702,
    67108844, 67108845, 134217703, 134217704, 134217705, 134217706,
    134217707, 268435454, 134217708, 134217709, 134217710, 134217711,
    134217712, 67108846, 1073741823,
]
HUFFMAN_LENGTHS = [
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28, 28, 28,
    28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28, 6, 10, 10, 12,
    13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6,
    7, 8, 15, 6, 12, 10, 13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6, 15, 5, 6, 5, 6, 5,
    6, 6, 6, 5, 7, 7, 6, 6, 6, 5, 6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11,
    14, 13, 28, 20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24,
    23, 24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24, 22,
    21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23, 21, 21, 22,
    21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23, 26, 26, 20, 19, 22,
    23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25, 19, 21, 26, 27, 27, 26, 27,
    24, 21, 21, 26, 26, 28, 27, 27, 27, 20, 24, 20, 21, 22, 21, 21, 23, 22,
    22, 25, 25, 24, 24, 26, 23, 26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27,
    27, 27, 27, 27, 26, 30,
]

ENTRY_OVERHEAD = 32  # RFC 7541 §4.1
DEFAULT_TABLE_SIZE = 4096


class HpackError(Exception):
    pass


# ---------------------------------------------------------------- huffman

def _build_decode_tree():
    root: list = [None, None]
    for sym, (code, ln) in enumerate(zip(HUFFMAN_CODES, HUFFMAN_LENGTHS)):
        node = root
        for i in range(ln - 1, -1, -1):
            bit = (code >> i) & 1
            if i == 0:
                node[bit] = sym
            else:
                if node[bit] is None:
                    node[bit] = [None, None]
                node = node[bit]
    return root


_DECODE_TREE = _build_decode_tree()
EOS = 256


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    node = _DECODE_TREE
    # track bits consumed since last symbol for the padding validity check
    pad_bits = 0
    for byte in data:
        for i in range(7, -1, -1):
            bit = (byte >> i) & 1
            nxt = node[bit]
            if nxt is None:
                raise HpackError("bad huffman code")
            if isinstance(nxt, int):
                if nxt == EOS:
                    raise HpackError("EOS in huffman data")
                out.append(nxt)
                node = _DECODE_TREE
                pad_bits = 0
            else:
                node = nxt
                pad_bits += 1
    if pad_bits > 7:
        raise HpackError("huffman padding too long")
    # remaining bits must be the EOS prefix (all ones)
    return bytes(out)


def huffman_encode(data: bytes) -> bytes:
    cur = 0
    nbits = 0
    out = bytearray()
    for b in data:
        cur = (cur << HUFFMAN_LENGTHS[b]) | HUFFMAN_CODES[b]
        nbits += HUFFMAN_LENGTHS[b]
        while nbits >= 8:
            nbits -= 8
            out.append((cur >> nbits) & 0xFF)
    if nbits:
        out.append(((cur << (8 - nbits)) | ((1 << (8 - nbits)) - 1)) & 0xFF)
    return bytes(out)


def huffman_len(data: bytes) -> int:
    return (sum(HUFFMAN_LENGTHS[b] for b in data) + 7) // 8


# ---------------------------------------------------------------- integers

def encode_int(value: int, prefix_bits: int, first_byte: int = 0) -> bytes:
    """RFC 7541 §5.1 prefix-coded integer; first_byte carries the pattern
    bits above the prefix."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([first_byte | value])
    out = bytearray([first_byte | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(data: bytes, pos: int, prefix_bits: int) -> tuple[int, int]:
    limit = (1 << prefix_bits) - 1
    if pos >= len(data):
        raise HpackError("truncated integer")
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if shift > 35:
            raise HpackError("integer too large")
        if not b & 0x80:
            return value, pos


# ---------------------------------------------------------------- tables

class _DynamicTable:
    def __init__(self, max_size: int):
        self.max_size = max_size
        self.size = 0
        self.entries: deque[tuple[bytes, bytes]] = deque()

    def add(self, name: bytes, value: bytes) -> None:
        sz = len(name) + len(value) + ENTRY_OVERHEAD
        if sz > self.max_size:
            self.entries.clear()
            self.size = 0
            return
        while self.size + sz > self.max_size:
            en, ev = self.entries.pop()
            self.size -= len(en) + len(ev) + ENTRY_OVERHEAD
        self.entries.appendleft((name, value))
        self.size += sz

    def resize(self, max_size: int) -> None:
        self.max_size = max_size
        while self.size > max_size:
            en, ev = self.entries.pop()
            self.size -= len(en) + len(ev) + ENTRY_OVERHEAD

    def get(self, i: int) -> tuple[bytes, bytes]:  # 0-based
        if i >= len(self.entries):
            raise HpackError(f"dynamic index {i} out of range")
        return self.entries[i]


def _lookup(table: _DynamicTable, index: int) -> tuple[bytes, bytes]:
    if index <= 0:
        raise HpackError("index 0")
    if index <= len(STATIC_TABLE):
        return STATIC_TABLE[index - 1]
    return table.get(index - len(STATIC_TABLE) - 1)


# ---------------------------------------------------------------- decoder

class Decoder:
    def __init__(self, max_table_size: int = DEFAULT_TABLE_SIZE):
        self.table = _DynamicTable(max_table_size)
        self.protocol_max = max_table_size

    def set_protocol_max(self, n: int) -> None:
        """SETTINGS_HEADER_TABLE_SIZE we advertised (upper bound for
        dynamic-table-size updates from the peer)."""
        self.protocol_max = n
        if self.table.max_size > n:
            self.table.resize(n)

    def _read_string(self, data: bytes, pos: int) -> tuple[bytes, int]:
        if pos >= len(data):
            raise HpackError("truncated string")
        huff = bool(data[pos] & 0x80)
        ln, pos = decode_int(data, pos, 7)
        if pos + ln > len(data):
            raise HpackError("truncated string data")
        raw = data[pos:pos + ln]
        pos += ln
        return (huffman_decode(raw) if huff else raw), pos

    def decode(self, data: bytes) -> list[tuple[bytes, bytes]]:
        out: list[tuple[bytes, bytes]] = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # indexed
                idx, pos = decode_int(data, pos, 7)
                out.append(_lookup(self.table, idx))
            elif b & 0x40:  # literal with incremental indexing
                idx, pos = decode_int(data, pos, 6)
                name = _lookup(self.table, idx)[0] if idx else None
                if name is None:
                    name, pos = self._read_string(data, pos)
                value, pos = self._read_string(data, pos)
                self.table.add(name, value)
                out.append((name, value))
            elif b & 0x20:  # dynamic table size update
                sz, pos = decode_int(data, pos, 5)
                if sz > self.protocol_max:
                    raise HpackError("table size update beyond settings")
                self.table.resize(sz)
            else:  # literal without indexing / never indexed
                idx, pos = decode_int(data, pos, 4)
                name = _lookup(self.table, idx)[0] if idx else None
                if name is None:
                    name, pos = self._read_string(data, pos)
                value, pos = self._read_string(data, pos)
                out.append((name, value))
        return out


# ---------------------------------------------------------------- encoder

_STATIC_FULL = {e: i + 1 for i, e in reversed(list(enumerate(STATIC_TABLE)))}
_STATIC_NAME = {}
for _i, (_n, _v) in reversed(list(enumerate(STATIC_TABLE))):
    _STATIC_NAME[_n] = _i + 1


class Encoder:
    def __init__(self, max_table_size: int = DEFAULT_TABLE_SIZE):
        self.table = _DynamicTable(max_table_size)

    def _write_string(self, out: bytearray, s: bytes) -> None:
        hl = huffman_len(s)
        if hl < len(s):
            out += encode_int(hl, 7, 0x80)
            out += huffman_encode(s)
        else:
            out += encode_int(len(s), 7, 0)
            out += s

    def encode(self, headers: list[tuple[bytes, bytes]],
               sensitive: Optional[set[bytes]] = None) -> bytes:
        out = bytearray()
        for name, value in headers:
            if sensitive and name in sensitive:
                # never-indexed literal
                idx = _STATIC_NAME.get(name, 0)
                out += encode_int(idx, 4, 0x10)
                if not idx:
                    self._write_string(out, name)
                self._write_string(out, value)
                continue
            full = _STATIC_FULL.get((name, value))
            if full is None:
                for j, e in enumerate(self.table.entries):
                    if e == (name, value):
                        full = len(STATIC_TABLE) + j + 1
                        break
            if full is not None:
                out += encode_int(full, 7, 0x80)
                continue
            idx = _STATIC_NAME.get(name, 0)
            if not idx:
                for j, e in enumerate(self.table.entries):
                    if e[0] == name:
                        idx = len(STATIC_TABLE) + j + 1
                        break
            # literal with incremental indexing
            out += encode_int(idx, 6, 0x40)
            if not idx:
                self._write_string(out, name)
            self._write_string(out, value)
            self.table.add(name, value)
        return bytes(out)
