"""The port's L7 processors (vproxy_tpu_torch/processors) behind its
TcpLB: the cases of tests/test_processors.py on the port's modules,
the matchers on the CPU."""
import socket
import struct
import threading
import time

import pytest

from vproxy_tpu_torch.components.servergroup import ServerGroup
from vproxy_tpu_torch.components.tcplb import TcpLB
from vproxy_tpu_torch.components.upstream import Upstream
from vproxy_tpu_torch.processors import hpack
from vproxy_tpu_torch.processors.h2 import (
    DATA, F_ACK, F_END_HEADERS, F_END_STREAM, FRAME_HEAD, GOAWAY, HEADERS,
    PING, PREFACE, RST_STREAM, SETTINGS, WINDOW_UPDATE, frame,
)
from vproxy_tpu_torch.rules.ir import HintRule

from test_torch_tcplb import _torch_cpu, IdServer, fast_hc, stack, wait_healthy  # noqa: F401


# ------------------------------------------------------------------- hpack

def test_hpack_rfc7541_huffman_example():
    # RFC 7541 C.4.1: "www.example.com" huffman-encodes to f1e3c2e5f23a6ba0ab90f4ff
    enc = hpack.huffman_encode(b"www.example.com")
    assert enc.hex() == "f1e3c2e5f23a6ba0ab90f4ff"
    assert hpack.huffman_decode(enc) == b"www.example.com"


def test_hpack_roundtrip_with_dynamic_table():
    e = hpack.Encoder()
    d = hpack.Decoder()
    h1 = [(b":method", b"GET"), (b":path", b"/x/y?z=1"),
          (b":authority", b"svc.example.com"), (b"x-custom", b"v" * 100)]
    h2 = [(b":method", b"GET"), (b":path", b"/other"),
          (b":authority", b"svc.example.com"), (b"x-custom", b"v" * 100)]
    assert d.decode(e.encode(h1)) == h1
    block2 = e.encode(h2)
    assert d.decode(block2) == h2
    # repeated fields must hit the encoder's dynamic table (much smaller)
    assert len(block2) < 40


def test_hpack_decoder_rejects_oversized_table_update():
    d = hpack.Decoder(max_table_size=4096)
    with pytest.raises(hpack.HpackError):
        d.decode(hpack.encode_int(100000, 5, 0x20))


def test_hpack_static_only_encoder_decodes_everywhere():
    from vproxy_tpu_torch.processors.h2 import _StaticEncoder
    e = _StaticEncoder()
    d = hpack.Decoder()
    hs = [(b":status", b"200"), (b"content-type", b"text/plain"),
          (b"x-id", b"abc")]
    assert d.decode(e.encode(hs)) == hs
    assert len(e.table.entries) == 0


# -------------------------------------------------------------- h2 helpers

class H2TestEnd:
    """Tiny blocking h2 endpoint used by both the test client and the test
    backend server."""

    def __init__(self, sock, server: bool):
        self.sock = sock
        self.server = server
        self.buf = b""
        self.enc = hpack.Encoder()
        self.dec = hpack.Decoder()

    def read_frame(self):
        while True:
            if len(self.buf) >= FRAME_HEAD:
                ln = int.from_bytes(self.buf[:3], "big")
                if len(self.buf) >= FRAME_HEAD + ln:
                    ftype, flags = self.buf[3], self.buf[4]
                    sid = int.from_bytes(self.buf[5:9], "big") & 0x7FFFFFFF
                    payload = self.buf[FRAME_HEAD:FRAME_HEAD + ln]
                    self.buf = self.buf[FRAME_HEAD + ln:]
                    return ftype, flags, sid, payload
            d = self.sock.recv(65536)
            if not d:
                raise ConnectionError("eof")
            self.buf += d

    def expect_preface(self):
        while len(self.buf) < len(PREFACE):
            d = self.sock.recv(65536)
            if not d:
                raise ConnectionError("eof in preface")
            self.buf += d
        assert self.buf[:len(PREFACE)] == PREFACE
        self.buf = self.buf[len(PREFACE):]

    def handshake(self):
        if self.server:
            self.expect_preface()
            self.sock.sendall(frame(SETTINGS, 0, 0))
        else:
            self.sock.sendall(PREFACE + frame(SETTINGS, 0, 0))
        # read peer SETTINGS, ack it; wait for our ack
        acked = got = False
        while not (acked and got):
            ftype, flags, sid, payload = self.read_frame()
            if ftype == SETTINGS and not flags & F_ACK:
                self.sock.sendall(frame(SETTINGS, F_ACK, 0))
                got = True
            elif ftype == SETTINGS and flags & F_ACK:
                acked = True

    def send_headers(self, sid, headers, end=False):
        flags = F_END_HEADERS | (F_END_STREAM if end else 0)
        self.sock.sendall(frame(HEADERS, flags, sid, self.enc.encode(headers)))

    def send_data(self, sid, data, end=False):
        self.sock.sendall(frame(DATA, F_END_STREAM if end else 0, sid, data))


class H2IdServer:
    """h2 backend: responds to every stream with x-id header + DATA body
    '<id>:<echoed request body>'."""

    def __init__(self, sid: str):
        self.sid = sid
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self.alive = True
        self.streams_served = 0
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while self.alive:
            try:
                c, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._conn, args=(c,), daemon=True).start()

    def _conn(self, c):
        try:
            end = H2TestEnd(c, server=True)
            end.expect_preface()
            c.sendall(frame(SETTINGS, 0, 0))
            bodies = {}
            while True:
                ftype, flags, sid, payload = end.read_frame()
                if ftype == SETTINGS and not flags & F_ACK:
                    c.sendall(frame(SETTINGS, F_ACK, 0))
                elif ftype == PING and not flags & F_ACK:
                    c.sendall(frame(PING, F_ACK, 0, payload))
                elif ftype == HEADERS:
                    end.dec.decode(payload)  # keep hpack state in sync
                    bodies[sid] = b""
                    if flags & F_END_STREAM:
                        self._respond(end, sid, bodies.pop(sid))
                elif ftype == DATA:
                    bodies[sid] = bodies.get(sid, b"") + payload
                    if flags & F_END_STREAM:
                        self._respond(end, sid, bodies.pop(sid))
                elif ftype == GOAWAY:
                    return
        except (ConnectionError, OSError, AssertionError):
            pass
        finally:
            c.close()

    def _respond(self, end, sid, body):
        self.streams_served += 1
        resp = self.sid.encode() + b":" + body
        end.send_headers(sid, [(b":status", b"200"),
                               (b"x-id", self.sid.encode())])
        end.send_data(sid, resp, end=True)

    def close(self):
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass


def h2_request(port, authority, path="/", body=None, end=None, sid=1):
    own = end is None
    if own:
        c = socket.create_connection(("127.0.0.1", port), timeout=5)
        c.settimeout(5)
        end = H2TestEnd(c, server=False)
        end.handshake()
    hs = [(b":method", b"POST" if body else b"GET"), (b":scheme", b"http"),
          (b":path", path.encode()), (b":authority", authority.encode())]
    end.send_headers(sid, hs, end=body is None)
    if body is not None:
        end.send_data(sid, body, end=True)
    resp_headers = None
    data = b""
    while True:
        ftype, flags, fsid, payload = end.read_frame()
        if fsid != sid:
            continue
        if ftype == HEADERS:
            resp_headers = end.dec.decode(payload)
            if flags & F_END_STREAM:
                break
        elif ftype == DATA:
            data += payload
            if flags & F_END_STREAM:
                break
        elif ftype == RST_STREAM:
            raise ConnectionError(f"rst {payload.hex()}")
    if own:
        end.sock.close()
    return resp_headers, data


# ----------------------------------------------------------------- h2 e2e

def _mk_lb(stack, protocol, groups_spec):
    """groups_spec: list of (server, HintRule|None)."""
    elg = stack["make_elg"](1)
    ups = Upstream("u")
    for i, (srv, rule) in enumerate(groups_spec):
        g = ServerGroup(f"g{i}", elg, fast_hc())
        stack["groups"].append(g)
        g.add("s", "127.0.0.1", srv.port)
        wait_healthy(g, 1)
        ups.add(g, annotations=rule)
    lb = TcpLB("lb", elg, elg, "127.0.0.1", 0, ups, protocol=protocol)
    stack["lbs"].append(lb)
    lb.start()
    return lb


def test_h2_routes_streams_by_authority(stack):
    sa, sb = H2IdServer("A"), H2IdServer("B")
    stack["servers"] += [sa, sb]
    lb = _mk_lb(stack, "h2", [
        (sa, HintRule(host="a.example.com")),
        (sb, HintRule(host="b.example.com")),
    ])
    c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c.settimeout(5)
    end = H2TestEnd(c, server=False)
    end.handshake()
    # two streams on ONE client connection -> two different backends
    h, d = h2_request(lb.bind_port, "a.example.com", end=end, sid=1)
    assert d == b"A:" and (b"x-id", b"A") in h
    h, d = h2_request(lb.bind_port, "b.example.com", end=end, sid=3)
    assert d == b"B:" and (b"x-id", b"B") in h
    # POST body relays through DATA frames
    h, d = h2_request(lb.bind_port, "a.example.com", body=b"hello-h2",
                      end=end, sid=5)
    assert d == b"A:hello-h2"
    c.close()
    assert sa.streams_served == 2 and sb.streams_served == 1


def test_h2_via_general_http_sniff(stack):
    sa = H2IdServer("A")
    stack["servers"].append(sa)
    lb = _mk_lb(stack, "http", [(sa, None)])
    h, d = h2_request(lb.bind_port, "whatever.com")
    assert d == b"A:"


def test_h2_ping_and_window_update_stay_local(stack):
    sa = H2IdServer("A")
    stack["servers"].append(sa)
    lb = _mk_lb(stack, "h2", [(sa, None)])
    c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c.settimeout(5)
    end = H2TestEnd(c, server=False)
    end.handshake()
    c.sendall(frame(PING, 0, 0, b"12345678"))
    ftype, flags, sid, payload = end.read_frame()
    assert ftype == PING and flags & F_ACK and payload == b"12345678"
    c.close()


# ---------------------------------------------------------------- http1

def test_http1_per_request_routing_on_keepalive(stack):
    sa = IdServer("GA", http=True)
    sb = IdServer("GB", http=True)
    stack["servers"] += [sa, sb]
    lb = _mk_lb(stack, "http1", [
        (sa, HintRule(host="a.example.com")),
        (sb, HintRule(host="b.example.com")),
    ])
    # TWO requests with different Hosts on ONE kept-alive client connection
    c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c.settimeout(5)

    def req(host):
        c.sendall(b"GET / HTTP/1.1\r\nhost: %s\r\n\r\n" % host)
        data = b""
        while b"\r\n\r\n" not in data:
            data += c.recv(65536)
        head, _, rest = data.partition(b"\r\n\r\n")
        cl = 0
        for line in head.split(b"\r\n"):
            if line.lower().startswith(b"content-length"):
                cl = int(line.split(b":")[1])
        while len(rest) < cl:
            rest += c.recv(65536)
        return rest[:cl]

    assert req(b"a.example.com") == b"GA"
    assert req(b"b.example.com") == b"GB"  # same front conn, other backend
    assert req(b"a.example.com") == b"GA"
    c.close()


def test_http1_post_body_chunked(stack):
    class EchoHttp:
        def __init__(self):
            self.sock = socket.socket()
            self.sock.bind(("127.0.0.1", 0))
            self.sock.listen(16)
            self.port = self.sock.getsockname()[1]
            self.alive = True
            threading.Thread(target=self._serve, daemon=True).start()

        def _serve(self):
            while self.alive:
                try:
                    c, _ = self.sock.accept()
                except OSError:
                    return
                threading.Thread(target=self._conn, args=(c,),
                                 daemon=True).start()

        def _conn(self, c):
            try:
                data = b""
                while b"0\r\n\r\n" not in data:
                    d = c.recv(65536)
                    if not d:
                        break
                    data += d
                _, _, body = data.partition(b"\r\n\r\n")
                # de-chunk
                out = b""
                while body:
                    ln, _, body = body.partition(b"\r\n")
                    n = int(ln.split(b";")[0], 16)
                    if n == 0:
                        break
                    out += body[:n]
                    body = body[n + 2:]
                c.sendall(b"HTTP/1.1 200 OK\r\ncontent-length: %d\r\n"
                          b"connection: close\r\n\r\n%s" % (len(out), out))
                c.close()
            except OSError:
                pass

        def close(self):
            self.alive = False
            try:
                self.sock.close()
            except OSError:
                pass

    srv = EchoHttp()
    stack["servers"].append(srv)
    lb = _mk_lb(stack, "http1", [(srv, None)])
    c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c.settimeout(5)
    c.sendall(b"POST / HTTP/1.1\r\nhost: x\r\ntransfer-encoding: chunked\r\n"
              b"connection: close\r\n\r\n")
    c.sendall(b"5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n")
    data = b""
    while True:
        d = c.recv(65536)
        if not d:
            break
        data += d
    assert data.endswith(b"hello world")
    c.close()


# ---------------------------------------------------------------- framed

class FramedEchoServer:
    """int32-length-framed echo: replies each frame with id + payload."""

    def __init__(self, sid: str):
        self.sid = sid.encode()
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self.alive = True
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while self.alive:
            try:
                c, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._conn, args=(c,), daemon=True).start()

    def _conn(self, c):
        try:
            buf = b""
            while True:
                d = c.recv(65536)
                if not d:
                    break
                buf += d
                while len(buf) >= 4:
                    n = struct.unpack(">I", buf[:4])[0]
                    if len(buf) < 4 + n:
                        break
                    payload = buf[4:4 + n]
                    buf = buf[4 + n:]
                    resp = self.sid + b":" + payload
                    c.sendall(struct.pack(">I", len(resp)) + resp)
            c.close()
        except OSError:
            pass

    def close(self):
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass


def test_framed_int32_relay(stack):
    srv = FramedEchoServer("F")
    stack["servers"].append(srv)
    lb = _mk_lb(stack, "framed-int32", [(srv, None)])
    c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c.settimeout(5)

    def send_frame(payload):
        c.sendall(struct.pack(">I", len(payload)) + payload)

    def read_frame():
        data = c.recv(4)
        while len(data) < 4:
            data += c.recv(4 - len(data))
        n = struct.unpack(">I", data)[0]
        out = b""
        while len(out) < n:
            out += c.recv(n - len(out))
        return out

    send_frame(b"one")
    assert read_frame() == b"F:one"
    # split a frame across writes: boundary tracking must hold
    c.sendall(struct.pack(">I", 3) + b"t")
    time.sleep(0.05)
    c.sendall(b"wo")
    assert read_frame() == b"F:two"
    c.close()


def test_dubbo_framing(stack):
    class DubboEcho(FramedEchoServer):
        def _conn(self, c):
            try:
                buf = b""
                while True:
                    d = c.recv(65536)
                    if not d:
                        break
                    buf += d
                    while len(buf) >= 16:
                        n = struct.unpack(">I", buf[12:16])[0]
                        if len(buf) < 16 + n:
                            break
                        head, payload = buf[:16], buf[16:16 + n]
                        buf = buf[16 + n:]
                        resp = self.sid + b":" + payload
                        c.sendall(head[:12] + struct.pack(">I", len(resp)) + resp)
                c.close()
            except OSError:
                pass

    srv = DubboEcho("D")
    stack["servers"].append(srv)
    lb = _mk_lb(stack, "dubbo", [(srv, None)])
    c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c.settimeout(5)
    head = b"\xda\xbb\xc2\x00" + struct.pack(">Q", 42)
    payload = b"invoke-me"
    c.sendall(head + struct.pack(">I", len(payload)) + payload)
    data = b""
    while len(data) < 16 + 11:
        d = c.recv(65536)
        if not d:
            break
        data += d
    n = struct.unpack(">I", data[12:16])[0]
    assert data[16:16 + n] == b"D:invoke-me"
    c.close()


def test_processor_registry_equals_reference():
    """base._ensure_defaults registers framed, h2 and http1 (http1
    upgrades to h2), so a partial port would list other names: both
    packages list the same processors."""
    from vproxy_tpu.processors import base as ref_base
    from vproxy_tpu_torch.processors import base
    assert base.names() == ref_base.names()
    assert {"http", "http1", "h2", "framed-int32", "dubbo"} <= set(
        base.names())
