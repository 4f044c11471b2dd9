"""The port's KCP and streamed sessions (vproxy_tpu_torch/net/kcp.py,
net/streamed.py) against the reference's: the 9 cases of
tests/test_udp_kcp.py, each run on both packages (the UDP virtual
accept and idle expiry, the pure Kcp machine over an in-memory wire:
clean, fragmented, seeded 30% loss, both ways, the oversize refusal;
streams over KCP over loopback UDP; the SYN parity rule), then the
cross-package checks, bytes equal: the datagrams both packages' Kcp
machines emit for the same numpy-seeded sends and losses, a port
KcpConn talking to a reference KcpConn over loopback UDP, and a port
StreamedSession talking to a reference one."""
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_dns import IDS, PKGS, mod

CONV = 0x76707478


def pkg_ns(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(
        pkg=pkg, EL=mod(pkg, "net.eventloop"), K=mod(pkg, "net.kcp"),
        S=mod(pkg, "net.streamed"), U=mod(pkg, "net.udp"))


@pytest.fixture(params=PKGS, ids=IDS)
def X(request):
    return pkg_ns(request.param)


@pytest.fixture
def loop(X):
    lp = X.EL.SelectorEventLoop("udptest")
    lp.loop_thread()
    yield lp
    lp.close()


def wait_for(cond, timeout=5.0, event=None):
    """Wait until cond() holds: on `event` when the callbacks set one,
    else on a short poll; raises TimeoutError at the deadline."""
    deadline = time.monotonic() + timeout
    while not cond():
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError()
        if event is not None:
            event.wait(min(left, 0.05))
            event.clear()
        else:
            time.sleep(0.005)


class Sink(list):
    """A list that sets an event on every append (callbacks append)."""

    def __init__(self):
        super().__init__()
        self.ev = threading.Event()

    def append(self, x):
        super().append(x)
        self.ev.set()


# --------------------------------------------------------------- udp


def test_udp_server_virtual_accept(X, loop):
    """two clients on one server socket -> two virtual conns, isolated."""
    accepted = []

    class H:
        def on_data(self, conn, data):
            conn.write(b"ack:" + data)

        def on_closed(self, conn, err):
            pass

    def on_accept(conn):
        accepted.append(conn)
        conn.set_handler(H())

    srv = X.U.UdpServer(loop, "127.0.0.1", 0, on_accept, idle_ms=60000)
    _, port = srv.local
    got1, got2 = Sink(), Sink()
    c1 = X.U.UdpSock(loop, on_packet=lambda d, ip, p: got1.append(d))
    c2 = X.U.UdpSock(loop, on_packet=lambda d, ip, p: got2.append(d))
    c1.send(b"one", "127.0.0.1", port)
    c2.send(b"two", "127.0.0.1", port)
    wait_for(lambda: got1 and got2)
    assert got1 == [b"ack:one"]
    assert got2 == [b"ack:two"]
    assert len(accepted) == 2
    c1.send(b"more", "127.0.0.1", port)  # same client: no new accept
    wait_for(lambda: len(got1) == 2, event=got1.ev)
    assert len(accepted) == 2
    c1.close()
    c2.close()
    srv.close()


def test_udp_server_idle_expiry(X, loop):
    closed = Sink()

    class H:
        def on_data(self, conn, data):
            pass

        def on_closed(self, conn, err):
            closed.append(conn.remote)

    srv = X.U.UdpServer(loop, "127.0.0.1", 0,
                        lambda c: c.set_handler(H()), idle_ms=200)
    _, port = srv.local
    c = X.U.UdpSock(loop)
    c.send(b"hi", "127.0.0.1", port)
    wait_for(lambda: closed, timeout=3.0, event=closed.ev)
    c.close()
    srv.close()


# --------------------------------------------------------------- kcp machine


def _pump(a, b, wire_ab, wire_ba, steps=2000, until=None, loss=0.0,
          rng=None):
    """drive two Kcp machines over in-memory wires with optional loss;
    rng: a random.Random or a numpy Generator (its .random())."""
    t = 0
    for _ in range(steps):
        t += 10
        a.update(t)
        b.update(t)
        for pkt in wire_ab[:]:
            wire_ab.remove(pkt)
            if rng is None or rng.random() >= loss:
                b.input(pkt)
        for pkt in wire_ba[:]:
            wire_ba.remove(pkt)
            if rng is None or rng.random() >= loss:
                a.input(pkt)
        if until is not None and until():
            return t
    if until is not None:
        raise AssertionError("condition not reached")
    return t


def _pair(K, wab=None, wba=None):
    wab = [] if wab is None else wab
    wba = [] if wba is None else wba
    a = K.Kcp(7, wab.append)
    b = K.Kcp(7, wba.append)
    for k in (a, b):
        k.set_nodelay(1, 10, 2, 1)
        k.set_wndsize(256, 256)
    return a, b, wab, wba


def _drain_all(b, got, n):
    def drain():
        while True:
            m = b.recv()
            if m is None:
                return len(got) == n
            got.append(m)
    return drain


def test_kcp_transfer_clean(X):
    a, b, wab, wba = _pair(X.K)
    msgs = [bytes([i]) * (100 + i * 37) for i in range(20)]
    for m in msgs:
        a.send(m)
    got = []
    _pump(a, b, wab, wba, until=_drain_all(b, got, len(msgs)))
    assert got == msgs


def test_kcp_fragmentation_large_message(X):
    a, b, wab, wba = _pair(X.K)
    big = bytes(range(256)) * 400  # ~100KB >> mss, many fragments
    a.send(big)
    got = []

    def drain():
        m = b.recv()
        if m is not None:
            got.append(m)
        return bool(got)
    _pump(a, b, wab, wba, steps=5000, until=drain)
    assert got[0] == big


def test_kcp_retransmit_under_loss(X):
    rng = random.Random(42)
    a, b, wab, wba = _pair(X.K)
    msgs = [b"m%03d" % i + bytes(200) for i in range(50)]
    for m in msgs:
        a.send(m)
    got = []
    _pump(a, b, wab, wba, steps=20000, until=_drain_all(b, got, len(msgs)),
          loss=0.3, rng=rng)
    assert got == msgs  # ordered, complete despite 30% loss


def test_kcp_bidirectional(X):
    a, b, wab, wba = _pair(X.K)
    a.send(b"ping")
    b.send(b"pong")
    got_a, got_b = [], []

    def drain():
        ma, mb = a.recv(), b.recv()
        if ma:
            got_a.append(ma)
        if mb:
            got_b.append(mb)
        return got_a and got_b
    _pump(a, b, wab, wba, until=drain)
    assert got_a == [b"pong"] and got_b == [b"ping"]


def test_kcp_send_rejects_oversize_message(X):
    a, _, _, _ = _pair(X.K)
    with pytest.raises(ValueError):
        a.send(bytes(a.mss * a.rcv_wnd + 1))


# --------------------------------------------------------------- kcp + udp + streamed


def test_streamed_session_over_udp(X, loop):
    """full stack: streams over KCP over real UDP loopback sockets."""
    state = {}
    server_echo = []

    class EchoStream(X.S.StreamHandler):
        def on_data(self, s, data):
            server_echo.append(data)
            s.write(b"echo:" + data)

        def on_eof(self, s):
            s.close_graceful()

    def on_udp_accept(vconn):
        kcp = X.K.KcpConn(loop, 1, vconn.write)
        sess = X.S.StreamedSession(
            loop, kcp, is_client=False,
            on_accept=lambda st: st.set_handler(EchoStream()))
        state["srv_sess"] = sess

        class VH:
            def on_data(self, c, data):
                kcp.feed(data)

            def on_closed(self, c, err):
                pass
        vconn.set_handler(VH())

    srv = X.U.UdpServer(loop, "127.0.0.1", 0, on_udp_accept, idle_ms=60000)
    _, port = srv.local
    csock = X.U.UdpSock(loop)
    ckcp = X.K.KcpConn(loop, 1, lambda d: csock.send(d, "127.0.0.1", port))
    csock.on_packet = lambda d, ip, p: ckcp.feed(d)
    up = threading.Event()
    csess = X.S.StreamedSession(loop, ckcp, is_client=True, on_up=up.set)
    assert up.wait(5)

    got1, got2 = Sink(), Sink()
    closed = Sink()

    class CH(X.S.StreamHandler):
        def __init__(self, sink):
            self.sink = sink

        def on_data(self, s, data):
            self.sink.append(data)

        def on_closed(self, s):
            closed.append(s.sid)

    s1 = csess.open_stream(CH(got1))
    s2 = csess.open_stream(CH(got2))
    s1.write(b"alpha")
    s2.write(b"beta")
    wait_for(lambda: got1 and got2)
    assert got1 == [b"echo:alpha"]
    assert got2 == [b"echo:beta"]
    assert set(server_echo) == {b"alpha", b"beta"}

    s1.close_graceful()  # graceful close round-trips FIN
    wait_for(lambda: s1.sid in closed, event=closed.ev)
    s2.write(b"gamma")  # s2 still usable
    wait_for(lambda: len(got2) == 2, event=got2.ev)
    assert got2[1] == b"echo:gamma"

    # large single write: chunked into many PSH frames, arrives intact
    big = bytes(range(256)) * 2048  # 512KB > KCP single-message limit
    nchunks = (len(big) + X.S.Stream.CHUNK - 1) // X.S.Stream.CHUNK
    s2.write(big)  # server echoes each PSH chunk with an "echo:" prefix
    wait_for(lambda: sum(len(d) for d in got2[2:]) ==
             len(big) + 5 * nchunks, timeout=30.0, event=got2.ev)
    assert b"".join(got2[2:]).replace(b"echo:", b"") == big
    csess.close()
    state["srv_sess"].close()
    csock.close()
    srv.close()


def test_streamed_syn_parity_rejected(X, loop):
    """a SYN with our own parity (or a dup sid) gets RST, not a clobber."""
    sent = []
    kcp = X.K.KcpConn(loop, 5, sent.append)
    sess = X.S.StreamedSession(loop, kcp, is_client=True)
    s = sess.open_stream()
    assert s.sid == 1
    # fake an incoming SYN for sid=3 (odd = client parity) from "peer"
    sess.on_message(kcp, X.S._HEAD.pack(3, X.S.F_SYN, 0))
    assert 3 not in sess.streams
    sess.on_message(kcp, X.S._HEAD.pack(1, X.S.F_SYN, 0))  # dup live sid
    assert sess.streams[1] is s
    sess.close()


# --------------------------------------------------------------- cross-package


def seeded_messages(seed: int, n: int, mss: int) -> list:
    """n messages of seeded lengths (1 byte to 5 mss: single segments
    and fragmented ones) and seeded contents."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(1, 5 * mss)),
                         dtype=np.uint8).tobytes() for _ in range(n)]


def wire_trace(pkg: str, seed: int) -> tuple:
    """Every datagram two of `pkg`'s Kcp machines emit, in order, for
    the seeded sends both ways over a wire that drops a seeded fifth,
    and what each side received."""
    K = mod(pkg, "net.kcp")
    trace = []
    wab, wba = [], []
    a = K.Kcp(CONV, lambda d: (trace.append(("ab", d)), wab.append(d)))
    b = K.Kcp(CONV, lambda d: (trace.append(("ba", d)), wba.append(d)))
    for k in (a, b):
        k.set_nodelay(1, 10, 2, 1)
        k.set_wndsize(128, 128)
    to_b = seeded_messages(seed, 40, a.mss)
    to_a = seeded_messages(seed + 1, 25, a.mss)
    for m in to_b:
        a.send(m)
    for m in to_a:
        b.send(m)
    got_a, got_b = [], []

    def done():
        for k, got in ((a, got_a), (b, got_b)):
            while (m := k.recv()) is not None:
                got.append(m)
        return len(got_a) == len(to_a) and len(got_b) == len(to_b)
    _pump(a, b, wab, wba, steps=20000, until=done, loss=0.2,
          rng=np.random.default_rng(seed + 2))
    assert got_b == to_b and got_a == to_a
    return trace, got_a, got_b


@pytest.mark.parametrize("seed", [3, 17])
def test_kcp_wire_bytes_equal_across_packages(seed):
    """The same seeded sends and losses through both packages' Kcp
    machines: every emitted datagram equal, byte for byte, in order
    (segment header, conv, windows, timestamps, retransmits)."""
    ref, port = (wire_trace(pkg, seed) for pkg in PKGS)
    assert len(port[0]) == len(ref[0]) > 100
    assert port[0] == ref[0]
    assert port[1:] == ref[1:]


@pytest.fixture
def loops():
    lps = {pkg: mod(pkg, "net.eventloop").SelectorEventLoop(f"x-{i}")
           for i, pkg in enumerate(PKGS)}
    for lp in lps.values():
        lp.loop_thread()
    yield lps
    for lp in lps.values():
        lp.close()


def udp_kcp(pkg, loop, handler=None):
    """A UdpSock on loopback with a KcpConn over it; .peer set later."""
    K, U = mod(pkg, "net.kcp"), mod(pkg, "net.udp")
    end = SimpleNamespace(peer=None)
    end.sock = U.UdpSock(loop, "127.0.0.1", 0)
    end.kcp = K.KcpConn(loop, CONV,
                        lambda d: end.sock.send(d, "127.0.0.1", end.peer),
                        handler)
    end.sock.on_packet = lambda d, ip, p: end.kcp.feed(d)
    return end


def test_port_kcpconn_talks_to_reference_kcpconn(loops):
    """A port KcpConn and a reference KcpConn over loopback UDP: seeded
    messages both ways (fragmented ones among them) arrive whole and in
    order."""
    got = {pkg: Sink() for pkg in PKGS}

    def handler(pkg):
        class H(mod(pkg, "net.kcp").KcpHandler):
            def on_message(self, conn, data):
                got[pkg].append(data)
        return H()
    ends = {pkg: udp_kcp(pkg, loops[pkg], handler(pkg)) for pkg in PKGS}
    ref, port = (ends[p] for p in PKGS)
    ref.peer, port.peer = port.sock.local[1], ref.sock.local[1]
    to_ref = seeded_messages(5, 60, 1376)
    to_port = seeded_messages(6, 60, 1376)
    for m in to_ref:
        port.kcp.send(m)
    for m in to_port:
        ref.kcp.send(m)
    wait_for(lambda: len(got[PKGS[0]]) == len(to_ref) and
             len(got[PKGS[1]]) == len(to_port), timeout=30)
    assert list(got[PKGS[0]]) == to_ref
    assert list(got[PKGS[1]]) == to_port
    for e in ends.values():
        e.kcp.close()
        e.sock.close()


@pytest.mark.parametrize("client", PKGS, ids=IDS)
def test_streamed_session_across_packages(loops, client):
    """One package's client StreamedSession opens 8 streams to the
    other package's server session over loopback UDP; each stream's
    seeded 100 KiB comes back echoed, byte for byte."""
    server = PKGS[1 - PKGS.index(client)]
    SS = mod(server, "net.streamed")
    SC = mod(client, "net.streamed")

    class Echo(SS.StreamHandler):
        def on_data(self, s, data):
            s.write(data)

    srv = udp_kcp(server, loops[server])
    cli = udp_kcp(client, loops[client])
    srv.peer, cli.peer = cli.sock.local[1], srv.sock.local[1]
    ssess = SS.StreamedSession(loops[server], srv.kcp, is_client=False,
                               on_accept=lambda st: st.set_handler(Echo()))
    up = threading.Event()
    csess = SC.StreamedSession(loops[client], cli.kcp, is_client=True,
                               on_up=up.set)
    assert up.wait(10)
    rng = np.random.default_rng(8)
    payloads = [rng.integers(0, 256, 100 * 1024, dtype=np.uint8).tobytes()
                for _ in range(8)]
    sinks = [Sink() for _ in payloads]

    class In(SC.StreamHandler):
        def __init__(self, sink):
            self.sink = sink

        def on_data(self, s, data):
            self.sink.append(data)

    for p, sink in zip(payloads, sinks):
        loops[client].run_on_loop(
            lambda p=p, sink=sink: csess.open_stream(In(sink)).write(p))
    wait_for(lambda: all(sum(map(len, s)) == len(p)
                         for s, p in zip(sinks, payloads)), timeout=60)
    assert [b"".join(s) for s in sinks] == payloads
    csess.close()
    ssess.close()
    for e in (srv, cli):
        e.sock.close()
