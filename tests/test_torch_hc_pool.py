"""Health-check protocols (tcpDelay/dns/http) and the connection pool:
the 4 cases of tests/test_hc_pool.py, each run on both packages (`X`:
the reference's module names from either package). chaos rides them:
the port's components/servergroup.py health checks and
components/pool.py warm pool.

Reference analogs: ConnectClient.java protocol matrix (:166-290) via
loopback fake backends; pool/ConnectionPool.java warm/refill behavior.
"""
import socket
import threading
import time
from types import SimpleNamespace

import pytest

from test_torch_dns import IDS, PKGS, mod
from test_torch_tcplb import _torch_cpu  # noqa: F401


def pkg_ns(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(
        pkg=pkg, SG=mod(pkg, "components.servergroup"),
        EL=mod(pkg, "components.elgroup"), P=mod(pkg, "components.pool"),
        U=mod(pkg, "components.upstream"), C=mod(pkg, "net.connection"),
        EV=mod(pkg, "net.eventloop"), DNS=mod(pkg, "dns.server"))


@pytest.fixture(params=PKGS, ids=IDS)
def X(request):
    return pkg_ns(request.param)


def wait_for(cond, timeout=8.0):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout:
            raise TimeoutError()
        time.sleep(0.01)


@pytest.fixture
def elg(X):
    g = X.EL.EventLoopGroup("hc", 1)
    yield g
    g.close()


def _http_backend(status: int):
    """tiny blocking HTTP server answering every request with `status`."""
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(16)
    port = srv.getsockname()[1]
    stop = threading.Event()

    def run():
        srv.settimeout(0.2)
        while not stop.is_set():
            try:
                c, _ = srv.accept()
            except socket.timeout:
                continue
            try:
                c.settimeout(1.0)
                c.recv(4096)
                c.sendall(b"HTTP/1.1 %d X\r\nContent-Length: 0\r\n\r\n"
                          % status)
                c.close()
            except OSError:
                pass
        srv.close()
    threading.Thread(target=run, daemon=True).start()
    return port, stop


def _mk_group(X, elg, hc):
    return X.SG.ServerGroup("g", elg, hc, method="wrr")


def test_hc_http_status_classes(X, elg):
    port_ok, stop1 = _http_backend(204)
    port_bad, stop2 = _http_backend(503)
    hc = X.SG.HealthCheckConfig(timeout_ms=1000, period_ms=150, up=2, down=2,
                           protocol="http")
    g = _mk_group(X, elg, hc)
    g.add("ok", "127.0.0.1", port_ok, 10)
    g.add("bad", "127.0.0.1", port_bad, 10)
    try:
        wait_for(lambda: any(s.healthy for s in g.servers))
        time.sleep(1.0)  # several periods: 503 must never come up
        healthy = {s.name: s.healthy for s in g.servers}
        assert healthy == {"ok": True, "bad": False}
    finally:
        stop1.set()
        stop2.set()
        g.close()


def test_hc_tcp_delay_records_cost(X, elg):
    port, stop = _http_backend(200)
    hc = X.SG.HealthCheckConfig(timeout_ms=1000, period_ms=150, up=1, down=2,
                           protocol="tcpDelay")
    g = _mk_group(X, elg, hc)
    g.add("s", "127.0.0.1", port, 10)
    try:
        wait_for(lambda: g.servers[0].healthy)
        wait_for(lambda: g.servers[0].check_cost_ms >= 0)
        assert g.servers[0].check_cost_ms < 1000
    finally:
        stop.set()
        g.close()


def test_hc_dns_against_dns_backend(X, elg):
    loop = elg.next()
    dns = X.DNS.DNSServer("hc-dns", loop, "127.0.0.1", 0, X.U.Upstream("u"))
    dns.start()
    hc = X.SG.HealthCheckConfig(timeout_ms=1000, period_ms=150, up=2, down=2,
                           protocol="dns", dns_domain="whatever.example.com")
    g = _mk_group(X, elg, hc)
    g.add("dns", "127.0.0.1", dns.bind_port, 10)
    # a port with nothing listening never answers -> stays down
    g.add("dead", "127.0.0.1", 1, 10)
    try:
        wait_for(lambda: g.servers[0].healthy)
        assert not g.servers[1].healthy
    finally:
        dns.stop()
        g.close()


def test_connection_pool_warm_and_refill(X):
    loop = X.EV.SelectorEventLoop("pool")
    loop.loop_thread()
    port, stop = _http_backend(200)
    kept = []

    class H(X.P.PoolHandler):
        def connect(self, lp):
            return X.C.Connection.connect(lp, "127.0.0.1", port)

        def keepalive(self, conn):
            kept.append(conn)

    pool = X.P.ConnectionPool(loop, H(), capacity=3, keepalive_ms=200)
    try:
        wait_for(lambda: pool.count == 3)
        # hand one out: usable immediately, pool refills
        got = []

        def take():
            c = pool.get()
            assert c is not None

            class UH:
                def on_data(self, conn, data):
                    got.append(data)

                def on_eof(self, conn):
                    pass

                def on_closed(self, conn, err):
                    pass

                def on_drained(self, conn):
                    pass
            c.set_handler(UH())
            c.write(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
        loop.run_on_loop(take)
        wait_for(lambda: got)
        assert b"HTTP/1.1 200" in got[0]
        wait_for(lambda: pool.count == 3)  # refilled
        wait_for(lambda: kept)  # keepalive hook fires on idle conns
    finally:
        stop.set()
        pool.close()
        loop.close()
