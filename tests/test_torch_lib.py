"""The port's HTTP/SOCKS5 client and connection transfer
(vproxy_tpu_torch/lib/vclient.py, lib/transfer.py) against the
reference's: the vclient, socks-client, transfer and pool cases of
tests/test_lib.py, each run on both packages (its vserver cases are in
test_torch_control.py), then a vclient of each package against the
other package's HttpServer, bodies and headers equal."""
import threading
import time

import numpy as np
import pytest

from test_torch_dns import IDS, PKGS, mod
from test_torch_tcplb import _torch_cpu, IdServer, wait_healthy  # noqa: F401


@pytest.fixture(params=PKGS, ids=IDS)
def pkg(request):
    return request.param


def new_loop(pkg, name="lib"):
    elg = mod(pkg, "components.elgroup").EventLoopGroup(name, 1)
    return elg, elg.next()


@pytest.fixture
def loop(pkg):
    elg, lp = new_loop(pkg)
    yield lp
    elg.close()


class Box(dict):
    """Callback results by key; get() waits for one with a deadline."""

    def __init__(self):
        super().__init__()
        self.cv = threading.Condition()

    def put(self, key, value):
        with self.cv:
            self[key] = value
            self.cv.notify_all()

    def wait(self, key, timeout=5.0):
        with self.cv:
            assert self.cv.wait_for(lambda: key in self, timeout), key
            return self[key]


def test_vclient_against_vserver(pkg, loop):
    VS, VC = mod(pkg, "lib.vserver"), mod(pkg, "lib.vclient")
    srv = VS.HttpServer(loop)
    srv.get("/ping", lambda r: r.resp.header("x-t", "1").end("pong"))
    srv.post("/sum", lambda r: r.resp.end(str(sum(r.req.json()["ns"]))))
    srv.listen(0)
    cli = VC.HttpClient(loop)
    box = Box()
    cli.get("127.0.0.1", srv.port, "/ping",
            lambda e, resp, conn: box.put("r1", (e, resp, conn)))
    e, resp, conn = box.wait("r1")
    assert e is None and resp.status == 200 and resp.body == b"pong"
    assert resp.header("x-t") == "1"
    # reuse the SAME connection for the next request (keep-alive)
    cli.post("127.0.0.1", srv.port, "/sum", b'{"ns": [1, 2, 3]}',
             lambda e2, r2, c2: box.put("r2", (e2, r2)), conn=conn)
    e2, r2 = box.wait("r2")
    assert e2 is None and r2.body == b"6"
    srv.close()


def test_socks_client_through_socks5_server(pkg, loop):
    SG = mod(pkg, "components.servergroup")
    Socks5Server = mod(pkg, "components.socks5").Socks5Server
    Upstream = mod(pkg, "components.upstream").Upstream
    Handler = mod(pkg, "net.connection").Handler
    backend = IdServer("SC")
    elg = mod(pkg, "components.elgroup").EventLoopGroup("s5", 1)
    try:
        g = SG.ServerGroup("g", elg, SG.HealthCheckConfig(500, 100, 1, 1))
        g.add("b", "127.0.0.1", backend.port)
        wait_healthy(g, 1)
        ups = Upstream("u")
        ups.add(g)
        s5 = Socks5Server("s5", elg, elg, "127.0.0.1", 0, ups,
                          allow_non_backend=True)
        s5.start()
        box = Box()
        sc = mod(pkg, "lib.vclient").SocksClient(loop, "127.0.0.1",
                                                 s5.bind_port)
        sc.connect("127.0.0.1", backend.port,
                   lambda e, ref: box.put("r", (e, ref)))
        e, ref = box.wait("r")
        assert e is None
        got = Box()
        got.put("data", b"")

        class H(Handler):
            def on_data(self, c, data):
                got.put("data", got["data"] + data)
                if got["data"] == b"SChi":
                    got.put("done", True)

        def attach():
            conn = ref.transfer(H())  # replays early backend bytes ("SC")
            conn.write(b"hi")
        loop.run_on_loop(attach)
        got.wait("done")
        assert got["data"] == b"SChi"  # id + echo
        s5.stop()
        g.close()
    finally:
        backend.close()
        elg.close()


def test_conn_transfer_and_pool(pkg, loop):
    """An HTTP client conn is parked in a pool and later transferred to a
    raw consumer (the WebSocks pattern: http conn -> raw proxied conn)."""
    VS, VC = mod(pkg, "lib.vserver"), mod(pkg, "lib.vclient")
    T = mod(pkg, "lib.transfer")
    srv = VS.HttpServer(loop)
    srv.get("/x", lambda r: r.resp.end("ok"))
    srv.listen(0)
    cli = VC.HttpClient(loop)
    box = Box()
    cli.get("127.0.0.1", srv.port, "/x",
            lambda e, resp, conn: box.put("r", (e, resp, conn)))
    e, resp, conn = box.wait("r")
    assert e is None and resp.body == b"ok"
    pool = T.ConnRefPool(loop, capacity=4)
    assert loop.call_sync(lambda: pool.put(conn)) is True
    assert pool.count() == 1
    got = loop.call_sync(pool.get)
    assert got is conn and pool.count() == 0
    # transferred conn still works as a raw keep-alive HTTP conn
    cli.get("127.0.0.1", srv.port, "/x",
            lambda e2, r2, c2: box.put("r2", (e2, r2)), conn=got)
    e2, r2 = box.wait("r2")
    assert e2 is None and r2.body == b"ok"
    srv.close()


def test_pool_drops_closed_idle_conns(pkg, loop):
    VS, VC = mod(pkg, "lib.vserver"), mod(pkg, "lib.vclient")
    T = mod(pkg, "lib.transfer")
    srv = VS.HttpServer(loop)
    srv.get("/x", lambda r: r.resp.end("ok"))
    srv.listen(0)
    cli = VC.HttpClient(loop)
    box = Box()
    cli.get("127.0.0.1", srv.port, "/x",
            lambda e, resp, conn: box.put("r", (e, resp, conn)))
    _, _, conn = box.wait("r")
    pool = T.ConnRefPool(loop, capacity=4)
    loop.call_sync(lambda: pool.put(conn))
    srv.close()  # server closes -> idle conn sees EOF -> dropped from pool
    deadline = time.monotonic() + 5  # no event marks the drop: poll
    while pool.count() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pool.count() == 0
    assert loop.call_sync(pool.get) is None


@pytest.mark.parametrize("client", PKGS, ids=["ref-client", "port-client"])
def test_vclient_across_packages(client):
    """One package's HttpClient against the other package's HttpServer:
    seeded bodies posted and echoed back equal, on one keep-alive
    connection."""
    server = PKGS[1 - PKGS.index(client)]
    elgs = []
    try:
        selg, sloop = new_loop(server, "srv")
        celg, cloop = new_loop(client, "cli")
        elgs += [selg, celg]
        srv = mod(server, "lib.vserver").HttpServer(sloop)
        srv.post("/echo", lambda r: r.resp.header("x-n", str(len(
            r.req.body))).end(r.req.body))
        srv.listen(0)
        cli = mod(client, "lib.vclient").HttpClient(cloop)
        rng = np.random.default_rng(12)
        conn = None
        for i in range(8):
            body = rng.integers(0, 256, int(rng.integers(0, 20000)),
                                dtype=np.uint8).tobytes()
            box = Box()
            cli.post("127.0.0.1", srv.port, "/echo", body,
                     lambda e, r, c: box.put("r", (e, r, c)), conn=conn)
            e, r, conn = box.wait("r")
            assert e is None and r.status == 200
            assert r.body == body and r.header("x-n") == str(len(body))
        srv.close()
    finally:
        for elg in elgs:
            elg.close()
