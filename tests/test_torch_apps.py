"""The port's deployable apps (vproxy_tpu_torch/apps/helloworld.py,
kcptun.py, daemon.py) against the reference's: the helloworld, kcptun
and daemon cases of tests/test_apps.py, each run on both packages (its
Simple-mode and ServerAddressUpdater cases are in test_torch_control.py),
a kcptun client of one package through the other package's kcptun
server, bytes equal, and chip_smoke.py's `apps` phase small on the CPU.
The entry cases (`python -m vproxy_tpu_torch <app>`) are in
test_torch_control.py."""
import socket
import threading

import pytest

from test_torch_dns import IDS, PKGS, mod


@pytest.fixture(params=PKGS, ids=IDS)
def pkg(request):
    return request.param


def echo_id_backend(tag: bytes):
    """A backend that answers its first data with its id, then closes."""
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(16)

    def run():
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return
            try:
                c.recv(4096)
                c.sendall(tag)
                c.close()
            except OSError:
                pass
    threading.Thread(target=run, daemon=True).start()
    return srv, srv.getsockname()[1]


def new_loop(pkg, name):
    lp = mod(pkg, "net.eventloop").SelectorEventLoop(name)
    lp.loop_thread()
    return lp


def test_helloworld_tcp_udp_echo(pkg):
    H = mod(pkg, "apps.helloworld")
    loop = new_loop(pkg, "hwtest")
    try:
        tcp, udp, port = H.start(loop, 0)
        c = socket.create_connection(("127.0.0.1", port), timeout=3)
        c.sendall(b"ping")
        assert c.recv(256).startswith(H.GREETING)
        c.close()
        u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        u.settimeout(3)
        u.sendto(b"uping", ("127.0.0.1", port))
        data, _ = u.recvfrom(256)
        assert data == H.GREETING + b"uping"
        u.close()
    finally:
        loop.close()


def up_event(cli):
    """An event set once the TunClient's session is up."""
    ev = threading.Event()

    def poll():
        if cli.sess is not None and cli.sess.up:
            ev.set()
        else:
            cli.loop.delay(5, poll)
    cli.loop.run_on_loop(poll)
    return ev


def kcptun_once(client_pkg, server_pkg, payload: bytes) -> bytes:
    """client TCP -> one package's tunnel client -> KCP -> the other
    package's tunnel server -> an id backend: its answer."""
    tgt, tport = echo_id_backend(b"target-hit")
    loops = {p: new_loop(p, f"kcptun-{i}")
             for i, p in enumerate({client_pkg, server_pkg})}
    try:
        usrv = mod(server_pkg, "apps.kcptun").run_server(
            loops[server_pkg], 0, "127.0.0.1", tport)
        cli = mod(client_pkg, "apps.kcptun").TunClient(
            loops[client_pkg], 0, "127.0.0.1", usrv.local[1],
            bind_ip="127.0.0.1")
        assert up_event(cli).wait(8)
        c = socket.create_connection(("127.0.0.1", cli.port), timeout=5)
        c.sendall(payload)
        c.settimeout(5)
        got = c.recv(64)
        c.close()
        cli.close()
        usrv.close()
        return got
    finally:
        for lp in loops.values():
            lp.close()
        tgt.close()


def test_kcptun_end_to_end(pkg):
    """client TCP -> kcp tunnel -> server -> target echo backend."""
    assert kcptun_once(pkg, pkg, b"hello-tunnel") == b"target-hit"


@pytest.mark.parametrize("client", PKGS, ids=["ref-client", "port-client"])
def test_kcptun_across_packages(client):
    """A kcptun client of one package through the other package's
    server: the same CONV, KCP segments and stream frames."""
    server = PKGS[1 - PKGS.index(client)]
    assert mod(client, "apps.kcptun").CONV == mod(server, "apps.kcptun").CONV
    assert kcptun_once(client, server, b"x-tunnel") == b"target-hit"


def test_daemon_restart_and_reload_logic(pkg, monkeypatch):
    """drive Daemon._do_reload/crash-restart with a stub child process."""
    D = mod(pkg, "apps.daemon")

    class FakeProc:
        n = 0

        def __init__(self):
            FakeProc.n += 1
            self.pid = 1000 + FakeProc.n
            self._rc = None
            self.signals = []

        def poll(self):
            return self._rc

        def send_signal(self, sig):
            self.signals.append(sig)
            self._rc = 0

        def wait(self, timeout=None):
            return self._rc

        def kill(self):
            self._rc = -9

    d = D.Daemon([])
    monkeypatch.setattr(d, "_spawn", lambda: FakeProc())
    monkeypatch.setattr(D, "RELOAD_GRACE_S", 0.1)
    d.child = d._spawn()
    first = d.child
    d._do_reload()
    assert d.child is not first          # new child took over
    assert first.signals                 # old child got SIGTERM
    assert first.poll() is not None


def test_daemon_spawns_its_own_package(pkg, monkeypatch):
    """Each package's daemon supervises a child of its own package."""
    D = mod(pkg, "apps.daemon")
    seen = []
    monkeypatch.setattr(D.subprocess, "Popen", seen.append)
    D.Daemon(["noLoadLast"])._spawn()
    assert seen[0][1:] == ["-m", pkg, "noStdIOController", "noLoadLast"]


def test_chip_smoke_apps_phase_on_cpu():
    """chip_smoke.py's `apps` phase small on the CPU: helloworld and a
    kcptun pair as `python -m vproxy_tpu_torch` children, 8 streams of
    seeded 32 KiB through one KCP session, every byte echoed; each
    child exits 0 on SIGTERM."""
    import chip_smoke as CS
    out = CS.phase_apps(streams=8, stream_bytes=32 * 1024)
    assert out["kcptun"]["streams"] == 8
    assert out["kcptun"]["bytes_echoed"] == 8 * 32 * 1024
    assert out["kcptun"]["mb_s"] > 0
    assert out["helloworld"]["tcp"] and out["helloworld"]["udp"]
    assert out["exit_codes"] == {"helloworld": 0, "kcptun server": 0,
                                 "kcptun client": 0}
