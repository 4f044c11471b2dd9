"""Fault-injection sites of the port (utils/failpoint): the cases of
tests/test_failpoint.py that no other port test holds (the site
catalogue is test_torch_host.py's, the seeded probability
test_torch_overload_adaptive.py's).

The arming gates, the active snapshot and the env bootstrap are host
logic: the same calls through vproxy_tpu and vproxy_tpu_torch give the
same answers. The wired connect sites and the command surface with its
GET /faults view run on the port's event loop and control plane, and
their listings are held to the reference's.

Every literal site handed to arm() is a real one: vlint's registry pass
reads this file's arm() calls (the unknown name is built at run time).
"""
import socket
import time

import pytest

from vproxy_tpu.utils import failpoint as RFP
from vproxy_tpu_torch.utils import failpoint as FP

from test_torch_control import http_get

PKGS = (RFP, FP)
UNKNOWN = ".".join(("definitely", "not", "a", "site"))


@pytest.fixture(autouse=True)
def _clean():
    for fp in PKGS:
        fp.clear()
    yield
    for fp in PKGS:
        fp.clear()


def test_unknown_site_rejected():
    for fp in PKGS:
        with pytest.raises(ValueError):
            fp.arm(UNKNOWN)
        with pytest.raises(ValueError):
            fp.arm("backend.connect.refuse", probability=0.0)
        with pytest.raises(ValueError):
            fp.arm("backend.connect.refuse", count=0)
        assert fp.active() == []


def test_hit_gates_count_and_match():
    seqs = []
    for fp in PKGS:
        fp.arm("backend.connect.refuse", count=2, match=":8080")
        seq = [fp.hit("backend.connect.refuse", ctx) for ctx in (
            "10.0.0.1:9090", "10.0.0.1:8080", "10.0.0.2:8080",
            "10.0.0.1:8080")]
        # count exhausted -> auto-disarm
        assert seq == [False, True, True, False]
        assert fp.active() == []
        seqs.append(seq)
    assert seqs[0] == seqs[1]


def test_active_snapshot_counts_hits():
    snaps = []
    for fp in PKGS:
        fp.arm("hc.force_down")
        fp.hit("hc.force_down", "g/s 1.2.3.4:80")
        fp.hit("hc.force_down", "g/s 1.2.3.4:80")
        (f,) = fp.active()
        assert f["name"] == "hc.force_down" and f["hits"] == 2
        snaps.append(f)
        assert fp.disarm("hc.force_down")
        assert not fp.disarm("hc.force_down")
    assert snaps[0] == snaps[1]


def test_env_bootstrap_spec(monkeypatch):
    monkeypatch.setenv(
        "VPROXY_TPU_FAILPOINTS",
        "backend.connect.refuse:0.5:3@:9999, pump.abort, bogus.site")
    armed = []
    for fp in PKGS:
        fp._bootstrap_env()
        names = {f["name"]: f for f in fp.active()}
        assert names["backend.connect.refuse"]["probability"] == 0.5
        assert names["backend.connect.refuse"]["count"] == 3
        assert names["backend.connect.refuse"]["match"] == ":9999"
        assert names["pump.abort"]["probability"] == 1.0
        assert "bogus.site" not in names  # skipped loudly, not fatal
        armed.append(sorted(fp.active(), key=lambda f: f["name"]))
    assert armed[0] == armed[1]


def test_connection_connect_refuse_and_hang():
    """The wired site in the port's net/connection.py: refuse raises
    ECONNREFUSED synchronously; hang never completes and never errors."""
    from vproxy_tpu_torch.net.connection import Connection, Handler
    from vproxy_tpu_torch.net.eventloop import SelectorEventLoop

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    port = srv.getsockname()[1]
    loop = SelectorEventLoop("fp-conn")
    loop.loop_thread()
    try:
        FP.arm("backend.connect.refuse", match=f":{port}")
        with pytest.raises(OSError):
            loop.call_sync(
                lambda: Connection.connect(loop, "127.0.0.1", port))
        # refuse disarmed only by count/clear; clear and arm hang
        FP.clear()
        FP.arm("backend.connect.hang", match=f":{port}")
        seen = []

        class H(Handler):
            def on_connected(self, conn):
                seen.append("connected")

            def on_closed(self, conn, err):
                seen.append("closed")

        def mk():
            c = Connection.connect(loop, "127.0.0.1", port)
            c.set_handler(H())
            return c

        conn = loop.call_sync(mk)
        time.sleep(0.3)
        assert seen == []  # neither connected nor errored: hung
        loop.call_sync(conn.close)
    finally:
        loop.close()
        srv.close()


def test_command_surface_and_faults_view():
    """add/remove fault + list fault + GET /faults on the port's
    inspection server all read the same registry; the listings are the
    reference's for the same commands."""
    from vproxy_tpu.control.app import Application as RApplication
    from vproxy_tpu.control.command import Command as RCommand
    from vproxy_tpu_torch.control.app import Application
    from vproxy_tpu_torch.control.command import CmdError, Command
    from vproxy_tpu_torch.net.eventloop import SelectorEventLoop
    from vproxy_tpu_torch.utils.metrics import launch_inspection_http

    add = ("add fault backend.connect.refuse probability 0.5 count 3 "
           "match :9090")
    ref = RApplication.create(workers=1)
    try:
        assert RCommand.execute(ref, add) == "OK"
        want = (RCommand.execute(ref, "list fault"),
                RCommand.execute(ref, "list-detail fault"))
        assert RCommand.execute(
            ref, "remove fault backend.connect.refuse") == "OK"
    finally:
        ref.close()

    app = Application.create(workers=1)
    try:
        assert Command.execute(app, add) == "OK"
        with pytest.raises(CmdError):
            Command.execute(app, "add fault not.a.site")
        assert Command.execute(app, "list fault") == \
            ["backend.connect.refuse"]
        detail = Command.execute(app, "list-detail fault")
        assert "probability 0.5" in detail[0] and "count 3" in detail[0]
        assert (Command.execute(app, "list fault"), detail) == want

        loop = SelectorEventLoop("fp-http")
        loop.loop_thread()
        time.sleep(0.05)
        srv = launch_inspection_http(loop, "127.0.0.1", 0)
        try:
            st, body = http_get(srv.port, "/faults")
            assert st == 200 and b"backend.connect.refuse" in body
        finally:
            srv.close()
            loop.close()

        assert Command.execute(
            app, "remove fault backend.connect.refuse") == "OK"
        with pytest.raises(CmdError):
            Command.execute(app, "remove fault backend.connect.refuse")
        assert Command.execute(app, "list fault") == []
    finally:
        app.close()
