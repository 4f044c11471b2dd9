"""The port's control plane and process entry against the reference's,
the matchers on the CPU.

* ported reference cases, each run on both packages (`pkg`):
  tests/test_control.py (3), test_controllers.py (2), test_resp_matrix.py
  (2, over every creatable resource type, the switch's and the docker
  plugin's among them; no type refuses as not ported),
  test_control_extras.py's inventory, resolver/dns-cache,
  controller-resource, timeout/persist and socks5-update cases (its
  switch cases are in test_torch_vswitch.py),
  test_tls.py::test_tls_command_grammar,
  test_drain_overload.py::test_healthz_flips_to_draining, test_apps.py's
  two Simple-mode cases and its ServerAddressUpdater case, and
  test_lib.py's three vserver cases;
* one command script through both packages' Command.execute: the
  outputs are equal but for the tokens MASKED names (the serving
  backend and fused tier in `list-detail upstream`);
* a config saved by either package loads in the other with equal
  `list-detail` output and an equal re-saved config;
* one scrape of the port's and the reference's inspection server (in a
  fresh interpreter, after the same config) lists the same families,
  and the routes answer alike;
* the process entry: `python -m vproxy_tpu_torch` with
  VPROXY_TPU_TORCH_DEVICE=cpu hosting a tcp-lb, a socks5-server, a
  dns-server, a switch and both controllers from a config file, serving
  each once, then saving its config on SIGTERM (tests/test_boot_all.py);
  without a GPU and without the host asked for, it exits non-zero, an
  app named or not; each deployable app (helloworld, kcptun, websocks,
  daemon) boots through it and serves;
  VPROXY_TPU_MATCHER=jax-dense boots it on the dense backend, and the
  command script over its resp-controller answers what the reference's
  does; jax-sharded and jax-fp-sharded boot it on the sharded backends,
  and VPROXY_TPU_CLUSTER_PEERS boots a cluster node in it.
"""
import json
import os
import pathlib
import re
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from test_torch_dns import IDS, PKGS, mod
from test_torch_tcplb import (_torch_cpu, IdServer, http_get_id,  # noqa: F401
                              wait_healthy)
from test_torch_tls import _tls_get, certs  # noqa: F401

REPO = str(pathlib.Path(__file__).resolve().parents[1])
PORT = "vproxy_tpu_torch"


@pytest.fixture(params=PKGS, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def app(pkg):
    a = mod(pkg, "control.app").Application.create(workers=1)
    yield a
    a.close()


def run(app, line):
    return Command(app).execute(app, line)


def Command(app):
    """The Command class of the package `app` comes from."""
    return mod(type(app).__module__.split(".")[0], "control.command").Command


def CmdError(pkg):
    return mod(pkg, "control.command").CmdError


def free_port(kind=socket.SOCK_STREAM) -> int:
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ------------------------------------------------ tests/test_control.py

def test_command_crud_and_traffic(pkg, app, tmp_path):
    persist = mod(pkg, "control.persist")
    s1, s2 = IdServer("A", http=True), IdServer("B", http=True)
    try:
        run(app, "add upstream ups0")
        run(app, "add server-group sg0 timeout 500 period 100 up 1 down 1 "
                 "method wrr")
        run(app, f"add server svr0 to server-group sg0 address "
                 f"127.0.0.1:{s1.port} weight 10")
        run(app, "add server-group sg1 timeout 500 period 100 up 1 down 1")
        run(app, f"add server svr0 to server-group sg1 address "
                 f"127.0.0.1:{s2.port} weight 10")
        run(app, 'add server-group sg0 to upstream ups0 weight 10 annotations '
                 '{"vproxy/hint-host":"a.example.com"}')
        run(app, 'add server-group sg1 to upstream ups0 weight 10 annotations '
                 '{"vproxy/hint-host":"b.example.com"}')
        assert run(app, "list server-group") == ["sg0", "sg1"]
        assert run(app, "list server-group in upstream ups0") == ["sg0", "sg1"]
        assert run(app, "l ups") == ["ups0"]
        detail = run(app, "list-detail server in server-group sg0")
        assert "connect-to 127.0.0.1" in detail[0]

        wait_healthy(app.server_groups["sg0"], 1)
        wait_healthy(app.server_groups["sg1"], 1)
        run(app, "add tcp-lb lb0 address 127.0.0.1:0 upstream ups0 "
                 "protocol http")
        port = app.tcp_lbs["lb0"].bind_port
        assert http_get_id(port, "a.example.com")[1] == "A"
        assert http_get_id(port, "b.example.com")[1] == "B"
        assert int(run(app, "list accepted-conn-count in tcp-lb lb0")[0]) >= 2

        run(app, "u sg sg0 method wlc")
        assert app.server_groups["sg0"].method == "wlc"
        run(app, "update server-group sg0 in upstream ups0 weight 5")
        with pytest.raises(CmdError(pkg)):
            run(app, "remove upstream ups0")
        with pytest.raises(CmdError(pkg)):
            run(app, "remove server-group sg0")

        cfg = persist.current_config(app)
        assert "add tcp-lb lb0" in cfg and "vproxy/hint-host" in cfg
        p = tmp_path / "cfg"
        persist.save(app, str(p))
        run(app, "remove tcp-lb lb0")
        run(app, "remove server-group sg0 from upstream ups0")
        run(app, "remove server-group sg1 from upstream ups0")
        run(app, "force-remove upstream ups0")
        run(app, "force-remove server-group sg0")
        run(app, "force-remove server-group sg1")
        assert run(app, "list tcp-lb") == []

        assert persist.load(app, str(p)) >= 8
        wait_healthy(app.server_groups["sg0"], 1)
        assert http_get_id(app.tcp_lbs["lb0"].bind_port,
                           "a.example.com")[1] == "A"
    finally:
        s1.close()
        s2.close()


def test_command_errors(pkg, app):
    err = CmdError(pkg)
    for line in ("bogus tcp-lb x", "add tcp-lb",
                 "add tcp-lb lb0 address 127.0.0.1:0 upstream nope",
                 "add server svr0 to server-group missing address 1.2.3.4:80",
                 "add security-group s default maybe"):
        with pytest.raises(err):
            run(app, line)
    run(app, "add security-group secg0 default deny")
    with pytest.raises(err):
        run(app, "add security-group secg0 default allow")  # dup
    run(app, "add security-group-rule r0 to security-group secg0 "
             "network 10.0.0.0/8 protocol tcp port-range 1,1024 default allow")
    out = run(app, "list-detail security-group-rule in security-group secg0")
    assert "10.0.0.0/8" in out[0]


def test_event_loop_management(pkg, app):
    run(app, "add event-loop-group elg0")
    run(app, "add event-loop el0 to event-loop-group elg0")
    run(app, "add event-loop el1 to event-loop-group elg0")
    assert run(app, "list event-loop in event-loop-group elg0") == \
        ["el0", "el1"]
    run(app, "remove event-loop el0 from event-loop-group elg0")
    assert run(app, "list event-loop in event-loop-group elg0") == ["el1"]
    with pytest.raises(CmdError(pkg)):
        run(app, "remove event-loop-group (worker-elg)")
    run(app, "remove event-loop-group elg0")


# -------------------------------------------- tests/test_controllers.py

class RespClient:
    """Minimal redis-protocol client speaking to the resp-controller."""

    def __init__(self, port, password=None):
        self.s = socket.create_connection(("127.0.0.1", port), timeout=5)
        self.s.settimeout(5)
        self.buf = b""
        if password is not None:
            assert self.cmd("AUTH", password) == "OK"

    def close(self):
        self.s.close()

    def cmd(self, *parts):
        enc = f"*{len(parts)}\r\n".encode()
        for p in parts:
            b = str(p).encode()
            enc += f"${len(b)}\r\n".encode() + b + b"\r\n"
        self.s.sendall(enc)
        return self._read()

    def _line(self):
        while b"\r\n" not in self.buf:
            d = self.s.recv(65536)
            if not d:
                raise OSError("closed")
            self.buf += d
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def _take(self, n):
        while len(self.buf) < n + 2:
            d = self.s.recv(65536)
            if not d:
                raise OSError("closed")
            self.buf += d
        out, self.buf = self.buf[:n], self.buf[n + 2:]
        return out

    def _read(self):
        line = self._line()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise RuntimeError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            return None if n < 0 else self._take(n).decode()
        if t == b"*":
            n = int(rest)
            return None if n < 0 else [self._read() for _ in range(n)]
        raise AssertionError(f"bad RESP type {line!r}")


def test_resp_controller_full_flow(pkg, app):
    RESPController = mod(pkg, "control.resp").RESPController
    ctl = RESPController(app, "127.0.0.1", 0, password="sekret")
    ctl.start()
    backend = IdServer("R1", http=True)
    try:
        cli = RespClient(ctl.bind_port)
        assert cli.cmd("ping") == "PONG"
        with pytest.raises(RuntimeError, match="NOAUTH"):
            cli.cmd("list", "upstream")
        assert cli.cmd("auth", "sekret") == "OK"
        assert cli.cmd("add", "upstream", "ups0") == "OK"
        assert cli.cmd("add", "server-group", "sg0", "timeout", "500",
                       "period", "100", "up", "1", "down", "1") == "OK"
        assert cli.cmd("add", "server", "s1", "to", "server-group", "sg0",
                       "address", f"127.0.0.1:{backend.port}") == "OK"
        assert cli.cmd("add", "server-group", "sg0", "to", "upstream",
                       "ups0", "weight", "10") == "OK"
        wait_healthy(app.server_groups["sg0"], 1)
        assert cli.cmd("add", "tcp-lb", "lb0", "address", "127.0.0.1:0",
                       "upstream", "ups0", "protocol", "http") == "OK"
        assert http_get_id(app.tcp_lbs["lb0"].bind_port, "x.io")[1] == "R1"
        assert cli.cmd("list", "tcp-lb") == ["lb0"]
        detail = cli.cmd("list-detail", "server", "in", "server-group", "sg0")
        assert "currently UP" in detail[0]
        with pytest.raises(RuntimeError, match="not found"):
            cli.cmd("remove", "tcp-lb", "nope")
        cli.close()
    finally:
        backend.close()
        ctl.stop()


def http_req(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def test_http_controller_crud(pkg, app):
    HttpController = mod(pkg, "control.http_controller").HttpController
    ctl = HttpController(app, "127.0.0.1", 0)
    ctl.start()
    backend = IdServer("H1", http=True)
    try:
        p = ctl.bind_port
        assert http_req(p, "GET", "/healthz")[0] == 200
        st, r = http_req(p, "POST", "/api/v1/module/upstream",
                         {"name": "ups0"})
        assert st == 200 and r["result"] == "OK"
        assert http_req(p, "POST", "/api/v1/module/server-group",
                        {"name": "sg0", "timeout": 500, "period": 100,
                         "up": 1, "down": 1})[0] == 200
        assert http_req(p, "POST", "/api/v1/module/server-group/sg0/server",
                        {"name": "s1",
                         "address": f"127.0.0.1:{backend.port}"})[0] == 200
        assert http_req(p, "POST", "/api/v1/command", {
            "command": "add server-group sg0 to upstream ups0 weight 10"
        })[0] == 200
        wait_healthy(app.server_groups["sg0"], 1)
        assert http_req(p, "POST", "/api/v1/module/tcp-lb",
                        {"name": "lb0", "address": "127.0.0.1:0",
                         "upstream": "ups0", "protocol": "http"})[0] == 200
        assert http_get_id(app.tcp_lbs["lb0"].bind_port, "y.io")[1] == "H1"
        st, r = http_req(p, "GET", "/api/v1/module/tcp-lb")
        assert st == 200 and any(d["name"] == "lb0" for d in r)
        st, r = http_req(p, "GET", "/api/v1/module/tcp-lb/lb0")
        assert st == 200 and r["backend"] == "ups0" \
            and r["protocol"] == "http"
        st, r = http_req(p, "GET", "/api/v1/module/server-group/sg0/server")
        assert st == 200 and r[0]["name"] == "s1" \
            and r[0]["currentlyUp"] is True
        assert http_req(p, "DELETE", "/api/v1/module/tcp-lb/lb0")[0] == 200
        assert app.tcp_lbs == {}
        assert http_req(p, "GET", "/api/v1/module/nope")[0] == 404
        st, r = http_req(p, "POST", "/api/v1/module/tcp-lb",
                         {"name": "bad", "address": "127.0.0.1:0",
                          "upstream": "missing"})
        assert st == 400 and "not found" in r["error"]
    finally:
        backend.close()
        ctl.stop()


# -------------------------------------------- tests/test_resp_matrix.py

# the reference's matrix rows (tests/test_resp_matrix.py) over the
# resource types the port serves: (add, detail substring, update,
# remove), in dependency order
MATRIX = [
    ("add fault pump.abort probability 0.5 count 3", "probability 0.5",
     None, "remove fault pump.abort"),
    ("add policy pol0 dim=clients rate=50 burst=100 action=monitor",
     "dim clients", None, "remove policy pol0"),
    ("add event-loop-group elg0", None, None,
     "remove event-loop-group elg0"),
    ("add event-loop el0 to event-loop-group elg0", None, None,
     "remove event-loop el0 from event-loop-group elg0"),
    ("add upstream ups0", None, None, "remove upstream ups0"),
    ("add server-group sg0 timeout 500 period 200 up 1 down 3 method wrr "
     "event-loop-group elg0", "wrr",
     "update server-group sg0 timeout 800 period 400 up 2 down 2",
     "remove server-group sg0"),
    ("add server svr0 to server-group sg0 address 127.0.0.1:19999 "
     "weight 5", "127.0.0.1:19999",
     "update server svr0 in server-group sg0 weight 8",
     "remove server svr0 from server-group sg0"),
    ("add server-group sg0 to upstream ups0 weight 7", "sg0",
     "update server-group sg0 in upstream ups0 weight 9",
     "remove server-group sg0 from upstream ups0"),
    ("add security-group secg0 default allow", "allow",
     "update security-group secg0 default deny",
     "remove security-group secg0"),
    ("add security-group-rule r0 to security-group secg0 network "
     "10.0.0.0/8 protocol TCP port-range 1,1024 default allow", "10.0.0.0",
     None, "remove security-group-rule r0 from security-group secg0"),
    ("add cert-key ck0 cert {CERT} key {KEY}", None, None,
     "remove cert-key ck0"),
    ("add tcp-lb lb0 address 127.0.0.1:0 upstream ups0 timeout 4000",
     "ups0", "update tcp-lb lb0 timeout 9000", "remove tcp-lb lb0"),
    ("add socks5-server s5 address 127.0.0.1:0 upstream ups0", "ups0",
     "update socks5-server s5 timeout 9000", "remove socks5-server s5"),
    ("add dns-server dns0 address 127.0.0.1:0 upstream ups0 ttl 5",
     "ups0", "update dns-server dns0 ttl 9", "remove dns-server dns0"),
    ("add switch sw0 address 127.0.0.1:0", "127.0.0.1", None,
     "remove switch sw0"),
    ("add vpc 7 to switch sw0 v4network 172.16.0.0/16", "172.16",
     None, "remove vpc 7 from switch sw0"),
    ("add ip 172.16.0.21 to vpc 7 in switch sw0", "172.16.0.21", None,
     "remove ip 172.16.0.21 from vpc 7 in switch sw0"),
    ("add route rt0 to vpc 7 in switch sw0 network 172.17.0.0/16 vni 7",
     "172.17", None, "remove route rt0 from vpc 7 in switch sw0"),
    ("add user u001 to switch sw0 password pw1 vni 7", None, None,
     "remove user u001 from switch sw0"),
    ("add user-client uc1 to switch sw0 password pw1 vni 7 address "
     "127.0.0.1:18472", None, None,
     "remove user-client uc1 from switch sw0"),
    # the remote-switch link, listed as an iface
    ("add switch rsw0 to switch sw0 address 127.0.0.1:18473",
     None, None, "remove switch rsw0 from switch sw0"),
    ("add docker-network-plugin-controller dk0 path {SOCK}", "path",
     None, "remove docker-network-plugin-controller dk0"),
]

# queried/virtual or attach-only resources, and the controllers (their
# own cases below): the reference matrix's list.
# cluster-node needs a booted cluster plane (VPROXY_TPU_CLUSTER_PEERS),
# which this clusterless matrix app does not have: its verbs are
# exercised in tests/test_torch_cluster.py and by
# test_entry_boots_a_cluster_node
UNCREATABLE = {
    "server-sock", "session", "connection", "bytes-in", "bytes-out",
    "accepted-conn-count", "dns-cache", "resolver", "proxy", "iface",
    "arp", "tap", "resp-controller", "http-controller", "event-log",
    "trace", "analytics", "cluster-node",
}


@pytest.fixture
def resp(pkg, tmp_path, certs):  # noqa: F811
    app = mod(pkg, "control.app").Application.create(workers=1)
    Command(app).execute(app, "add resp-controller ctl address 127.0.0.1:0 "
                              "password p@ss")
    c = RespClient(app.resp_controllers["ctl"].bind_port, password="p@ss")
    yield app, c, tmp_path, certs["a"]
    c.close()
    app.close()
    mod(pkg, "policing.engine").default().set_policies([])


def test_resp_crud_matrix(pkg, resp):
    """Every row: create -> visible in list + list-detail -> update ->
    still consistent; save the world; teardown in reverse, each visibly
    gone; replay the saved command log into a fresh app."""
    pytest.importorskip("cryptography")  # the cert-key row needs it
    app, c, tmp, (cert, key) = resp
    created = []
    for add, detail_sub, update, remove in MATRIX:
        add = add.replace("{CERT}", cert).replace("{KEY}", key).replace(
            "{SOCK}", os.path.join(str(tmp), "docker", "plugin.sock"))
        assert c.cmd(*add.split()) == "OK", add
        rtype, alias = add.split()[1:3]
        ctx = add.split(" to ", 1)[1] if " to " in add else None
        suffix = f" in {ctx}" if ctx else ""
        if rtype == "switch" and ctx:  # remote link: listed as an iface
            rtype, alias = "iface", f"remote:{alias}"
        lst = c.cmd(*f"list {rtype}{suffix}".split())
        assert any(alias in str(x) for x in lst), (add, lst)
        det = c.cmd(*f"list-detail {rtype}{suffix}".split())
        assert any(alias in str(x) for x in det), (add, det)
        if detail_sub:
            assert any(detail_sub in str(x) for x in det), (detail_sub, det)
        if update:
            assert c.cmd(*update.split()) == "OK", update
            det2 = c.cmd(*f"list-detail {rtype}{suffix}".split())
            assert any(alias in str(x) for x in det2)
        created.append((add, remove))
    cfg = os.path.join(str(tmp), "vproxy.last")
    mod(pkg, "control.persist").save(app, cfg)
    for add, remove in reversed(created):
        assert c.cmd(*remove.split()) == "OK", remove
        rtype, alias = remove.split()[1:3]
        ctx = remove.split(" from ", 1)[1] if " from " in remove else None
        if rtype == "switch" and ctx:
            lst = c.cmd(*f"list iface in {ctx}".split())
            assert not any(f"remote:{alias}" in str(x)
                           for x in (lst or [])), (remove, lst)
            continue
        lst = c.cmd(*(f"list {rtype}" + (f" in {ctx}" if ctx else ""))
                    .split())
        assert not any(str(x) == alias or str(x).startswith(alias + " ")
                       for x in (lst or [])), (remove, lst)
    app2 = mod(pkg, "control.app").Application.create(workers=1)
    try:
        mod(pkg, "control.persist").load(app2, cfg)
        assert set(app2.upstreams) == {"ups0"}
        assert set(app2.tcp_lbs) == {"lb0"}
        assert set(app2.socks5_servers) == {"s5"}
        assert set(app2.dns_servers) == {"dns0"}
        assert set(app2.switches) == {"sw0"}
        sw2 = app2.switches["sw0"]
        assert 7 in sw2.networks
        assert sw2.users  # u001 came back
        assert any(r.alias == "rt0" for r in sw2.networks[7].routes.rules)
        assert app2.tcp_lbs["lb0"].timeout_ms == 9000
        assert set(app2.docker_controllers) == {"dk0"}
    finally:
        app2.close()


def test_resp_matrix_covers_creatable_inventory():
    """Every resource type of the grammar is in the matrix or
    uncreatable, and none refuses as not ported: the port keeps no
    list of unported types, and `list <type>` of every type over RESP
    answers, or fails for want of its context, never "not ported"."""
    C = mod(PORT, "control.command")
    assert set(mod("vproxy_tpu", "control.command").TYPES.values()) == \
        set(C.TYPES.values())
    assert not hasattr(C, "NOT_PORTED") and not hasattr(C, "_not_ported")
    assert "docker-network-plugin-controller" in \
        {row[0].split()[1] for row in MATRIX}
    covered = {row[0].split()[1] for row in MATRIX}
    for t in set(C.TYPES.values()):
        assert (t in covered) + (t in UNCREATABLE) == 1, t
    app = mod(PORT, "control.app").Application.create(workers=1)
    try:
        C.Command.execute(app, "add resp-controller ctl address "
                               "127.0.0.1:0")
        c = RespClient(app.resp_controllers["ctl"].bind_port)
        for t in sorted(set(C.TYPES.values())):
            try:
                c.cmd("list", t)
            except RuntimeError as e:
                assert "not ported" not in str(e), (t, str(e))
        c.close()
    finally:
        app.close()


# --------------------------------------- tests/test_control_extras.py

def test_resource_type_inventory(pkg):
    TYPES = mod(pkg, "control.command").TYPES
    full = {"tcp-lb", "socks5-server", "dns-server", "event-loop-group",
            "upstream", "server-group", "event-loop", "server",
            "server-sock", "connection", "session", "bytes-in",
            "bytes-out", "accepted-conn-count", "security-group",
            "security-group-rule", "resolver", "dns-cache", "cert-key",
            "switch", "vpc", "arp", "iface", "user", "tap", "ip", "route",
            "user-client", "proxy", "resp-controller", "http-controller",
            "docker-network-plugin-controller"}
    assert full <= set(TYPES.values()), full - set(TYPES.values())


def test_resolver_and_dns_cache(pkg, app):
    assert run(app, "list resolver") == ["(default)"]
    res = app.get_resolver()
    res._cache[("x.example.com", 1)] = (time.monotonic() + 60,
                                        [b"\x01\x02\x03\x04"])
    assert run(app, "list dns-cache in resolver (default)") == \
        ["x.example.com"]
    detail = run(app, "list-detail dns-cache in resolver (default)")
    assert "x.example.com" in detail[0] and "1.2.3.4" in detail[0]
    assert run(app, "remove dns-cache x.example.com from resolver "
                    "(default)") == "OK"
    assert run(app, "list dns-cache in resolver (default)") == []
    with pytest.raises(CmdError(pkg)):
        run(app, "remove dns-cache nope from resolver (default)")


def test_resp_and_http_controller_resources(pkg, app):
    assert run(app, "add resp-controller r0 address 127.0.0.1:0") == "OK"
    assert run(app, "list resp-controller") == ["r0"]
    port = app.resp_controllers["r0"].bind_port
    c = socket.create_connection(("127.0.0.1", port), timeout=3)
    c.sendall(b"*1\r\n$4\r\nPING\r\n")
    c.settimeout(3)
    assert c.recv(100).startswith(b"+PONG")
    c.close()
    assert run(app, "add http-controller h0 address 127.0.0.1:0") == "OK"
    hport = app.http_controllers["h0"].bind_port
    with urllib.request.urlopen(
            f"http://127.0.0.1:{hport}/healthz", timeout=3) as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(
            f"http://127.0.0.1:{hport}/api/v1/module/resp-controller",
            timeout=3) as r:
        assert json.loads(r.read())[0]["name"] == "r0"
    assert run(app, "remove resp-controller r0") == "OK"
    assert run(app, "remove http-controller h0") == "OK"
    assert app.resp_controllers == {} and app.http_controllers == {}


def test_update_socks5(pkg, app):
    """test_control_extras.py::test_update_switch_and_socks5's socks5
    half (its switch half is test_torch_vswitch.py's
    test_update_switch)."""
    run(app, "add upstream uu0")
    run(app, "add security-group sgu default allow")
    run(app, "add socks5-server s5u address 127.0.0.1:0 upstream uu0")
    assert run(app, "update socks5-server s5u security-group sgu "
                    "timeout 30000 allow-non-backend") == "OK"
    s5 = app.socks5_servers["s5u"]
    assert s5.security_group.alias == "sgu"
    assert s5.timeout_ms == 30000 and s5.allow_non_backend
    run(app, "remove socks5-server s5u")


def test_timeout_validation_and_persist_roundtrip(pkg, app):
    persist = mod(pkg, "control.persist")
    run(app, "add upstream uv0")
    with pytest.raises(CmdError(pkg), match="positive"):
        run(app, "add tcp-lb lbv address 127.0.0.1:0 upstream uv0 timeout 0")
    run(app, "add socks5-server s5v address 127.0.0.1:0 upstream uv0 "
             "timeout 45000")
    with pytest.raises(CmdError(pkg), match="positive"):
        run(app, "update socks5-server s5v timeout -5")
    cfg = persist.current_config(app)
    s5_line = [ln for ln in cfg.splitlines()
               if ln.startswith("add socks5-server")][0]
    assert "timeout 45000" in s5_line
    run(app, "remove socks5-server s5v")


# ------------------------------------ test_tls.py / test_drain_overload

def test_tls_command_grammar(pkg, app, certs):  # noqa: F811
    pytest.importorskip("cryptography")  # CertKey parses SAN/CN with it
    import ssl as _ssl
    persist = mod(pkg, "control.persist")
    sa = IdServer("CA", http=True)
    try:
        cert, key = certs["a"]
        run(app, f"add cert-key ck0 cert {cert} key {key}")
        assert run(app, "list cert-key") == ["ck0"]
        run(app, "add upstream u0")
        run(app, "add server-group g0 timeout 500 period 100 up 1 down 1")
        run(app, f"add server s0 to server-group g0 address "
                 f"127.0.0.1:{sa.port}")
        run(app, "add server-group g0 to upstream u0")
        run(app, "add tcp-lb lb0 address 127.0.0.1:0 upstream u0 "
                 "protocol http cert-key ck0")
        wait_healthy(app.server_groups["g0"], 1)
        port = app.tcp_lbs["lb0"].bind_port
        body, old_der = _tls_get(port, "a.example.com", "x")
        assert body == b"CA"
        cfg = persist.current_config(app)
        assert f"add cert-key ck0 cert {cert} key {key}" in cfg
        assert "cert-key ck0" in [ln for ln in cfg.splitlines()
                                  if ln.startswith("add tcp-lb")][0]
        wcert, wkey = certs["w"]
        w_der = _ssl.PEM_cert_to_DER_cert(open(wcert).read())
        assert old_der != w_der
        run(app, f"add cert-key ckw cert {wcert} key {wkey}")
        assert run(app, "update tcp-lb lb0 timeout 60000 cert-key ckw") == "OK"
        assert app.tcp_lbs["lb0"].timeout_ms == 60000
        body, new_der = _tls_get(port, "x.w.example.com", "x")
        assert body == b"CA" and new_der == w_der
        lb_line = [ln for ln in persist.current_config(app).splitlines()
                   if ln.startswith("add tcp-lb")][0]
        assert "timeout 60000" in lb_line and "cert-key ckw" in lb_line
    finally:
        sa.close()


def http_get(port, path):
    s = socket.create_connection(("127.0.0.1", port), timeout=3)
    s.sendall(b"GET %s HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
              % path.encode())
    buf = b""
    while True:
        d = s.recv(65536)
        if not d:
            break
        buf += d
    s.close()
    head, _, body = buf.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


def test_healthz_flips_to_draining(pkg):
    """Both healthz surfaces (inspection server + HttpController) report
    draining with a 503 once drain begins."""
    Application = mod(pkg, "control.app").Application
    HttpController = mod(pkg, "control.http_controller").HttpController
    SelectorEventLoop = mod(pkg, "net.eventloop").SelectorEventLoop
    lifecycle = mod(pkg, "utils.lifecycle")
    loop = SelectorEventLoop("drain-hz")
    loop.loop_thread()
    time.sleep(0.05)
    srv = mod(pkg, "utils.metrics").launch_inspection_http(
        loop, "127.0.0.1", 0)
    app = Application.create(workers=1)
    ctl = HttpController(app, "127.0.0.1", 0)
    ctl.start()
    try:
        assert http_get(srv.port, "/healthz") == (200, b"OK")
        st, body = http_get(ctl.bind_port, "/healthz")
        assert st == 200 and b"ok" in body
        app.request_drain()
        assert http_get(srv.port, "/healthz") == (503, b"draining")
        st, body = http_get(ctl.bind_port, "/healthz")
        assert st == 503 and b"draining" in body
    finally:
        ctl.stop()
        srv.close()
        loop.close()
        app.close()
        lifecycle.reset()


# ------------------------------------------------ tests/test_apps.py

def _echo_id_backend(tag: bytes):
    """A backend answering any data with its id."""
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(16)

    def serve():
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
    threading.Thread(target=serve, daemon=True).start()
    return srv, srv.getsockname()[1]


def test_simple_mode_gen_script(pkg):
    simple = mod(pkg, "apps.simple")
    argv = ["bind", "8080", "backend", "127.0.0.1:81,127.0.0.1:82",
            "protocol", "http", "ssl", "c.pem", "k.pem", "gen"]
    bind, backends, protocol, ssl, gen = simple.parse_args(argv)
    assert gen and bind == 8080 and len(backends) == 2
    script = simple.build_script(bind, backends, protocol, ssl)
    assert script[0] == "add upstream ups0"
    assert any("tcp-lb" in ln and "protocol http" in ln for ln in script)
    assert sum("add server " in ln for ln in script) == 2
    other = mod(PKGS[1 - PKGS.index(pkg)], "apps.simple")
    assert other.build_script(*other.parse_args(argv)[:4]) == script


def test_simple_mode_lb_end_to_end(pkg):
    """The Simple-mode script (BASELINE config #1's entry) builds a
    working LB that balances over both backends."""
    simple = mod(pkg, "apps.simple")
    Application = mod(pkg, "control.app").Application
    s1, p1 = _echo_id_backend(b"b1")
    s2, p2 = _echo_id_backend(b"b2")
    app = Application.create(workers=1)
    try:
        for line in simple.build_script(0, [f"127.0.0.1:{p1}",
                                            f"127.0.0.1:{p2}"], "tcp", None):
            run(app, line)
        port = app.tcp_lbs["lb0"].server_socks[0].port
        wait_healthy(app.server_groups["sg0"], 2, timeout=15)
        seen = set()
        for _ in range(8):
            c = socket.create_connection(("127.0.0.1", port), timeout=3)
            c.sendall(b"x")
            seen.add(c.recv(16))
            c.close()
        assert seen == {b"b1", b"b2"}
    finally:
        app.close()
        s1.close()
        s2.close()


def test_server_address_updater_swaps_ip(pkg):
    EventLoopGroup = mod(pkg, "components.elgroup").EventLoopGroup
    SG = mod(pkg, "components.servergroup")
    ServerAddressUpdater = mod(pkg, "components.updater").ServerAddressUpdater
    elg = EventLoopGroup("upd", 1)
    g = SG.ServerGroup("g", elg, SG.HealthCheckConfig(protocol="none",
                                                      period_ms=100))
    try:
        s = g.add("s0", "10.255.0.1", 80)  # stale ip
        s.host_name = "localhost"
        upd = ServerAddressUpdater(lambda: [g])
        assert upd.check_once() == {"g/s0": "127.0.0.1"}
        assert g.servers[0].ip == "127.0.0.1"
        assert upd.check_once() == {}
        upd.close()
    finally:
        g.close()
        elg.close()


# ------------------------------------------------ tests/test_lib.py

@pytest.fixture
def loop(pkg):
    elg = mod(pkg, "components.elgroup").EventLoopGroup("lib", 1)
    yield elg.next()
    elg.close()


def test_vserver_routing_and_params(pkg, loop):
    srv = mod(pkg, "lib.vserver").HttpServer(loop)
    srv.get("/hello", lambda r: r.resp.end("world"))
    srv.get("/users/:id/posts/:pid",
            lambda r: r.resp.end({"u": r.req.params["id"],
                                  "p": r.req.params["pid"]}))
    srv.post("/echo", lambda r: r.resp.end(r.req.body))
    srv.get("/q", lambda r: r.resp.end(r.req.query.get("x", "")))
    srv.all("/files/*", lambda r: r.resp.end(r.req.params["*"]))
    srv.listen(0)

    def http(req: bytes) -> bytes:
        c = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        c.sendall(req)
        data = b""
        while True:
            try:
                d = c.recv(65536)
            except socket.timeout:
                break
            if not d:
                break
            data += d
        c.close()
        return data

    close = b"host: x\r\nconnection: close\r\n\r\n"
    r = http(b"GET /hello HTTP/1.1\r\n" + close)
    assert r.startswith(b"HTTP/1.1 200") and r.endswith(b"world")
    r = http(b"GET /users/42/posts/7 HTTP/1.1\r\n" + close)
    assert b'{"u": "42", "p": "7"}' in r
    r = http(b"POST /echo HTTP/1.1\r\ncontent-length: 3\r\n" + close + b"abc")
    assert r.endswith(b"abc")
    r = http(b"GET /q?x=1&y=2 HTTP/1.1\r\n" + close)
    assert r.endswith(b"1")
    r = http(b"GET /files/a/b/c.txt HTTP/1.1\r\n" + close)
    assert r.endswith(b"a/b/c.txt")
    r = http(b"GET /nope HTTP/1.1\r\n" + close)
    assert r.startswith(b"HTTP/1.1 404")
    c = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
    for _ in range(2):  # keep-alive: two requests on one connection
        c.sendall(b"GET /hello HTTP/1.1\r\nhost: x\r\n\r\n")
        data = b""
        while b"world" not in data:
            data += c.recv(65536)
    c.close()
    srv.close()


def _raw_exchange(port, payload, stream=0):
    c = socket.create_connection(("127.0.0.1", port), timeout=5)
    c.sendall(payload)
    for _ in range(stream):  # keep streaming a body while rejected
        try:
            c.sendall(b"B" * 65536)
        except OSError:
            break
        time.sleep(0.005)
    data = b""
    c.settimeout(5)
    while True:
        try:
            d = c.recv(65536)
        except OSError:
            break
        if not d:
            break
        data += d
    c.close()
    return data


@pytest.fixture
def bare_loop(pkg):
    lp = mod(pkg, "net.eventloop").SelectorEventLoop("lim")
    lp.loop_thread()
    yield lp
    lp.close()


def test_vserver_body_limits(pkg, bare_loop):
    """Garbage or huge content-length -> 400/413 + close."""
    srv = mod(pkg, "lib.vserver").HttpServer(bare_loop)
    srv.post("/x", lambda r: r.resp.end({"ok": True}))
    srv.listen(0)
    head = b"POST /x HTTP/1.1\r\nhost: h\r\n"
    assert b"400 Bad Request" in _raw_exchange(
        srv.port, head + b"content-length: banana\r\n\r\n")
    assert b"413 Payload Too Large" in _raw_exchange(
        srv.port, head + b"content-length: 99999999999\r\n\r\n")
    assert b"200 OK" in _raw_exchange(
        srv.port, head + b"content-length: 2\r\nconnection: close\r\n\r\nhi")
    srv.close(sync=True)


def test_vserver_rejection_survives_midstream_client(pkg, bare_loop):
    """A 413 issued while the client is still streaming its body reaches
    the client (drain-then-close), not a RST."""
    srv = mod(pkg, "lib.vserver").HttpServer(bare_loop)
    srv.post("/x", lambda r: r.resp.end({"ok": True}))
    srv.listen(0)
    data = _raw_exchange(srv.port, b"POST /x HTTP/1.1\r\nhost: h\r\n"
                         b"content-length: 99999999999\r\n\r\n", stream=20)
    assert b"413 Payload Too Large" in data
    srv.close(sync=True)


# ------------------------------------------------- cross-package parity

# `list-detail upstream` names what serves the table: the backend
# ("jax" / "torch") and the fused tier ("jit" / "pallas" / "cuda" /
# "torch"). A cross-package diff masks those two tokens, nothing else.
MASKED = (re.compile(r"(-> groups \d+ backend )\S+( rules )"),
          re.compile(r"( fused on\()[^,]+(,)"))


def mask(out):
    if isinstance(out, list):
        return [mask(x) for x in out]
    if isinstance(out, str):
        for rx in MASKED:
            out = rx.sub(r"\1*\2", out)
    return out


def command_script(ports: dict, backend: int) -> list:
    """One operator session: resources of every ported kind, their
    list/list-detail views, updates, stats channels, errors, teardown.
    Health checks are "none", so every server is UP at once."""
    hc = "timeout 500 period 60000 up 1 down 1 protocol none"
    return [
        "add event-loop-group elg1",
        "add event-loop el1 to event-loop-group elg1",
        "list event-loop in event-loop-group elg1",
        "add upstream u0",
        f"add server-group g0 {hc} method wrr",
        f"add server s0 to server-group g0 address 127.0.0.1:{backend} "
        "weight 10",
        f"add server s1 to server-group g0 address 127.0.0.2:{backend} "
        "weight 5",
        f"add server-group g1 {hc} method source event-loop-group elg1",
        f"add server s0 to server-group g1 address 127.0.1.1:{backend}",
        'add server-group g0 to upstream u0 weight 10 annotations '
        '{"vproxy/hint-host":"a.example.com"}',
        'add server-group g1 to upstream u0 weight 5 annotations '
        '{"vproxy/hint-host":"*.b.example.com","vproxy/hint-uri":"/api"}',
        "list server-group in upstream u0",
        "list-detail server-group in upstream u0",
        "list-detail server in server-group g0",
        "list-detail upstream",
        "add security-group sg0 default allow",
        "add security-group-rule r0 to security-group sg0 network "
        "10.0.0.0/8 protocol tcp port-range 1,1024 default deny",
        "add security-group-rule r1 to security-group sg0 network "
        "192.168.0.0/16 protocol udp port-range 53,53 default deny",
        "list-detail security-group",
        "list-detail security-group-rule in security-group sg0",
        f"add tcp-lb lb0 address 127.0.0.1:{ports['lb']} upstream u0 "
        "protocol http security-group sg0",
        f"add socks5-server s5 address 127.0.0.1:{ports['s5']} upstream u0 "
        "security-group sg0",
        f"add dns-server d0 address 127.0.0.1:{ports['dns']} upstream u0 "
        "ttl 5 security-group sg0",
        "list-detail tcp-lb", "list-detail socks5-server",
        "list-detail dns-server",
        "update tcp-lb lb0 timeout 9000 max-sessions 500",
        "update socks5-server s5 allow-non-backend",
        "update dns-server d0 ttl 9",
        "update server-group g0 in upstream u0 weight 7",
        "update server s1 in server-group g0 weight 8",
        "update server-group g1 method wlc",
        "list-detail server-group", "list-detail tcp-lb",
        "list-detail socks5-server", "list-detail dns-server",
        "add fault pump.abort probability 0.5 count 3",
        "list-detail fault", "remove fault pump.abort",
        "add policy pol0 dim=clients rate=50 burst=100 action=monitor",
        "list policy", "remove policy pol0",
        "list resolver", "list server-sock in tcp-lb lb0",
        "list session in tcp-lb lb0", "list connection in tcp-lb lb0",
        "list accepted-conn-count in tcp-lb lb0",
        "list bytes-in in socks5-server s5",
        f"add http-controller h0 address 127.0.0.1:{ports['http']}",
        "list-detail http-controller", "remove http-controller h0",
        "remove upstream u0", "remove security-group sg0",
        "remove server-group g0", "add upstream u0",
        "add tcp-lb lb0 address 127.0.0.1:1 upstream nope",
        "update server nope in server-group g0 weight 1",
        "remove server-group g1 from upstream u0",
        "list-detail upstream",
        "remove dns-server d0", "remove socks5-server s5",
        "remove tcp-lb lb0", "force-remove upstream u0",
        "force-remove server-group g0", "list upstream",
        "list-detail server-group",
    ]


def run_script(pkg: str, lines: list) -> list:
    """Every line through `pkg`'s Command.execute on a fresh app: its
    result, or the name and message of what it raised."""
    Application = mod(pkg, "control.app").Application
    C = mod(pkg, "control.command")
    app = Application.create(workers=2)
    out = []
    try:
        for line in lines:
            try:
                out.append(C.Command.execute(app, line))
            except Exception as e:
                out.append(f"{type(e).__name__}: {e}")
    finally:
        app.close()
        mod(pkg, "policing.engine").default().set_policies([])
    return out


def test_command_script_equal_between_packages():
    ports = {"lb": free_port(), "s5": free_port(),
             "dns": free_port(socket.SOCK_DGRAM), "http": free_port()}
    lines = command_script(ports, free_port())
    ref, port = (run_script(p, lines) for p in PKGS)
    for line, a, b in zip(lines, ref, port):
        assert mask(a) == mask(b), (line, a, b)
    # the masked tokens are the only difference, and they do differ
    ups = lines.index("list-detail upstream")
    assert ref[ups] != port[ups]
    assert "backend torch rules" in port[ups][0]
    assert sum(isinstance(x, str) and x.startswith("CmdError: ")
               for x in port) >= 5


def _detail_views(app) -> dict:
    C = mod(type(app).__module__.split(".")[0], "control.command")
    out = {}
    for t in ("event-loop-group", "upstream", "server-group",
              "security-group", "tcp-lb", "socks5-server", "dns-server",
              "cert-key"):
        out[t] = mask(C.Command.execute(app, f"list-detail {t}"))
    for g in app.server_groups:
        out[f"servers {g}"] = C.Command.execute(
            app, f"list-detail server in server-group {g}")
    for u in app.upstreams:
        out[f"groups {u}"] = C.Command.execute(
            app, f"list-detail server-group in upstream {u}")
    for s in app.security_groups:
        out[f"rules {s}"] = C.Command.execute(
            app, f"list-detail security-group-rule in security-group {s}")
    return out


@pytest.mark.parametrize("src,dst", [PKGS, PKGS[::-1]],
                         ids=["ref-to-port", "port-to-ref"])
def test_config_saved_by_one_package_loads_in_the_other(src, dst, tmp_path,
                                                       certs):  # noqa: F811
    pytest.importorskip("cryptography")
    cert, key = certs["a"]
    ports = {"lb": free_port(), "s5": free_port(),
             "dns": free_port(socket.SOCK_DGRAM), "http": free_port()}
    lines = command_script(ports, free_port())
    # up to the fault (process-global and not persisted), then the kinds
    # the script lacks: a cert-key, a TLS tcp-lb, a shed policy
    lines = lines[:lines.index("add fault pump.abort probability 0.5 "
                               "count 3")] + [
        f"add cert-key ck0 cert {cert} key {key}",
        f"add tcp-lb lbt address 127.0.0.1:{free_port()} upstream u0 "
        "protocol http cert-key ck0 pool-size 3",
        "add policy pol1 dim=clients rate=5 burst=9 action=shed "
        "tenant=10.0.0.0/8"]
    cfg = tmp_path / "vproxy.last"
    views = {}
    # `src` builds the config by command and saves it; then each package
    # loads the file into a fresh app (the generation counters of a
    # loaded app count the load's publishes, not the build's)
    for pkg, build in ((src, True), (src, False), (dst, False)):
        app = mod(pkg, "control.app").Application.create(workers=2)
        persist = mod(pkg, "control.persist")
        try:
            if build:
                for line in lines:
                    Command(app).execute(app, line)
                persist.save(app, str(cfg))
            else:
                assert persist.load(app, str(cfg)) == len(
                    [ln for ln in cfg.read_text().splitlines() if ln])
                views[pkg] = (_detail_views(app),
                              persist.current_config(app))
        finally:
            app.close()
            mod(pkg, "policing.engine").default().set_policies([])
    (sv, scfg), (dv, dcfg) = views[src], views[dst]
    assert sv.keys() == dv.keys()
    for k in sv:
        assert sv[k] == dv[k], (k, sv[k], dv[k])
    assert scfg == dcfg == cfg.read_text()


SCRAPE = r'''
import json, os, sys, urllib.request
pkg = sys.argv[1]
import importlib
A = importlib.import_module(pkg + ".control.app")
C = importlib.import_module(pkg + ".control.command")
M = importlib.import_module(pkg + ".utils.metrics")
app = A.Application.create(workers=1)
for line in sys.argv[2:]:
    C.Command.execute(app, line)
srv = M.launch_inspection_http(app.control_loop, "127.0.0.1", 0)
out = {}
for path in ("/metrics", "/healthz", "/lsof", "/jstack", "/events",
             "/analytics", "/policing", "/workload", "/trace", "/faults",
             "/cluster"):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}{path}", timeout=10) as r:
        body = r.read().decode()
        out[path] = (r.status, body)
fams = sorted({l.split()[2] for l in out["/metrics"][1].splitlines()
               if l.startswith("# TYPE ")})
keys = {p: sorted(json.loads(b)) for p, (s, b) in out.items()
        if p in ("/analytics", "/policing", "/workload", "/trace",
                 "/cluster")}
print(json.dumps({"families": fams, "status": {p: s for p, (s, _) in
                                              out.items()},
                  "keys": keys, "healthz": out["/healthz"][1],
                  "cluster": out["/cluster"][1]}))
srv.close()
app.close()
'''


def test_inspection_scrape_lists_the_reference_families(tmp_path):
    """A fresh interpreter per package boots the same resources and
    serves the inspection server: the /metrics family names are the
    same set, every route answers 200, the JSON routes carry the same
    keys, and /cluster says no cluster plane."""
    lines = ["add upstream u0",
             "add server-group g0 timeout 500 period 60000 up 1 down 1 "
             "protocol none",
             "add server s0 to server-group g0 address 127.0.0.1:9",
             'add server-group g0 to upstream u0 annotations '
             '{"vproxy/hint-host":"a.example.com"}',
             "add security-group sg0 default allow",
             "add tcp-lb lb0 address 127.0.0.1:0 upstream u0 protocol http "
             "security-group sg0",
             "add socks5-server s5 address 127.0.0.1:0 upstream u0",
             "add dns-server d0 address 127.0.0.1:0 upstream u0"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               VPROXY_TPU_TORCH_DEVICE="cpu",
               VPROXY_TPU_HOME=str(tmp_path))
    got = {}
    for pkg in PKGS:
        r = subprocess.run([sys.executable, "-c", SCRAPE, pkg, *lines],
                           cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=180)
        assert r.returncode == 0, r.stderr[-3000:]
        got[pkg] = json.loads(r.stdout.strip().splitlines()[-1])
    ref, port = got["vproxy_tpu"], got[PORT]
    assert set(port["families"]) == set(ref["families"]), (
        set(ref["families"]) ^ set(port["families"]))
    assert port["status"] == ref["status"] and \
        set(port["status"].values()) == {200}
    assert port["keys"] == ref["keys"]
    assert port["healthz"] == ref["healthz"] == "OK"
    assert json.loads(port["cluster"]) == {"enabled": False}


# -------------------------------------------------- the process entry

def _recv_all(c):
    data = b""
    while True:
        try:
            d = c.recv(65536)
        except OSError:
            break
        if not d:
            break
        data += d
    return data


def _port_env(home, **extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "VPROXY_TPU_TORCH_DEVICE",
                        "VPROXY_TPU_MATCHER", "VPROXY_TPU_CLUSTER_PEERS")}
    env.update(PYTHONPATH=REPO, VPROXY_TPU_HOME=str(home),
               VPROXY_TPU_WORKERS="2", **extra)
    return env


def test_boot_from_config_serves_and_saves_on_sigterm(tmp_path):
    """tests/test_boot_all.py: one `python -m vproxy_tpu_torch`
    process, the matchers on the CPU (VPROXY_TPU_TORCH_DEVICE=cpu),
    hosts a tcp-lb, a socks5-server, a dns-server, a switch and both
    controllers from a config file, serves one request of each (the
    switch answers an ARP request for its vpc's gateway ip), takes a
    mutation over RESP, and on SIGTERM exits 0 having saved its
    config."""
    import select
    backend = IdServer("BOOT", http=True)
    cfg = tmp_path / "boot.cfg"
    cfg.write_text("\n".join([
        "add upstream u0",
        "add server-group g0 timeout 500 period 200 up 1 down 3 "
        "protocol none",
        f"add server s0 to server-group g0 address 127.0.0.1:{backend.port} "
        "weight 10",
        'add server-group g0 to upstream u0 weight 10 '
        'annotations {"vproxy/hint-host":"svc.example.com"}',
        "add tcp-lb lb0 address 127.0.0.1:0 upstream u0 protocol tcp",
        "add socks5-server s50 address 127.0.0.1:0 upstream u0",
        "add dns-server d0 address 127.0.0.1:0 upstream u0",
        "add switch sw0 address 127.0.0.1:0",
        "add vpc 3 to switch sw0 v4network 10.3.0.0/16",
        "add ip 10.3.0.1 to vpc 3 in switch sw0",
    ]) + "\n")
    home = tmp_path / "home"
    p = subprocess.Popen(
        [sys.executable, "-m", "vproxy_tpu_torch",
         "resp-controller", "127.0.0.1:0", "pw",
         "http-controller", "127.0.0.1:0",
         "load", str(cfg), "noStdIOController"],
        cwd=REPO, env=_port_env(home, VPROXY_TPU_TORCH_DEVICE="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        resp_port = http_port = None
        deadline = time.time() + 60
        buf = ""
        while time.time() < deadline and (resp_port is None
                                          or http_port is None):
            r, _, _ = select.select([p.stdout], [], [], 0.5)
            if not r:
                continue
            chunk = os.read(p.stdout.fileno(), 4096).decode()
            if not chunk:
                break
            buf += chunk
            *lines, buf = buf.split("\n")
            for line in lines:
                if line.startswith("resp-controller on "):
                    resp_port = int(line.rsplit(":", 1)[1])
                elif line.startswith("http-controller on "):
                    http_port = int(line.rsplit(":", 1)[1])
        assert resp_port and http_port

        def rest(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{http_port}{path}", timeout=5) as r:
                return json.loads(r.read())

        deadline = time.time() + 30
        lb_port = s5_port = dns_port = None
        while time.time() < deadline and not (lb_port and s5_port):
            lbs = rest("/api/v1/module/tcp-lb")
            s5s = rest("/api/v1/module/socks5-server")
            dnss = rest("/api/v1/module/dns-server")
            if lbs and s5s and dnss:
                lb_port = int(lbs[0]["address"].rsplit(":", 1)[1])
                s5_port = int(s5s[0]["address"].rsplit(":", 1)[1])
                dns_port = int(dnss[0]["address"].rsplit(":", 1)[1])
            time.sleep(0.1)
        assert lb_port and s5_port and dns_port
        assert rest("/api/v1/module/upstream")[0]["engine"]["backend"] == \
            "torch"

        deadline = time.time() + 15
        body = b""
        while time.time() < deadline and b"BOOT" not in body:
            c = socket.create_connection(("127.0.0.1", lb_port), timeout=5)
            c.settimeout(5)
            c.sendall(b"GET / HTTP/1.1\r\nhost: x\r\nconnection: close"
                      b"\r\n\r\n")
            body = _recv_all(c)
            c.close()
            if b"BOOT" not in body:
                time.sleep(0.2)
        assert b"BOOT" in body

        c = socket.create_connection(("127.0.0.1", s5_port), timeout=5)
        c.settimeout(5)
        c.sendall(b"\x05\x01\x00")
        assert c.recv(2) == b"\x05\x00"
        c.sendall(b"\x05\x01\x00\x03" + bytes([15]) + b"svc.example.com" +
                  struct.pack(">H", 80))
        assert c.recv(10)[:2] == b"\x05\x00"
        c.sendall(b"GET / HTTP/1.1\r\nhost: x\r\nconnection: close\r\n\r\n")
        assert b"BOOT" in _recv_all(c)
        c.close()

        from vproxy_tpu_torch.dns import packet as dnsp
        q = dnsp.Packet(id=9, questions=[dnsp.Question("svc.example.com.",
                                                       dnsp.A)])
        u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        u.settimeout(5)
        u.sendto(q.encode(), ("127.0.0.1", dns_port))
        resp = dnsp.parse(u.recvfrom(4096)[0])
        u.close()
        assert resp.answers and resp.answers[0].rdata == \
            socket.inet_aton("127.0.0.1")

        cli = RespClient(resp_port, password="pw")
        assert cli.cmd("list", "tcp-lb") == ["lb0"]
        sw_port = int(cli.cmd("list-detail", "switch")[0].split()[3]
                      .rsplit(":", 1)[1])
        assert cli.cmd("add", "upstream", "u9") == "OK"
        cli.close()

        # the switch: an ARP request for the vpc's synthetic ip, sent
        # as plain VXLAN, is answered with that ip's mac
        from vproxy_tpu_torch.vswitch import packets as vp
        from vproxy_tpu_torch.vswitch.switch import synthetic_mac
        gw, mac = socket.inet_aton("10.3.0.1"), b"\x02\x00\x00\x00\x00\x07"
        arp = vp.Arp(vp.ARP_REQUEST, mac, socket.inet_aton("10.3.0.7"),
                     b"\x00" * 6, gw)
        u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        u.settimeout(5)
        u.sendto(vp.Vxlan(3, vp.Ethernet(vp.BROADCAST_MAC, mac,
                                         vp.ETHER_TYPE_ARP, b"", arp))
                 .to_bytes(), ("127.0.0.1", sw_port))
        reply = vp.Vxlan.parse(u.recvfrom(4096)[0])
        u.close()
        assert reply.vni == 3 and reply.ether.dst == mac
        assert reply.ether.src == synthetic_mac(3, gw)

        p.send_signal(signal.SIGTERM)
        assert p.wait(30) == 0
        saved = (home / "vproxy.last").read_text()
        assert "add tcp-lb lb0" in saved and "add socks5-server s50" in saved
        assert "add dns-server d0" in saved
        assert "add upstream u9" in saved  # the live mutation persisted
        assert "add vpc 3 to switch sw0" in saved
        assert "add ip 10.3.0.1 to vpc 3 in switch sw0" in saved
    finally:
        if p.poll() is None:
            p.kill()
        backend.close()


REFUSALS = {
    "no-GPU": ({}, [], "no CUDA device"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_entry_refuses(case, tmp_path):
    """Without a GPU, and without the CPU or the host asked for, the
    entry exits non-zero with torchenv's message. Nothing is served
    and no config is written."""
    env, args, msg = REFUSALS[case]
    if case == "no-GPU" and torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry would boot")
    r = subprocess.run(
        [sys.executable, "-m", "vproxy_tpu_torch", *args, "noLoadLast",
         "noStdIOController", "resp-controller", "127.0.0.1:0", "pw",
         "http-controller", "127.0.0.1:0"],
        cwd=REPO, env=_port_env(tmp_path, **env), capture_output=True,
        text=True, timeout=120)
    assert r.returncode != 0
    assert msg in r.stderr, r.stderr[-2000:]
    assert "resp-controller on" not in r.stdout
    assert not (tmp_path / "vproxy.last").exists()


APPS = ("helloworld", "kcptun", "websocks", "daemon")


@pytest.mark.parametrize("name", APPS)
def test_entry_serves_app(name, tmp_path):
    """`python -m vproxy_tpu_torch <app>` with VPROXY_TPU_TORCH_DEVICE=cpu
    boots the app and serves: helloworld echoes over TCP and UDP; a
    kcptun server and client (two children) carry a TCP connection to
    an echo server; a websocks server and agent (two children, over
    KCP) carry a SOCKS5 CONNECT; the daemon supervises a control-plane
    child whose resp-controller answers. Every child exits 0 on
    SIGTERM."""
    import chip_smoke as CS
    env = _port_env(tmp_path, VPROXY_TPU_TORCH_DEVICE="cpu",
                    PYTHONUNBUFFERED="1")
    kids = []
    echo = CS._EchoServer()

    def boot(*args):
        kids.append(CS._AppChild(f"{name}{len(kids)}", list(args), env,
                                 str(tmp_path)))
        return kids[-1]
    try:
        if name == "helloworld":
            port = int(boot("helloworld", "0").expect(
                r"echo on tcp/udp 0\.0\.0\.0:(\d+)")[1])
            c = socket.create_connection(("127.0.0.1", port), timeout=5)
            c.sendall(b"ping")
            assert c.recv(256) == b"hello from vproxy-tpu\nping"
            c.close()
            u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            u.settimeout(5)
            u.sendto(b"uping", ("127.0.0.1", port))
            assert u.recvfrom(256)[0] == b"hello from vproxy-tpu\nuping"
            u.close()
        elif name == "kcptun":
            uport = int(boot("kcptun", "server", "0",
                             f"127.0.0.1:{echo.port}").expect(
                r"udp (\d+) ->")[1])
            tport = int(boot("kcptun", "client", "0",
                             f"127.0.0.1:{uport}").expect(
                r"tcp (\d+) ->")[1])
            assert CS._echo_stream(tport, b"through-kcp" * 1000,
                                   timeout=30)["ok"]
        elif name == "websocks":
            sport = int(boot("websocks", "server", "0", "alice:pw",
                             "kcp").expect(
                r"websocks server on :(\d+) \(tcp\+kcp\)")[1])
            aport = int(boot("websocks", "agent", "0", f"127.0.0.1:{sport}",
                             "alice:pw", "kcp").expect(
                r"socks5 on 127\.0\.0\.1:(\d+)")[1])
            CS.await_tunnel(aport, echo.port, "the websocks agent")
        else:
            rport = int(boot(
                "daemon", "noLoadLast", "noSave", "resp-controller",
                "127.0.0.1:0", "pw", "http-controller", "127.0.0.1:0")
                .expect(r"resp-controller on 127\.0\.0\.1:(\d+)")[1])
            cli = RespClient(rport, password="pw")
            assert cli.cmd("add", "upstream", "ud") == "OK"
            assert cli.cmd("list", "upstream") == ["ud"]
            cli.close()
        assert [k.stop() for k in reversed(kids)] == [0] * len(kids)
    finally:
        for k in kids:
            k.kill()
        echo.close()


def _resp_script(port: int, lines: list) -> list:
    """Every line over RESP: its reply, or the error's text."""
    cli = RespClient(port, password="pw")
    out = []
    try:
        for line in lines:
            try:
                out.append(cli.cmd(*line.split()))
            except RuntimeError as e:
                out.append(f"ERR {e}")
    finally:
        cli.close()
    return out


def test_entry_serves_jax_dense_like_the_reference(tmp_path, monkeypatch):
    """VPROXY_TPU_MATCHER=jax-dense boots `python -m vproxy_tpu_torch`
    on the CPU on its dense backend ("torch-dense"), and the command
    script over its resp-controller answers what the reference answers
    over its own on "jax-dense" (in process, the same ports one after
    the other): equal but for the masked tokens."""
    import select
    ports = {"lb": free_port(), "s5": free_port(),
             "dns": free_port(socket.SOCK_DGRAM), "http": free_port()}
    lines = command_script(ports, free_port())
    monkeypatch.setenv("VPROXY_TPU_MATCHER", "jax-dense")
    ref_app = mod("vproxy_tpu", "control.app").Application.create(workers=2)
    ctl = mod("vproxy_tpu", "control.resp").RESPController(
        ref_app, "127.0.0.1", 0, password="pw")
    ctl.start()
    try:
        ref = _resp_script(ctl.bind_port, lines)
    finally:
        ctl.stop()
        ref_app.close()
        mod("vproxy_tpu", "policing.engine").default().set_policies([])
    monkeypatch.delenv("VPROXY_TPU_MATCHER")
    p = subprocess.Popen(
        [sys.executable, "-m", "vproxy_tpu_torch", "noLoadLast", "noSave",
         "noStdIOController", "resp-controller", "127.0.0.1:0", "pw"],
        cwd=REPO, env=_port_env(tmp_path, VPROXY_TPU_TORCH_DEVICE="cpu",
                                VPROXY_TPU_MATCHER="jax-dense"),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        resp_port, buf = None, ""
        deadline = time.time() + 60
        while time.time() < deadline and resp_port is None:
            r, _, _ = select.select([p.stdout], [], [], 0.5)
            if not r:
                continue
            chunk = os.read(p.stdout.fileno(), 4096).decode()
            if not chunk:
                break
            buf += chunk
            for line in buf.split("\n")[:-1]:
                if line.startswith("resp-controller on "):
                    resp_port = int(line.rsplit(":", 1)[1])
        assert resp_port, buf
        got = _resp_script(resp_port, lines)
        p.send_signal(signal.SIGTERM)
        assert p.wait(30) == 0
    finally:
        if p.poll() is None:
            p.kill()
    for line, a, b in zip(lines, ref, got):
        assert mask(a) == mask(b), (line, a, b)
    ups = lines.index("list-detail upstream")
    assert "backend torch-dense rules" in got[ups][0]
    assert "backend jax-dense rules" in ref[ups][0]
    assert sum(isinstance(x, str) and x.startswith("ERR ") for x in got) >= 5


def _boot_entry(tmp_path, env: dict, want: tuple = ("resp-controller on",)):
    """`python -m vproxy_tpu_torch` on the CPU with `env`, a resp-
    controller on an ephemeral port. -> (process, resp port, the stdout
    lines read until every line start in `want` was seen)."""
    import select
    p = subprocess.Popen(
        [sys.executable, "-m", "vproxy_tpu_torch", "noLoadLast", "noSave",
         "noStdIOController", "resp-controller", "127.0.0.1:0", "pw"],
        cwd=REPO, env=_port_env(tmp_path, VPROXY_TPU_TORCH_DEVICE="cpu",
                                **env),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    buf, lines = "", []
    deadline = time.time() + 60
    while time.time() < deadline and not all(
            any(ln.startswith(w) for ln in lines) for w in want):
        r, _, _ = select.select([p.stdout], [], [], 0.5)
        if not r:
            continue
        chunk = os.read(p.stdout.fileno(), 4096).decode()
        if not chunk:
            break
        buf += chunk
        lines = buf.split("\n")[:-1]
    resp = next((int(ln.rsplit(":", 1)[1]) for ln in lines
                 if ln.startswith("resp-controller on ")), None)
    return p, resp, lines


@pytest.mark.timeout(180)
@pytest.mark.parametrize("matcher", ["jax-sharded", "jax-fp-sharded"])
def test_entry_serves_the_sharded_names(matcher, tmp_path):
    """VPROXY_TPU_MATCHER=jax-sharded / jax-fp-sharded boot `python -m
    vproxy_tpu_torch` on the port's sharded backends (the default mesh:
    one shard slot in one process): an Upstream built by command lists
    its backend, and the entry exits 0 on SIGTERM."""
    p, resp, lines = _boot_entry(tmp_path, {"VPROXY_TPU_MATCHER": matcher})
    try:
        assert resp, lines
        got = _resp_script(resp, [
            "add upstream u0",
            "add server-group g0 timeout 500 period 60000 up 1 down 2 "
            "annotations {\"vproxy/hint-host\":\"a.example.com\"}",
            "add server-group g0 to upstream u0 weight 10",
            "list-detail upstream"])
        want = "torch-fp-sharded" if "fp" in matcher else "torch-sharded"
        assert f"backend {want} rules" in got[-1][0], got
        p.send_signal(signal.SIGTERM)
        assert p.wait(30) == 0
    finally:
        if p.poll() is None:
            p.kill()


@pytest.mark.timeout(180)
def test_entry_boots_a_cluster_node(tmp_path):
    """VPROXY_TPU_CLUSTER_PEERS boots a ClusterNode in `python -m
    vproxy_tpu_torch` (one node on ports it binds itself: no race for
    a port): it leads its fleet of one, `cluster-node` commands answer,
    a replicated mutation bumps the generation, and the entry exits 0
    on SIGTERM."""
    p, resp, lines = _boot_entry(
        tmp_path, {"VPROXY_TPU_CLUSTER_PEERS": "127.0.0.1:0/0"},
        ("resp-controller on", "cluster node"))
    try:
        assert resp and any(ln.startswith("cluster node 0/1 ")
                            for ln in lines), lines
        got = _resp_script(resp, ["list cluster-node",
                                  "list-detail cluster-node",
                                  "add upstream u0",
                                  "list-detail cluster-node"])
        assert got[0] == ["0"], got
        assert any("self leader" in ln for ln in got[1]), got
        assert got[3][-1].startswith("generation 1 lag 0"), got
        p.send_signal(signal.SIGTERM)
        assert p.wait(30) == 0
    finally:
        if p.poll() is None:
            p.kill()


def test_entry_boots_on_the_host_when_asked(tmp_path):
    """VPROXY_TPU_MATCHER=host (the caller asking for the host index)
    boots without a card; `version` answers as the reference's."""
    r = subprocess.run(
        [sys.executable, "-m", "vproxy_tpu_torch", "version"],
        cwd=REPO, env=_port_env(tmp_path, VPROXY_TPU_MATCHER="host"),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "vproxy-tpu 0.1.0"


@pytest.mark.parametrize("matcher", [None, "jax-fp"], ids=["torch", "fp"])
def test_chip_smoke_control_phase_on_cpu(matcher):
    """chip_smoke.py's `control` phase at a small size on the CPU: the
    port booted as a process (its matchers on the CPU), the config built
    by command over RESP and HTTP, DNS / Socks5 / http-splice traffic
    from the client process with every answer checked against the
    port's host index, and the launch and batch counts read from the
    child's /metrics (the plain tiers here: one dispatch a batch)."""
    import chip_smoke as CS
    out = CS.phase_control(torch.device("cpu"), max_groups=32,
                           dns_bursts=1, s5_bursts=1, lb_bursts=1,
                           min_acl=48, max_acl=48, matcher=matcher,
                           dns_burst=256, conn_burst=24)
    assert out["backend"] == ("torch-fp" if matcher else "torch")
    assert out["groups"] == 32 and out["acl_rules"] == {"tcp": 48,
                                                        "udp": 48}
    assert out["dns_queries"] == 256 and out["dns_answered"] > 128
    assert out["socks5_sessions"] + out["socks5_refused"] == 24
    assert out["tcplb_connections"] == 24 and out["tcplb_matched"] > 0
    launches = out["launches"]
    assert list(launches.values())[0] == out["batches"]["hint + cidr"] > 0
    assert launches["fused (B1)"] == 0 and out["failovers"] == 0
    assert out["queries"]["device"] == out["queries"]["total"]
    assert out["exit"] == 0
