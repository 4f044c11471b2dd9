"""The port's docker network plugin (vproxy_tpu_torch/control/docker.py)
against the reference's: the 8 cases of tests/test_docker_plugin.py
(HTTP over a real unix socket driving the switch: activate and
capabilities, a network as a VPC, validation, the endpoint lifecycle
on a real tap, endpoint checks, the loop's own unix client, the
command grammar and persistence, the replay of networks and taps),
each run on both packages, the switch's matchers on the CPU; then one
request sequence through both packages' plugins: every JSON reply and
the resulting current_config text equal (the switch's bound port
masked); then chip_smoke.py's `docker` phase small on the CPU."""
import json
import os
import re
import socket
import threading
from types import SimpleNamespace

import pytest

from test_torch_dns import IDS, PKGS, mod
from test_torch_tcplb import _torch_cpu  # noqa: F401

NET_ID = "cafebabe0001cafebabe0001cafebabe0001"
EP_ID = "deadbeef0002deadbeef0002deadbeef0002"


def tap_supported() -> bool:
    return mod(PKGS[1], "vswitch.iface").tap_supported()


needs_tap = pytest.mark.skipif(not tap_supported(),
                               reason="no /dev/net/tun access")


def pkg_ns(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(
        pkg=pkg, App=mod(pkg, "control.app").Application,
        Command=mod(pkg, "control.command").Command,
        D=mod(pkg, "control.docker"), persist=mod(pkg, "control.persist"))


@pytest.fixture(params=PKGS, ids=IDS)
def X(request):
    return pkg_ns(request.param)


@pytest.fixture
def app(X, tmp_path, monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_DOCKER_SCRIPTS", str(tmp_path / "scripts"))
    monkeypatch.setenv("VPROXY_TPU_DOCKER_SWITCH_ADDR", "127.0.0.1:0")
    a = X.App.create(workers=1)
    yield a
    a.close()


@pytest.fixture
def plugin(X, app, tmp_path):
    path = str(tmp_path / "vproxy.sock")
    assert X.Command.execute(
        app, f"add docker-network-plugin-controller dk0 path {path}") == "OK"
    return path


def uds_post(path: str, route: str, body: dict) -> dict:
    payload = json.dumps(body).encode()
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(5)
    c.connect(path)
    c.sendall(b"POST " + route.encode() + b" HTTP/1.1\r\n"
              b"host: plugin\r\ncontent-type: application/json\r\n"
              b"content-length: " + str(len(payload)).encode() +
              b"\r\nconnection: close\r\n\r\n" + payload)
    buf = b""
    while True:
        d = c.recv(65536)
        if not d:
            break
        buf += d
    c.close()
    head, _, rest = buf.partition(b"\r\n\r\n")
    assert head.split(b" ", 2)[1] == b"200", head
    return json.loads(rest)


def network_body(net_id=NET_ID, pool="172.28.0.0/16", gw="172.28.0.1/16",
                 v6=False):
    body = {"NetworkID": net_id,
            "IPv4Data": [{"AddressSpace": "", "Pool": pool, "Gateway": gw}],
            "IPv6Data": []}
    if v6:
        body["IPv6Data"] = [{"AddressSpace": "", "Pool": "fd00:2800::/64",
                             "Gateway": "fd00:2800::1/64"}]
    return body


def mk_network(path, *, v6=False):
    return uds_post(path, "/NetworkDriver.CreateNetwork",
                    network_body(v6=v6))


def test_activate_and_capabilities(plugin):
    assert uds_post(plugin, "/Plugin.Activate", {}) == {
        "Implements": ["NetworkDriver"]}
    caps = uds_post(plugin, "/NetworkDriver.GetCapabilities", {})
    assert caps["Scope"] == "local"


def test_create_network_builds_vpc(X, app, plugin):
    assert mk_network(plugin) == {}
    sw = app.switches[X.D.SWITCH_NAME]
    assert len(sw.networks) == 1
    net = next(iter(sw.networks.values()))
    assert net.annotations[X.D.ANNO_NETWORK_ID] == NET_ID
    assert str(net.v4net) == "172.28.0.0/16"
    # gateway synthetic ip under the reserved gateway mac
    gws = [ip for ip, mac in net.ips.ips().items() if mac == X.D.GATEWAY_MAC]
    assert [socket.inet_ntoa(ip) for ip in gws if len(ip) == 4] == [
        "172.28.0.1"]
    assert uds_post(plugin, "/NetworkDriver.DeleteNetwork",
                    {"NetworkID": NET_ID}) == {}
    assert not sw.networks


def test_create_network_validation(plugin):
    r = uds_post(plugin, "/NetworkDriver.CreateNetwork",
                 {"NetworkID": "x", "IPv4Data": [], "IPv6Data": []})
    assert "no ipv4" in r["Err"]
    r = uds_post(plugin, "/NetworkDriver.CreateNetwork", network_body(
        "x", "10.0.0.0/24", "10.9.9.9/24"))
    assert "does not contain the gateway" in r["Err"]
    r = uds_post(plugin, "/NetworkDriver.CreateNetwork", network_body(
        "x", "10.0.0.0/24", "10.0.0.1/16"))
    assert "mask" in r["Err"]
    r = uds_post(plugin, "/NetworkDriver.DeleteNetwork", {"NetworkID": "nope"})
    assert "not found" in r["Err"]


@needs_tap
def test_endpoint_lifecycle(X, app, plugin, tmp_path):
    mk_network(plugin, v6=True)
    r = uds_post(plugin, "/NetworkDriver.CreateEndpoint",
                 {"NetworkID": NET_ID, "EndpointID": EP_ID,
                  "Interface": {"Address": "172.28.0.5/16",
                                "AddressIPv6": "fd00:2800::5/64",
                                "MacAddress": "02:42:ac:1c:00:05"}})
    assert r == {}
    sw = app.switches[X.D.SWITCH_NAME]
    taps = [i for i in sw.list_ifaces() if i.name.startswith("tap:")]
    assert len(taps) == 1
    tap = taps[0]
    assert tap.dev == "tap" + EP_ID[:12]
    assert tap.annotations[X.D.ANNO_ENDPOINT_ID] == EP_ID
    assert tap.annotations[X.D.ANNO_ENDPOINT_IPV4] == "172.28.0.5/16"
    script = tmp_path / "scripts" / EP_ID
    assert script.exists() and script.read_text() == ""
    assert os.access(script, os.X_OK)
    assert uds_post(plugin, "/NetworkDriver.EndpointOperInfo",
                    {"NetworkID": NET_ID, "EndpointID": EP_ID}) == {
        "Value": {}}
    # join hands docker the iface name + gateways and writes the script
    r = uds_post(plugin, "/NetworkDriver.Join",
                 {"NetworkID": NET_ID, "EndpointID": EP_ID,
                  "SandboxKey": "/var/run/docker/netns/abcd1234"})
    assert r["InterfaceName"] == {"SrcName": tap.dev, "DstPrefix": "eth"}
    assert r["Gateway"] == "172.28.0.1"
    assert r["GatewayIPv6"] == "fd00:2800::1"
    body = script.read_text()
    assert "ip link set $DEV netns abcd1234" in body
    assert "ip address add 172.28.0.5/16 dev $DEV" in body
    assert "default via 172.28.0.1" in body
    assert "-6 route add default via fd00:2800::1" in body
    # leave truncates; delete removes tap + script
    assert uds_post(plugin, "/NetworkDriver.Leave",
                    {"NetworkID": NET_ID, "EndpointID": EP_ID}) == {}
    assert script.read_text() == ""
    assert uds_post(plugin, "/NetworkDriver.DeleteEndpoint",
                    {"NetworkID": NET_ID, "EndpointID": EP_ID}) == {}
    assert not [i for i in sw.list_ifaces() if i.name.startswith("tap:")]
    assert not script.exists()


@needs_tap
def test_endpoint_requires_ipv4_and_network(app, plugin):
    mk_network(plugin)
    r = uds_post(plugin, "/NetworkDriver.CreateEndpoint",
                 {"NetworkID": NET_ID, "EndpointID": EP_ID})
    assert "auto ip allocation" in r["Err"]
    r = uds_post(plugin, "/NetworkDriver.CreateEndpoint",
                 {"NetworkID": NET_ID, "EndpointID": EP_ID,
                  "Interface": {"Address": "172.28.0.5/16",
                                "AddressIPv6": "fd00::5/64"}})
    assert "does not support ipv6" in r["Err"]
    r = uds_post(plugin, "/NetworkDriver.Join",
                 {"NetworkID": NET_ID, "EndpointID": "missing",
                  "SandboxKey": "/x/y"})
    assert "not found" in r["Err"]


def test_connect_unix_client(X, app, plugin):
    """The package's own client stack reaches the plugin socket:
    Connection.connect_unix end-to-end against the UDS listener."""
    C = mod(X.pkg, "net.connection")
    got = []
    done = threading.Event()

    class H(C.Handler):
        def on_connected(self, conn):
            conn.write(b"POST /Plugin.Activate HTTP/1.1\r\nhost: d\r\n"
                       b"content-length: 0\r\nconnection: close\r\n\r\n")

        def on_data(self, conn, data):
            got.append(data)
            if b"NetworkDriver" in b"".join(got):
                done.set()

        def on_eof(self, conn):
            done.set()
            conn.close()

    lp = app.control_loop
    lp.run_on_loop(lambda: C.Connection.connect_unix(lp, plugin)
                   .set_handler(H()))
    assert done.wait(5)
    body = b"".join(got)
    assert b"200" in body and b"NetworkDriver" in body


def test_command_grammar_and_persist(X, app, plugin):
    assert X.Command.execute(
        app, "list docker-network-plugin-controller") == ["dk0"]
    assert X.Command.execute(
        app, "list-detail docker-network-plugin-controller") == [
        f"dk0 -> path {plugin}"]
    cfg = X.persist.current_config(app)
    assert f"add docker-network-plugin-controller dk0 path {plugin}" in cfg
    assert X.Command.execute(
        app, "remove docker-network-plugin-controller dk0") == "OK"
    assert not os.path.exists(plugin)


@needs_tap
def test_persist_replays_docker_state(X, app, plugin, tmp_path):
    """The annotated vpc + tap + controller replay through the command
    engine (Shutdown.currentConfig parity)."""
    mk_network(plugin)
    uds_post(plugin, "/NetworkDriver.CreateEndpoint",
             {"NetworkID": NET_ID, "EndpointID": EP_ID,
              "Interface": {"Address": "172.28.0.5/16"}})
    cfg = X.persist.current_config(app)
    assert X.D.ANNO_NETWORK_ID in cfg          # vpc annotations survive
    assert f"add tap tap{EP_ID[:12]} to switch {X.D.SWITCH_NAME}" in cfg
    p = tmp_path / "saved.cfg"
    p.write_text(cfg)
    app.close()
    app2 = X.App.create(workers=1)
    try:
        X.persist.load(app2, str(p))
        sw = app2.switches[X.D.SWITCH_NAME]
        net = next(iter(sw.networks.values()))
        assert net.annotations[X.D.ANNO_NETWORK_ID] == NET_ID
        taps = [i for i in sw.list_ifaces() if i.name.startswith("tap:")]
        assert [t.annotations.get(X.D.ANNO_ENDPOINT_ID) for t in taps] == [
            EP_ID]
        # the reserved gateway mac survives the replay (Join finds the
        # gateway by mac)
        gws = [ip for ip, mac in net.ips.ips().items()
               if mac == X.D.GATEWAY_MAC]
        assert [socket.inet_ntoa(ip) for ip in gws] == ["172.28.0.1"]
    finally:
        app2.close()


# --------------------------------------------------------- cross-package


def request_sequence(with_tap: bool) -> list:
    """(route, body) pairs: the handshake, 4 networks (one dual-stack),
    every validation refusal, discovery, endpoint calls on missing
    ids, one network deleted; with a tap, an endpoint's create, oper
    info, join, leave and a second endpoint left in place."""
    seq = [("/Plugin.Activate", {}),
           ("/NetworkDriver.GetCapabilities", {}),
           ("/NetworkDriver.CreateNetwork", network_body(v6=True))]
    for i in range(3):
        seq.append(("/NetworkDriver.CreateNetwork", network_body(
            f"net{i}", f"172.29.{i}.0/24", f"172.29.{i}.1/24")))
    seq += [
        ("/NetworkDriver.CreateNetwork", {"NetworkID": "x",
                                          "IPv4Data": [], "IPv6Data": []}),
        ("/NetworkDriver.CreateNetwork", network_body(
            "x", "10.0.0.0/24", "10.9.9.9/24")),
        ("/NetworkDriver.CreateNetwork", network_body(
            "x", "10.0.0.0/24", "10.0.0.1/16")),
        ("/NetworkDriver.CreateNetwork", network_body("x", "fd00::/64",
                                                      "fd00::1/64")),
        ("/NetworkDriver.CreateNetwork", {"IPv4Data": []}),
        ("/NetworkDriver.DeleteNetwork", {"NetworkID": "nope"}),
        ("/NetworkDriver.DeleteNetwork", {"NetworkID": "net1"}),
        ("/NetworkDriver.DiscoverNew", {"DiscoveryType": 1}),
        ("/NetworkDriver.DiscoverDelete", {"DiscoveryType": 1}),
        ("/NetworkDriver.CreateEndpoint", {"NetworkID": NET_ID,
                                           "EndpointID": EP_ID}),
        ("/NetworkDriver.Join", {"NetworkID": NET_ID,
                                 "EndpointID": "missing",
                                 "SandboxKey": "/x/y"}),
        ("/NetworkDriver.Leave", {"NetworkID": NET_ID}),
        ("/NetworkDriver.DeleteEndpoint", {"NetworkID": "net0",
                                           "EndpointID": "missing"}),
    ]
    if with_tap:
        ep = {"NetworkID": NET_ID, "EndpointID": EP_ID}
        seq += [
            ("/NetworkDriver.CreateEndpoint", {**ep, "Interface": {
                "Address": "172.28.0.5/16", "AddressIPv6": "fd00:2800::5/64",
                "MacAddress": "02:42:ac:1c:00:05"}}),
            ("/NetworkDriver.EndpointOperInfo", ep),
            ("/NetworkDriver.Join", {**ep, "SandboxKey":
                                     "/var/run/docker/netns/abcd1234"}),
            ("/NetworkDriver.Leave", ep),
            ("/NetworkDriver.CreateEndpoint", {
                "NetworkID": "net2", "EndpointID": "e2" * 18,
                "Interface": {"Address": "172.29.2.9/24"}}),
        ]
    return seq


def drive(pkg: str, home, seq) -> tuple:
    """seq through `pkg`'s plugin (socket and scripts under `home`):
    every reply, and current_config with the switch's port masked."""
    X = pkg_ns(pkg)
    app = X.App.create(workers=1)
    try:
        path = str(home / "plugin.sock")
        X.Command.execute(app, "add docker-network-plugin-controller dk0 "
                               f"path {path}")
        replies = [uds_post(path, route, body) for route, body in seq]
        cfg = X.persist.current_config(app)
    finally:
        app.close()
    return replies, re.sub(r"address 127\.0\.0\.1:\d+",
                           "address 127.0.0.1:PORT", cfg)


def test_plugin_replies_and_config_equal_across_packages(tmp_path,
                                                         monkeypatch):
    """The same request sequence through the reference's and the
    port's plugin (in turn, on the same socket and script paths): the
    JSON replies equal, and the current_config texts equal but for the
    switch's bound port."""
    monkeypatch.setenv("VPROXY_TPU_DOCKER_SCRIPTS", str(tmp_path / "scr"))
    monkeypatch.setenv("VPROXY_TPU_DOCKER_SWITCH_ADDR", "127.0.0.1:0")
    seq = request_sequence(tap_supported())
    (r_ref, c_ref), (r_port, c_port) = (drive(p, tmp_path, seq)
                                        for p in PKGS)
    assert r_port == r_ref
    assert sum("Err" in r for r in r_ref) >= 9
    assert c_port == c_ref
    assert c_ref.count("add vpc ") == 3
    assert f"add docker-network-plugin-controller dk0 path " \
        f"{tmp_path / 'plugin.sock'}" in c_ref


def test_chip_smoke_docker_phase_on_cpu(tmp_path):
    """chip_smoke.py's `docker` phase small on the CPU: the controller
    by command, 8 networks over the socket, 56 routes by command, one
    route batch of 64 a VPC answered as the host CidrIndex answers,
    the engine dispatching every batch (the plain tier here: no kernel
    launches), the config replayed into a fresh Application; no tap
    device made."""
    import torch

    import chip_smoke as CS
    out = CS.phase_docker(torch.device("cpu"), batch=64)
    assert out["networks"] == 8 and out["routes"] == 56
    assert out["batches"] == 8 and out["engine_dispatches"] == 8
    assert out["answers"] == 8 * 64 and out["misses"] > 0
    assert out["launches"] == {"cidr_first": 0}
    assert out["replayed_vpcs"] == 8
    assert out["endpoint_lifecycle"].startswith("not run")
