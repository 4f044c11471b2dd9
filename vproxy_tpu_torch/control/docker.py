"""Docker libnetwork network plugin — networks become switch VPCs,
endpoints become tap devices.

Parity: app controller/DockerNetworkPluginController.java:20-286 (the
unix-socket HTTP endpoint speaking the libnetwork remote-driver
protocol, https://github.com/moby/libnetwork/blob/master/docs/remote.md)
and controller/DockerNetworkDriverImpl.java:22-421 (the driver: a
dedicated switch "DockerNetworkDriverSW"; CreateNetwork -> VPC with the
networkId kept as an annotation + a gateway synthetic IP under the
reserved gateway mac; CreateEndpoint -> tap named tap<endpointId[:12]>
with a per-endpoint post script; Join -> writes the netns-move post
script and answers docker with the interface name + gateways).

The port's copy of vproxy_tpu/control/docker.py, same names and behaviour.
"""
from __future__ import annotations

import json
import os
import stat
from typing import Optional

from ..lib.vserver import HttpServer, RoutingContext
from ..utils.ip import Network, format_ip, parse_ip
from ..utils.log import Logger

_log = Logger("docker")

SWITCH_NAME = "DockerNetworkDriverSW"
GATEWAY_MAC = bytes([0x02, 0x00, 0x00, 0x00, 0x00, 0x20])

ANNO_NETWORK_ID = "docker/network-id"
ANNO_ENDPOINT_ID = "docker/endpoint-id"
ANNO_ENDPOINT_IPV4 = "docker/endpoint-ipv4"
ANNO_ENDPOINT_IPV6 = "docker/endpoint-ipv6"
ANNO_ENDPOINT_MAC = "docker/endpoint-mac"

DEFAULT_SCRIPT_DIR = "/var/vproxy_tpu/docker-network-plugin/post-scripts"


class DockerError(Exception):
    """Driver-level failure reported to docker as {"Err": msg}."""


def _split_gateway(gateway: str, pool: Network, family: str) -> bytes:
    """Validate `a.b.c.d[/m]` against the pool; -> raw gateway ip."""
    ip_s, slash, mask_s = gateway.partition("/")
    if slash:
        try:
            mask = int(mask_s)
        except ValueError:
            raise DockerError(f"invalid format for {family} gateway {gateway}")
        if mask != pool.masklen:
            raise DockerError(f"the gateway mask {mask} must be the same "
                              f"as the network {pool.masklen}")
    try:
        ip = parse_ip(ip_s)
    except ValueError:
        raise DockerError(f"{family} gateway is not a valid ip address {gateway}")
    if not pool.contains_ip(ip):
        raise DockerError(f"the cidr {pool} does not contain the gateway {gateway}")
    return ip


class DockerNetworkDriver:
    """The switch-driving half (DockerNetworkDriverImpl.java)."""

    def __init__(self, app, script_dir: Optional[str] = None,
                 switch_addr: Optional[str] = None):
        self.app = app
        self.script_dir = script_dir or os.environ.get(
            "VPROXY_TPU_DOCKER_SCRIPTS", DEFAULT_SCRIPT_DIR)
        addr = switch_addr or os.environ.get(
            "VPROXY_TPU_DOCKER_SWITCH_ADDR", "127.7.7.7:7777")
        ip, _, port = addr.rpartition(":")
        self.switch_ip, self.switch_port = ip, int(port)

    # ------------------------------------------------------------- switch

    def ensure_switch(self):
        """Get or lazily create the plugin's dedicated switch
        (DockerNetworkDriverImpl.ensureSwitch :167-189)."""
        sw = self.app.switches.get(SWITCH_NAME)
        if sw is not None:
            return sw
        from ..vswitch.switch import Switch
        elg = self.app.worker_elg
        sw = Switch(SWITCH_NAME, elg.next(), self.switch_ip, self.switch_port,
                    elg=elg)
        sw.start()
        self.app.switches[SWITCH_NAME] = sw
        _log.info(f"switch {SWITCH_NAME} created")
        return sw

    def _find_network(self, sw, network_id: str):
        for net in sw.networks.values():
            if net.annotations.get(ANNO_NETWORK_ID) == network_id:
                return net
        raise DockerError(f"network {network_id} not found")

    def _find_endpoint(self, sw, endpoint_id: str):
        from ..vswitch.iface import TapIface
        for iface in sw.list_ifaces():
            if isinstance(iface, TapIface) and \
                    iface.annotations.get(ANNO_ENDPOINT_ID) == endpoint_id:
                return iface
        raise DockerError(f"endpoint {endpoint_id} not found")

    def _script_path(self, endpoint_id: str) -> str:
        return os.path.join(self.script_dir, endpoint_id)

    def _ensure_post_script(self, endpoint_id: str, content: str) -> str:
        os.makedirs(self.script_dir, exist_ok=True)
        path = self._script_path(endpoint_id)
        with open(path, "w") as f:
            f.write(content)
        os.chmod(path, os.stat(path).st_mode
                 | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
        return path

    # ------------------------------------------------------------ network

    def create_network(self, network_id: str, ipv4_data: list,
                       ipv6_data: list) -> None:
        if len(ipv4_data) > 1:
            raise DockerError("we only support at most one ipv4 cidr in one network")
        if len(ipv6_data) > 1:
            raise DockerError("we only support at most one ipv6 cidr in one network")
        if not ipv4_data:
            raise DockerError("no ipv4 network info provided")

        def check(data: dict, family: str, ver_len: int):
            if data.get("AuxAddresses"):
                raise DockerError("auxAddresses are not supported")
            try:
                pool = Network.parse(data["Pool"])
            except (ValueError, KeyError):
                raise DockerError(
                    f"{family} network is not a valid cidr {data.get('Pool')}")
            if len(pool.ip) != ver_len:
                raise DockerError(f"address {data['Pool']} is not {family} cidr")
            gw = _split_gateway(data.get("Gateway", ""), pool, family)
            return pool, gw

        v4pool, v4gw = check(ipv4_data[0], "ipv4", 4)
        v6pool = v6gw = None
        if ipv6_data:
            v6pool, v6gw = check(ipv6_data[0], "ipv6", 16)

        sw = self.ensure_switch()
        vni = max(sw.networks, default=0) + 1
        net = sw.add_network(vni, v4pool, v6pool,
                             annotations={ANNO_NETWORK_ID: network_id})
        _log.info(f"vpc added: vni={vni} v4={v4pool} v6={v6pool} "
                  f"docker:networkId={network_id}")
        net.ips.add(v4gw, GATEWAY_MAC)
        if v6gw is not None:
            net.ips.add(v6gw, GATEWAY_MAC)

    def delete_network(self, network_id: str) -> None:
        sw = self.ensure_switch()
        net = self._find_network(sw, network_id)
        sw.del_network(net.vni)
        _log.info(f"vpc deleted: vni={net.vni} docker:networkId={network_id}")

    # ----------------------------------------------------------- endpoint

    def create_endpoint(self, network_id: str, endpoint_id: str,
                        address: Optional[str], address_v6: Optional[str],
                        mac: Optional[str]) -> None:
        if not address:
            raise DockerError("ipv4 must be provided")
        sw = self.ensure_switch()
        net = self._find_network(sw, network_id)
        if address_v6 and net.v6net is None:
            raise DockerError(f"network {network_id} does not support ipv6")

        anno = {ANNO_ENDPOINT_ID: endpoint_id, ANNO_ENDPOINT_IPV4: address}
        if address_v6:
            anno[ANNO_ENDPOINT_IPV6] = address_v6
        if mac:
            anno[ANNO_ENDPOINT_MAC] = mac

        script = self._ensure_post_script(endpoint_id, "")
        name = "tap" + endpoint_id[:12]
        try:
            iface = sw.add_tap(name, net.vni, post_script=script,
                               annotations=anno)
        except OSError:
            # failed creates get no DeleteEndpoint from docker: don't
            # leave a stray script behind
            try:
                os.unlink(script)
            except OSError:
                pass
            raise
        _log.info(f"tap added: {iface.dev} vni={net.vni} "
                  f"endpointId={endpoint_id} ipv4={address} "
                  f"ipv6={address_v6} mac={mac}")

    def delete_endpoint(self, network_id: str, endpoint_id: str) -> None:
        sw = self.ensure_switch()
        self._find_network(sw, network_id)
        tap = self._find_endpoint(sw, endpoint_id)
        sw.remove_iface(f"tap:{tap.dev}")
        _log.info(f"tap deleted: {tap.dev} endpointId={endpoint_id}")
        try:
            os.unlink(self._script_path(endpoint_id))
        except OSError:
            pass

    # --------------------------------------------------------------- join

    def _gateways(self, net) -> tuple[Optional[str], Optional[str]]:
        gw4 = gw6 = None
        for ip, mac in net.ips.ips().items():
            if mac != GATEWAY_MAC:
                continue
            if len(ip) == 4:
                gw4 = format_ip(ip)
            else:
                gw6 = format_ip(ip)
        return gw4, gw6

    def join(self, network_id: str, endpoint_id: str, sandbox_key: str) -> dict:
        sw = self.ensure_switch()
        net = self._find_network(sw, network_id)
        tap = self._find_endpoint(sw, endpoint_id)
        ipv4 = tap.annotations.get(ANNO_ENDPOINT_IPV4)
        ipv6 = tap.annotations.get(ANNO_ENDPOINT_IPV6)
        mac = tap.annotations.get(ANNO_ENDPOINT_MAC)
        gw4, gw6 = self._gateways(net)
        if gw4 is None:
            raise DockerError(f"ipv4 gateway not found in network {network_id}")
        if ipv6 and gw6 is None:
            raise DockerError(f"ipv6 gateway not found in network {network_id}")

        self._ensure_post_script(
            endpoint_id, self._join_script(endpoint_id, sandbox_key,
                                           ipv4, ipv6, mac, gw4, gw6))
        resp = {
            "InterfaceName": {"SrcName": tap.dev, "DstPrefix": "eth"},
            "Gateway": gw4,
            "StaticRoutes": [],
        }
        if gw6 and ipv6:
            resp["GatewayIPv6"] = gw6
        return resp

    def _join_script(self, endpoint_id: str, sandbox_key: str,
                     ipv4: str, ipv6: Optional[str], mac: Optional[str],
                     gw4: str, gw6: Optional[str]) -> str:
        """Re-attach script run when the tap is (re)created: moves $DEV
        into the container netns, renames it to the first free ethN and
        configures addresses/routes (DockerNetworkDriverImpl.join
        :343-404). Needed so a plugin restart restores container
        connectivity; a no-op once the sandbox is gone."""
        alias = sandbox_key.rsplit("/", 1)[-1]
        lines = [
            "#!/bin/bash",
            "set -e",
            f"if [ ! -f {sandbox_key} ]; then",
            f"  rm -f {self._script_path(endpoint_id)}",
            "  exit 0",
            "fi",
            "mkdir -p /var/run/netns",
            f"[ -e /var/run/netns/{alias} ] || ln -s {sandbox_key} /var/run/netns/{alias}",
            f"ip link set $DEV netns {alias}",
            # rename to the first eth<N> not taken inside the netns
            f"used=`ip netns exec {alias} ip -o link show | awk -F': ' '{{print $2}}'`",
            "n=0",
            'while echo "$used" | grep -qx "eth$n"; do n=$((n + 1)); done',
            f'ip netns exec {alias} ip link set $DEV name "eth$n"',
            'DEV="eth$n"',
        ]
        if mac:
            lines.append(f"ip netns exec {alias} ip link set $DEV address {mac}")
        lines += [
            f"ip netns exec {alias} ip link set $DEV up",
            f"ip netns exec {alias} ip address add {ipv4} dev $DEV",
            f"ip netns exec {alias} ip route add default via {gw4} dev $DEV",
        ]
        if ipv6:
            lines += [
                f"ip netns exec {alias} sysctl -w net.ipv6.conf.$DEV.disable_ipv6=0",
                f"ip netns exec {alias} ip -6 address add {ipv6} dev $DEV",
                f"ip netns exec {alias} ip -6 route add default via {gw6} dev $DEV",
            ]
        lines.append(f"rm -f /var/run/netns/{alias}")
        return "\n".join(lines) + "\n"

    def leave(self, network_id: str, endpoint_id: str) -> None:
        self._ensure_post_script(endpoint_id, "")


class DockerNetworkPluginController:
    """The unix-socket HTTP half (DockerNetworkPluginController.java).

    Driver calls run on a dedicated serializing thread, not the control
    loop: tap post-scripts may block for seconds (netns operations) and
    must not stall RESP/HTTP control traffic. Responses complete back on
    the loop; request order is preserved (the reference serializes with
    `synchronized` driver methods)."""

    def __init__(self, app, alias: str, path: str,
                 driver: Optional[DockerNetworkDriver] = None):
        import queue
        import threading
        self.app = app
        self.alias = alias
        self.path = path
        self.driver = driver or DockerNetworkDriver(app)
        self._jobs: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._drain, daemon=True,
                                        name=f"docker-driver-{alias}")
        self._worker.start()
        srv = HttpServer(app.control_loop)
        srv.post("/Plugin.Activate", self._activate)
        srv.post("/NetworkDriver.GetCapabilities", self._capabilities)
        srv.post("/NetworkDriver.CreateNetwork", self._create_network)
        srv.post("/NetworkDriver.DeleteNetwork", self._delete_network)
        srv.post("/NetworkDriver.CreateEndpoint", self._create_endpoint)
        srv.post("/NetworkDriver.EndpointOperInfo", self._oper_info)
        srv.post("/NetworkDriver.DeleteEndpoint", self._delete_endpoint)
        srv.post("/NetworkDriver.Join", self._join)
        srv.post("/NetworkDriver.Leave", self._leave)
        srv.post("/NetworkDriver.DiscoverNew", self._discover)
        srv.post("/NetworkDriver.DiscoverDelete", self._discover)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        srv.listen_unix(path)
        self.server = srv

    def stop(self) -> None:
        # synchronous: `remove` must not report OK while the socket file
        # still accepts connections
        self.server.close(sync=True)
        self._jobs.put(None)

    def _drain(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            job()

    # ----------------------------------------------------------- handlers

    @staticmethod
    def _body(rctx: RoutingContext) -> dict:
        try:
            b = rctx.req.json()
            return b if isinstance(b, dict) else {}
        except (ValueError, json.JSONDecodeError):
            return {}

    def _activate(self, rctx: RoutingContext) -> None:
        rctx.resp.end({"Implements": ["NetworkDriver"]})

    def _capabilities(self, rctx: RoutingContext) -> None:
        rctx.resp.end({"Scope": "local", "ConnectivityScope": "local"})

    def _run(self, rctx: RoutingContext, fn, ok=None) -> None:
        def job() -> None:
            try:
                out = fn()
                res = out if out is not None else (ok or {})
            except DockerError as e:
                res = {"Err": str(e)}
            except Exception as e:  # switch/tap/OS failure
                _log.alert(f"docker driver error: {e!r}")
                res = {"Err": f"{type(e).__name__}: {e}"}
            # response completion must happen on the loop that owns the conn
            self.app.control_loop.run_on_loop(lambda: rctx.resp.end(res))
        self._jobs.put(job)

    def _create_network(self, rctx: RoutingContext) -> None:
        b = self._body(rctx)
        if "NetworkID" not in b:
            rctx.resp.end({"Err": "invalid request body"})
            return
        self._run(rctx, lambda: self.driver.create_network(
            b["NetworkID"], b.get("IPv4Data") or [], b.get("IPv6Data") or []))

    def _delete_network(self, rctx: RoutingContext) -> None:
        b = self._body(rctx)
        if "NetworkID" not in b:
            rctx.resp.end({"Err": "invalid request body"})
            return
        self._run(rctx, lambda: self.driver.delete_network(b["NetworkID"]))

    def _create_endpoint(self, rctx: RoutingContext) -> None:
        b = self._body(rctx)
        if "NetworkID" not in b or "EndpointID" not in b:
            rctx.resp.end({"Err": "invalid request body"})
            return
        itf = b.get("Interface") or {}
        if not itf:
            rctx.resp.end({"Err": "we do not support auto ip allocation for now"})
            return
        self._run(rctx, lambda: self.driver.create_endpoint(
            b["NetworkID"], b["EndpointID"], itf.get("Address"),
            itf.get("AddressIPv6"), itf.get("MacAddress")))

    def _oper_info(self, rctx: RoutingContext) -> None:
        rctx.resp.end({"Value": {}})

    def _delete_endpoint(self, rctx: RoutingContext) -> None:
        b = self._body(rctx)
        if "NetworkID" not in b or "EndpointID" not in b:
            rctx.resp.end({"Err": "invalid request body"})
            return
        self._run(rctx, lambda: self.driver.delete_endpoint(
            b["NetworkID"], b["EndpointID"]))

    def _join(self, rctx: RoutingContext) -> None:
        b = self._body(rctx)
        if not all(k in b for k in ("NetworkID", "EndpointID", "SandboxKey")):
            rctx.resp.end({"Err": "invalid request body"})
            return
        self._run(rctx, lambda: self.driver.join(
            b["NetworkID"], b["EndpointID"], b["SandboxKey"]))

    def _leave(self, rctx: RoutingContext) -> None:
        b = self._body(rctx)
        if "NetworkID" not in b or "EndpointID" not in b:
            rctx.resp.end({"Err": "invalid request body"})
            return
        self._run(rctx, lambda: self.driver.leave(
            b["NetworkID"], b["EndpointID"]))

    def _discover(self, rctx: RoutingContext) -> None:
        # local-scope driver: discovery events are acknowledged, unused
        rctx.resp.end({})
