"""Command engine — the operator-facing grammar.

Parity: app cmd/Command.java (parse+validate+dispatch, 8 actions) and
cmd/handle/resource/* handlers, with the same vocabulary as
doc/command.md:

    $action $type [$alias] [in $type $alias] [to|from $type $alias]
            [$param-key $param-value]... [$flag]...

Actions: add(a), list(l), list-detail(L), update(u), remove(r),
force-remove(R); `add ... to ...` attaches, `remove ... from ...`
detaches. All controllers (stdio / RESP / HTTP) funnel into
Command.execute on the control loop, mirroring the reference's
control-plane isolation (doc/architecture.md:64-66).

The port's copy of vproxy_tpu/control/command.py: the same grammar
(ACTIONS, TYPES, PARAM_KEYS, FLAGS, the bare verbs) and the same
resource-type inventory. The handlers of the types whose subsystems
are not ported yet (NOT_PORTED: the cluster plane, the docker plugin)
raise CmdError("<type>: not ported yet (ROADMAP
Queue A item N)") for every action; everything else is the
reference's. No cluster node can boot in the port, so `app.cluster`
stays None and the leader/follower replication hook of
Command.execute is not carried over.

`list-detail upstream` prints the serving backend's name (`backend
torch` here, `backend jax` in the reference) and the fused tier's name
inside `fused on(<kernel>,...)` (`cuda` or `torch` here, `jit` or
`pallas` there). Both name what serves the table, not what it holds:
a cross-package diff masks those two tokens and nothing else (rules,
generation, table bytes, checksum and packed bytes stay equal).
"""
from __future__ import annotations

import json
from typing import Optional

from ..components.secgroup import SecurityGroup
from ..components.servergroup import HealthCheckConfig, ServerGroup
from ..components.socks5 import Socks5Server
from ..components.tcplb import TcpLB
from ..components.upstream import Upstream
from ..components.elgroup import EventLoopGroup
from ..dns.server import DNSServer
from ..rules.ir import AclRule, HintRule, Proto
from ..utils.ip import Network, format_ip
from .app import (Application, DEFAULT_ACCEPTOR_ELG, DEFAULT_WORKER_ELG)

ACTIONS = {"add": "add", "a": "add", "list": "list", "l": "list",
           "list-detail": "list-detail", "L": "list-detail",
           "update": "update", "u": "update", "remove": "remove",
           "r": "remove", "force-remove": "force-remove", "R": "force-remove"}

TYPES = {
    "tcp-lb": "tcp-lb", "tl": "tcp-lb",
    "socks5-server": "socks5-server", "socks5": "socks5-server",
    "dns-server": "dns-server", "dns": "dns-server",
    "event-loop-group": "event-loop-group", "elg": "event-loop-group",
    "event-loop": "event-loop", "el": "event-loop",
    "upstream": "upstream", "ups": "upstream",
    "server-group": "server-group", "sg": "server-group",
    "server": "server", "svr": "server",
    "security-group": "security-group", "secg": "security-group",
    "security-group-rule": "security-group-rule", "secgr": "security-group-rule",
    "cert-key": "cert-key", "ck": "cert-key",
    "switch": "switch", "sw": "switch",
    "vpc": "vpc",
    "iface": "iface",
    "route": "route",
    "arp": "arp",
    "user": "user",
    "user-client": "user-client", "ucli": "user-client",
    "tap": "tap",
    "ip": "ip",
    "server-sock": "server-sock", "ss": "server-sock",
    "connection": "connection", "conn": "connection",
    "session": "session", "sess": "session",
    "bytes-in": "bytes-in", "bin": "bytes-in",
    "bytes-out": "bytes-out", "bout": "bytes-out",
    "accepted-conn-count": "accepted-conn-count",
    "dns-cache": "dns-cache",
    "resolver": "resolver",
    "proxy": "proxy",
    "resp-controller": "resp-controller",
    "http-controller": "http-controller",
    "docker-network-plugin-controller": "docker-network-plugin-controller",
    "event-log": "event-log", "events": "event-log",
    "fault": "fault", "failpoint": "fault",
    "cluster-node": "cluster-node", "cn": "cluster-node",
    "trace": "trace",
    "analytics": "analytics",
    "policy": "policy", "pol": "policy",
}

PARAM_KEYS = {
    "address": "address", "addr": "address",
    "upstream": "upstream", "ups": "upstream",
    "event-loop-group": "elg", "elg": "elg",
    "acceptor-elg": "aelg", "aelg": "aelg",
    "in-buffer-size": "in-buffer-size", "out-buffer-size": "out-buffer-size",
    "protocol": "protocol",
    "security-group": "secg", "secg": "secg",
    "cert-key": "ck", "ck": "ck",
    "cert": "cert", "key": "key",
    "ttl": "ttl", "timeout": "timeout", "period": "period",
    "up": "up", "down": "down", "method": "method",
    "weight": "weight", "w": "weight",
    "annotations": "annotations", "default": "default",
    "network": "network", "net": "network",
    "port-range": "port-range",
    "vni": "vni", "v4network": "v4network", "v6network": "v6network",
    "password": "password", "pass": "password",
    "via": "via", "mac": "mac",
    "mac-table-timeout": "mac-table-timeout",
    "arp-table-timeout": "arp-table-timeout",
    "path": "path", "post-script": "post-script",
    "probability": "probability", "prob": "probability",
    "count": "count", "match": "match",
    "max-sessions": "max-sessions",
    "pool-size": "pool-size",
    "lanes": "lanes",
    "overload": "overload",
    "seed": "seed",
    "plane": "plane",
    "since": "since", "until": "until",
    "dim": "dim", "rate": "rate", "burst": "burst",
    "action": "action", "tenant": "tenant",
}

FLAGS = {"allow-non-backend", "deny-non-backend", "noipv4", "noipv6"}

ANNO_HOST = "vproxy/hint-host"
ANNO_PORT = "vproxy/hint-port"
ANNO_URI = "vproxy/hint-uri"


class CmdError(Exception):
    pass


class Command:
    def __init__(self):
        self.action = ""
        self.type = ""
        self.alias: Optional[str] = None
        self.contexts: list[tuple[str, str]] = []  # `in` chain, innermost first
        self.target: Optional[tuple[str, str]] = None  # to/from
        self.params: dict[str, str] = {}
        self.flags: set[str] = set()

    # ------------------------------------------------------------ parsing

    @staticmethod
    def parse(line: str) -> "Command":
        toks = line.split()
        if not toks:
            raise CmdError("empty command")
        c = Command()
        if toks[0] not in ACTIONS:
            raise CmdError(f"unknown action {toks[0]!r}")
        c.action = ACTIONS[toks[0]]
        if len(toks) < 2 or toks[1] not in TYPES:
            raise CmdError(f"unknown resource type {toks[1] if len(toks) > 1 else ''!r}")
        c.type = TYPES[toks[1]]
        i = 2
        if c.action not in ("list", "list-detail"):
            if i >= len(toks):
                raise CmdError("resource alias required")
            c.alias = toks[i]
            i += 1
        while i < len(toks):
            t = toks[i]
            if t == "in":
                if i + 2 >= len(toks) - 0 and i + 2 > len(toks) - 1:
                    raise CmdError("`in` requires type and alias")
                if toks[i + 1] not in TYPES:
                    raise CmdError(f"unknown resource type {toks[i+1]!r}")
                c.contexts.append((TYPES[toks[i + 1]], toks[i + 2]))
                i += 3
            elif t in ("to", "from"):
                if i + 2 > len(toks) - 1:
                    raise CmdError(f"`{t}` requires type and alias")
                if toks[i + 1] not in TYPES:
                    raise CmdError(f"unknown resource type {toks[i+1]!r}")
                c.target = (TYPES[toks[i + 1]], toks[i + 2])
                i += 3
            elif t in PARAM_KEYS:
                if i + 1 > len(toks) - 1:
                    raise CmdError(f"param {t} requires a value")
                key = PARAM_KEYS[t]
                val = toks[i + 1]
                # annotations value is json and may contain spaces: re-join
                if key == "annotations" and val.startswith("{") and not val.endswith("}"):
                    j = i + 2
                    while j < len(toks) and not toks[j - 1].endswith("}"):
                        val += " " + toks[j]
                        j += 1
                    i = j - 2
                c.params[key] = val
                i += 2
            elif t in FLAGS:
                c.flags.add(t)
                i += 1
            elif "=" in t and t.split("=", 1)[0] in PARAM_KEYS:
                # k=v param form (`add policy gold dim=clients rate=50
                # burst=100 action=shed`): same keys, same params dict —
                # the compact spelling the policing grammar and the
                # persisted command log use
                k, v = t.split("=", 1)
                if not v:
                    raise CmdError(f"param {k} requires a value")
                c.params[PARAM_KEYS[k]] = v
                i += 1
            else:
                raise CmdError(f"unexpected token {t!r}")
        return c

    # ---------------------------------------------------------- execution

    @staticmethod
    def execute(app: Application, line: str):
        if line.strip() == "drain":
            # bare verb outside the resource grammar (like the repl's
            # `exit`): begin graceful drain — close listeners, flip
            # /healthz to draining, let pumps finish, then main exits
            return app.request_drain()
        toks = line.split()
        if toks and toks[0] == "top" and len(toks) <= 3:
            # `top [clients|backends|routes|flows|qnames] [fleet]`: the
            # heavy-hitter table of one dimension (utils/sketch), local
            # or fleet-merged. Bare verb like `drain`/`trace <id>`;
            # `list[-detail] analytics` is the full-surface view.
            from ..utils import sketch as SK
            if len(toks) == 1:
                raise CmdError("top requires a dimension: "
                               + "|".join(SK.DIMS))
            dim = toks[1]
            if dim not in SK.DIMS:
                raise CmdError(f"unknown top dimension {dim!r} "
                               f"(one of {', '.join(SK.DIMS)})")
            if len(toks) == 3 and toks[2] != "fleet":
                raise CmdError(f"unexpected token {toks[2]!r} "
                               "(only `fleet`)")
            if not SK.enabled():
                return ["analytics disabled (VPROXY_TPU_ANALYTICS=0)"]
            if len(toks) == 3:
                # no cluster node boots in the port (ROADMAP Queue A
                # item 8): the reference's answer without one
                raise CmdError("no cluster plane booted; `top "
                               f"{dim}` serves the local view")
            return SK.render_top(dim)
        if len(toks) == 2 and toks[0] == "trace":
            # `trace <id>`: one sampled request's span waterfall (the
            # cross-plane attribution view — utils/trace). Bare verb
            # like `drain`; `list[-detail] trace` lists the buffer.
            from ..utils import trace as TR
            try:
                tid = int(toks[1])
            except ValueError:
                raise CmdError(f"trace id must be an integer, "
                               f"got {toks[1]!r}")
            return TR.waterfall(tid)
        if toks and toks[0] == "capture" and len(toks) <= 3:
            # `capture start|stop|export|status [seed <n>]`: the
            # workload-capture window (utils/workload). Bare verb like
            # `drain`/`top`; export prints the versioned model JSON a
            # replay run consumes (docs/replay.md), with the seed
            # stamped in so the artifact carries its own determinism.
            from ..utils import workload as WL
            if len(toks) == 1:
                raise CmdError("capture requires a verb: "
                               "start|stop|export|status")
            verb, seed = toks[1], None
            if len(toks) == 3:
                k, _, v = toks[2].partition("=")
                if k != "seed" or not v:
                    raise CmdError(f"unexpected token {toks[2]!r} "
                                   "(only seed=<int>)")
                try:
                    seed = int(v)
                except ValueError:
                    raise CmdError(f"seed must be an integer, got {v!r}")
            try:
                out = WL.capture(verb, seed=seed)
            except ValueError as e:
                raise CmdError(str(e))
            if verb == "export":
                return [WL.WorkloadModel(out).to_json()]
            return [f"capture {out['state']} "
                    f"(enabled={out['enabled']}, "
                    f"window={out['window_s']}s)"]
        c = Command.parse(line)
        handler = _HANDLERS.get(c.type)
        if handler is None:
            raise CmdError(f"no handler for resource type {c.type}")
        return handler(app, c)


# ---------------------------------------------------------------- helpers

def _need(app_dict: dict, alias: str, kind: str):
    if alias not in app_dict:
        raise CmdError(f"{kind} {alias!r} not found")
    return app_dict[alias]


def _opt_elg(app: Application, c: Command, key: str, default):
    if key not in c.params:
        return default
    return _need(app.elgs, c.params[key], "event-loop-group")


def _opt_secg(app: Application, c: Command):
    if "secg" not in c.params:
        return None
    return _need(app.security_groups, c.params["secg"], "security-group")


def _addr(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    try:
        return host, int(port)
    except ValueError:
        raise CmdError(f"invalid address {s!r}")


def _anno_to_rule(anno_json: str) -> HintRule:
    try:
        d = json.loads(anno_json)
    except json.JSONDecodeError as e:
        raise CmdError(f"annotations must be json: {e}")
    return HintRule(host=d.get(ANNO_HOST), port=int(d.get(ANNO_PORT, 0)),
                    uri=d.get(ANNO_URI))


def _anno_dict(raw: str) -> dict:
    """Generic annotations param (json object) for vpc/tap resources."""
    try:
        d = json.loads(raw)
    except json.JSONDecodeError:
        raise CmdError(f"bad annotations json {raw!r}")
    if not isinstance(d, dict):
        raise CmdError("annotations must be a json object")
    return d


def _rule_to_anno(rule: HintRule) -> str:
    d = {}
    if rule.host is not None:
        d[ANNO_HOST] = rule.host
    if rule.port:
        d[ANNO_PORT] = str(rule.port)
    if rule.uri is not None:
        d[ANNO_URI] = rule.uri
    return json.dumps(d, separators=(",", ":"))


# ---------------------------------------------------------------- handlers

def _h_elg(app: Application, c: Command):
    if c.action == "add":
        if c.alias in app.elgs:
            raise CmdError(f"event-loop-group {c.alias} already exists")
        app.elgs[c.alias] = EventLoopGroup(c.alias, 0)
        return "OK"
    if c.action in ("list", "list-detail"):
        return list(app.elgs.keys())
    if c.action in ("remove", "force-remove"):
        elg = _need(app.elgs, c.alias, "event-loop-group")
        if c.alias in (DEFAULT_WORKER_ELG, DEFAULT_ACCEPTOR_ELG, "(control-elg)"):
            raise CmdError(f"cannot remove built-in {c.alias}")
        elg.close()
        del app.elgs[c.alias]
        return "OK"
    raise CmdError(f"unsupported action {c.action} for event-loop-group")


def _h_el(app: Application, c: Command):
    ctx = c.target or (c.contexts[0] if c.contexts else None)
    if ctx is None or ctx[0] != "event-loop-group":
        raise CmdError("event-loop requires `in/to event-loop-group <name>`")
    elg = _need(app.elgs, ctx[1], "event-loop-group")
    if c.action == "add":
        elg.add_loop(c.alias)
        return "OK"
    if c.action in ("list", "list-detail"):
        return elg.loop_names()
    if c.action in ("remove", "force-remove"):
        try:
            elg.remove_loop(c.alias)
        except KeyError:
            raise CmdError(f"event-loop {c.alias!r} not found")
        return "OK"
    raise CmdError(f"unsupported action {c.action} for event-loop")


def _h_ups(app: Application, c: Command):
    if c.action == "add":
        if c.alias in app.upstreams:
            raise CmdError(f"upstream {c.alias} already exists")
        app.upstreams[c.alias] = Upstream(c.alias)
        return "OK"
    if c.action in ("list", "list-detail"):
        if c.action == "list":
            return list(app.upstreams.keys())
        out = []
        for u in app.upstreams.values():
            m = u._matcher
            fs = m.fused_stat() if hasattr(m, "fused_stat") \
                else {"available": False}
            fused = (f"fused on({fs.get('kernel')},"
                     f"{fs.get('packed_bytes', 0)}B)"
                     if fs.get("available") else "fused off")
            out.append(
                f"{u.alias} -> groups {len(u.handles)} backend {m.backend} "
                f"rules {m.size()} generation {m.generation} "
                f"table-bytes {m.published_table_bytes()} "
                f"checksum {m.checksum():#010x} {fused}")
        return out
    if c.action in ("remove", "force-remove"):
        ups = _need(app.upstreams, c.alias, "upstream")
        if c.action == "remove":
            users = [lb.alias for lb in list(app.tcp_lbs.values())
                     + list(app.socks5_servers.values()) if lb.backend is ups]
            users += [d.alias for d in app.dns_servers.values() if d.rrsets is ups]
            if users:
                raise CmdError(f"upstream {c.alias} is in use by {users}")
        del app.upstreams[c.alias]
        return "OK"
    raise CmdError(f"unsupported action {c.action} for upstream")


def _h_sg(app: Application, c: Command):
    if c.action == "add" and c.target is not None:
        # attach: add server-group sg0 to upstream ups0 weight 10
        if c.target[0] != "upstream":
            raise CmdError("server-group can only be attached to upstream")
        sg = _need(app.server_groups, c.alias, "server-group")
        ups = _need(app.upstreams, c.target[1], "upstream")
        weight = int(c.params.get("weight", 10))
        anno = _anno_to_rule(c.params["annotations"]) if "annotations" in c.params else None
        ups.add(sg, weight, anno)
        return "OK"
    if c.action == "add":
        if c.alias in app.server_groups:
            raise CmdError(f"server-group {c.alias} already exists")
        hc = HealthCheckConfig(
            timeout_ms=int(c.params.get("timeout", 2000)),
            period_ms=int(c.params.get("period", 5000)),
            up=int(c.params.get("up", 2)),
            down=int(c.params.get("down", 3)),
            protocol=c.params.get("protocol", "tcp"))
        elg = _opt_elg(app, c, "elg", app.worker_elg)
        anno = _anno_to_rule(c.params["annotations"]) if "annotations" in c.params else None
        app.server_groups[c.alias] = ServerGroup(
            c.alias, elg, hc, c.params.get("method", "wrr"), anno)
        return "OK"
    if c.action in ("list", "list-detail"):
        if c.contexts and c.contexts[0][0] == "upstream":
            ups = _need(app.upstreams, c.contexts[0][1], "upstream")
            if c.action == "list":
                return [h.alias for h in ups.handles]
            return [f"{h.alias} -> weight {h.weight} annotations {_rule_to_anno(h.merged_rule())}"
                    for h in ups.handles]
        if c.action == "list":
            return list(app.server_groups.keys())
        out = []
        for g in app.server_groups.values():
            out.append(f"{g.alias} -> timeout {g.hc.timeout_ms} period {g.hc.period_ms} "
                       f"up {g.hc.up} down {g.hc.down} protocol {g.hc.protocol} "
                       f"method {g.method} event-loop-group {g.elg.name} "
                       f"annotations {_rule_to_anno(g.annotations)}")
        return out
    if c.action == "update":
        sg = _need(app.server_groups, c.alias, "server-group")
        if c.contexts and c.contexts[0][0] == "upstream":
            ups = _need(app.upstreams, c.contexts[0][1], "upstream")
            for h in ups.handles:
                if h.group is sg:
                    if "weight" in c.params:
                        h.weight = int(c.params["weight"])
                    if "annotations" in c.params:
                        h.annotations = _anno_to_rule(c.params["annotations"])
                    ups._recalc()
                    return "OK"
            raise CmdError(f"server-group {c.alias} not attached to {c.contexts[0][1]}")
        if any(k in c.params for k in ("timeout", "period", "up", "down", "protocol")):
            sg.hc = HealthCheckConfig(
                timeout_ms=int(c.params.get("timeout", sg.hc.timeout_ms)),
                period_ms=int(c.params.get("period", sg.hc.period_ms)),
                up=int(c.params.get("up", sg.hc.up)),
                down=int(c.params.get("down", sg.hc.down)),
                protocol=c.params.get("protocol", sg.hc.protocol))
        if "method" in c.params:
            if c.params["method"] not in ServerGroup.METHODS:
                raise CmdError(f"unknown method {c.params['method']}")
            sg.method = c.params["method"]
        if "annotations" in c.params:
            sg.annotations = _anno_to_rule(c.params["annotations"])
            for ups in app.upstreams.values():
                if any(h.group is sg for h in ups.handles):
                    ups._recalc()
        return "OK"
    if c.action in ("remove", "force-remove"):
        sg = _need(app.server_groups, c.alias, "server-group")
        if c.target is not None:  # remove ... from upstream
            if c.target[0] != "upstream":
                raise CmdError("server-group can only be detached from upstream")
            ups = _need(app.upstreams, c.target[1], "upstream")
            ups.remove(sg)
            return "OK"
        users = [u.alias for u in app.upstreams.values()
                 if any(h.group is sg for h in u.handles)]
        if users and c.action == "remove":
            raise CmdError(f"server-group {c.alias} is in use by upstream {users}")
        for u in app.upstreams.values():
            if any(h.group is sg for h in u.handles):
                u.remove(sg)
        sg.close()
        del app.server_groups[c.alias]
        return "OK"
    raise CmdError(f"unsupported action {c.action} for server-group")


def _h_svr(app: Application, c: Command):
    ctx = c.target or (c.contexts[0] if c.contexts else None)
    if ctx is None or ctx[0] != "server-group":
        raise CmdError("server requires `in/to server-group <name>`")
    sg = _need(app.server_groups, ctx[1], "server-group")
    if c.action == "add":
        ip, port = _addr(c.params["address"])
        sg.add(c.alias, ip, port, int(c.params.get("weight", 10)))
        return "OK"
    if c.action in ("list", "list-detail"):
        if c.action == "list":
            return [s.name for s in sg.servers]
        return [f"{s.name} -> connect-to {s.ip}:{s.port} weight {s.weight} "
                f"currently {'UP' if s.healthy else 'DOWN'}"
                for s in sg.servers]
    if c.action == "update":
        sg.set_weight(c.alias, int(c.params["weight"]))
        return "OK"
    if c.action in ("remove", "force-remove"):
        try:
            sg.remove(c.alias)
        except KeyError:
            raise CmdError(f"server {c.alias!r} not found")
        return "OK"
    raise CmdError(f"unsupported action {c.action} for server")


def _h_secg(app: Application, c: Command):
    if c.action == "add":
        if c.alias in app.security_groups:
            raise CmdError(f"security-group {c.alias} already exists")
        default = c.params.get("default", "allow")
        if default not in ("allow", "deny"):
            raise CmdError("default must be allow or deny")
        app.security_groups[c.alias] = SecurityGroup(c.alias, default == "allow")
        return "OK"
    if c.action in ("list", "list-detail"):
        if c.action == "list":
            return list(app.security_groups.keys())
        return [f"{g.alias} -> default {'allow' if g.default_allow else 'deny'}"
                for g in app.security_groups.values()]
    if c.action == "update":
        g = _need(app.security_groups, c.alias, "security-group")
        if "default" in c.params:
            g.default_allow = c.params["default"] == "allow"
        return "OK"
    if c.action in ("remove", "force-remove"):
        g = _need(app.security_groups, c.alias, "security-group")
        users = [lb.alias for lb in list(app.tcp_lbs.values())
                 + list(app.socks5_servers.values()) if lb.security_group is g]
        if users and c.action == "remove":
            raise CmdError(f"security-group {c.alias} is in use by {users}")
        del app.security_groups[c.alias]
        return "OK"
    raise CmdError(f"unsupported action {c.action} for security-group")


def _h_secgr(app: Application, c: Command):
    ctx = c.target or (c.contexts[0] if c.contexts else None)
    if ctx is None or ctx[0] != "security-group":
        raise CmdError("security-group-rule requires `in/to security-group <name>`")
    g = _need(app.security_groups, ctx[1], "security-group")
    if c.action == "add":
        net = Network.parse(c.params["network"])
        proto = Proto(c.params.get("protocol", "tcp").lower())
        pr = c.params.get("port-range", "1,65535").split(",")
        default = c.params.get("default", "allow")
        g.add_rule(AclRule(c.alias, net, proto, int(pr[0]), int(pr[1]),
                           default == "allow"))
        return "OK"
    if c.action in ("list", "list-detail"):
        if c.action == "list":
            return [r.alias for r in g.rules]
        return [f"{r.alias} -> allow {r.network} protocol {r.protocol.value} "
                f"port [{r.min_port},{r.max_port}] {'allow' if r.allow else 'deny'}"
                for r in g.rules]
    if c.action in ("remove", "force-remove"):
        try:
            g.remove_rule(c.alias)
        except KeyError:
            raise CmdError(f"security-group-rule {c.alias!r} not found")
        return "OK"
    raise CmdError(f"unsupported action {c.action} for security-group-rule")


def _h_ck(app: Application, c: Command):
    from ..components.certkey import CertKey
    if c.action == "add":
        if c.alias in app.cert_keys:
            raise CmdError(f"cert-key {c.alias} already exists")
        if "cert" not in c.params or "key" not in c.params:
            raise CmdError("cert-key requires `cert <pem>` and `key <pem>`")
        try:
            app.cert_keys[c.alias] = CertKey(c.alias, c.params["cert"],
                                             c.params["key"])
        except (OSError, ValueError) as e:
            raise CmdError(f"cannot load cert-key: {e}")
        return "OK"
    if c.action in ("list", "list-detail"):
        if c.action == "list":
            return list(app.cert_keys.keys())
        return [f"{ck.alias} -> cert {ck.cert_path} key {ck.key_path} "
                f"names {','.join(ck.dns_names)}"
                for ck in app.cert_keys.values()]
    if c.action in ("remove", "force-remove"):
        ck = _need(app.cert_keys, c.alias, "cert-key")
        users = [lb.alias for lb in app.tcp_lbs.values() if ck in lb.cert_keys]
        if users and c.action == "remove":
            raise CmdError(f"cert-key {c.alias} is in use by {users}")
        del app.cert_keys[c.alias]
        ck.close_native()  # release the native SSL_CTX (live refs stay)
        return "OK"
    raise CmdError(f"unsupported action {c.action} for cert-key")


def _h_tl(app: Application, c: Command):
    if c.action == "add":
        if c.alias in app.tcp_lbs:
            raise CmdError(f"tcp-lb {c.alias} already exists")
        ip, port = _addr(c.params["address"])
        ups = _need(app.upstreams, c.params["upstream"], "upstream")
        aelg = _opt_elg(app, c, "aelg", app.acceptor_elg)
        elg = _opt_elg(app, c, "elg", app.worker_elg)
        secg = _opt_secg(app, c)
        cks = None
        if "ck" in c.params:
            cks = [_need(app.cert_keys, a, "cert-key")
                   for a in c.params["ck"].split(",")]
        if c.params.get("overload", "") not in ("", "static", "adaptive"):
            raise CmdError(f"overload {c.params['overload']!r}: "
                           "expected static or adaptive")
        lb = TcpLB(c.alias, aelg, elg, ip, port, ups,
                   protocol=c.params.get("protocol", "tcp"),
                   security_group=secg,
                   in_buffer_size=int(c.params.get("in-buffer-size", 16384)),
                   timeout_ms=(_pos_int(c, "timeout")
                               if "timeout" in c.params else 900_000),
                   cert_keys=cks,
                   max_sessions=(_nonneg_int(c, "max-sessions")
                                 if "max-sessions" in c.params else 0),
                   pool_size=(_nonneg_int(c, "pool-size")
                              if "pool-size" in c.params else -1),
                   lanes=(_nonneg_int(c, "lanes")
                          if "lanes" in c.params else -1),
                   overload=c.params.get("overload", ""))
        lb.start()
        app.tcp_lbs[c.alias] = lb
        return "OK"
    if c.action in ("list", "list-detail"):
        if c.action == "list":
            return list(app.tcp_lbs.keys())
        return [f"{lb.alias} -> acceptor {lb.acceptor.name} worker {lb.worker.name} "
                f"bind {lb.bind_ip}:{lb.bind_port} backend {lb.backend.alias} "
                f"in-buffer-size {lb.in_buffer_size} protocol {lb.protocol} "
                f"security-group {lb.security_group.alias}"
                + _lane_summary(lb) + _maglev_summary(lb)
                + _overload_summary(lb)
                for lb in app.tcp_lbs.values()]
    if c.action == "update":
        lb = _need(app.tcp_lbs, c.alias, "tcp-lb")
        if "in-buffer-size" in c.params:
            lb.in_buffer_size = int(c.params["in-buffer-size"])
        if "secg" in c.params:
            lb.set_security_group(_need(app.security_groups,
                                        c.params["secg"],
                                        "security-group"))
        # validate/build EVERYTHING before applying anything: a failed
        # command must not leave the LB half-updated
        new_timeout = _pos_int(c, "timeout") if "timeout" in c.params else None
        if "ck" in c.params:
            cks = [_need(app.cert_keys, a, "cert-key")
                   for a in c.params["ck"].split(",")]
            try:
                lb.set_cert_keys(cks)  # builds the holder first; may raise
            except Exception as e:  # bad cert/key file: old certs stay
                raise CmdError(f"cert swap failed (nothing changed): {e}")
        if new_timeout is not None:  # hot-settable (TcpLB.java:294-320)
            lb.set_timeout(new_timeout)
        if "max-sessions" in c.params:  # hot-set the overload guard;
            # 0 restores the default ceiling (same convention as add).
            # set_max_sessions also forwards the bound to the C lanes.
            lb.set_max_sessions(_nonneg_int(c, "max-sessions"))
        if "pool-size" in c.params:  # hot-set the warm backend pool
            # (0 = off); existing pools drain and respawn at the new size
            lb.set_pool_size(_nonneg_int(c, "pool-size"))
        if "overload" in c.params:  # hot-flip static <-> adaptive
            try:
                lb.set_overload_mode(c.params["overload"])
            except ValueError as e:
                raise CmdError(str(e))
        return "OK"
    if c.action in ("remove", "force-remove"):
        lb = _need(app.tcp_lbs, c.alias, "tcp-lb")
        lb.stop()
        del app.tcp_lbs[c.alias]
        return "OK"
    raise CmdError(f"unsupported action {c.action} for tcp-lb")


def _lane_summary(lb) -> str:
    """`list-detail tcp-lb` lane column: off, or
    on(n,engine=uring|epoll,gen,served,punts,hit-rate)."""
    lanes = lb.lanes  # local: a concurrent stop() may None the attr
    if lanes is None:
        return " lanes off"
    st = lanes.stat()  # stat() itself locks against lanes_free
    if not st.get("on"):
        return " lanes off"
    return (f" lanes on(n={st['lanes']},engine={st['engine']},"
            f"gen={st['gen']},served={st['served']},punts={st['punts']},"
            f"hit-rate={st['hit_rate']})")


def _maglev_summary(lb) -> str:
    """`list-detail tcp-lb` maglev column: off, or the consistent-hash
    tables this LB routes through (C lane route and/or source-method
    group tables) with size, generation and last-resize remap."""
    st = lb.maglev_stat()
    parts = []
    if st["lanes"] is not None:
        ln = st["lanes"]
        parts.append(f"lanes(m={ln.get('m')},gen={ln.get('gen')},"
                     f"remap={ln.get('last_remap')})")
    for g in st["groups"]:
        parts.append(f"{g['group']}(m={g['m']},backends={g['backends']},"
                     f"remap={g['last_remap']})")
    if not parts:
        return " maglev off"
    return " maglev " + "+".join(parts)


def _overload_summary(lb) -> str:
    """`list-detail tcp-lb` overload column: the admission mode and,
    when adaptive, the live controller state (moving ceiling + the
    EWMAs it is steering on)."""
    st = lb.overload_stat()
    if st["mode"] == "static":
        return f" overload static(max={st['maxSessions']})"
    return (f" overload adaptive(ceiling={st['ceiling']},"
            f"max={st['maxSessions']},floor={st['floor']},"
            f"stall-ewma-ms={st['stallEwmaMs']},"
            f"accept-ewma-ms={st['acceptEwmaMs']})")


def _h_socks5(app: Application, c: Command):
    if c.action == "add":
        if c.alias in app.socks5_servers:
            raise CmdError(f"socks5-server {c.alias} already exists")
        ip, port = _addr(c.params["address"])
        ups = _need(app.upstreams, c.params["upstream"], "upstream")
        aelg = _opt_elg(app, c, "aelg", app.acceptor_elg)
        elg = _opt_elg(app, c, "elg", app.worker_elg)
        secg = _opt_secg(app, c)
        s = Socks5Server(c.alias, aelg, elg, ip, port, ups,
                         security_group=secg,
                         allow_non_backend="allow-non-backend" in c.flags,
                         in_buffer_size=int(c.params.get("in-buffer-size", 16384)),
                         timeout_ms=(_pos_int(c, "timeout")
                                     if "timeout" in c.params else 900_000))
        s.start()
        app.socks5_servers[c.alias] = s
        return "OK"
    if c.action in ("list", "list-detail"):
        if c.action == "list":
            return list(app.socks5_servers.keys())
        return [f"{s.alias} -> bind {s.bind_ip}:{s.bind_port} backend {s.backend.alias} "
                f"{'allow' if s.allow_non_backend else 'deny'}-non-backend"
                for s in app.socks5_servers.values()]
    if c.action == "update":
        s = _need(app.socks5_servers, c.alias, "socks5-server")
        if "allow-non-backend" in c.flags:
            s.allow_non_backend = True
        if "deny-non-backend" in c.flags:
            s.allow_non_backend = False
        if "in-buffer-size" in c.params:
            s.in_buffer_size = int(c.params["in-buffer-size"])
        if "secg" in c.params:
            s.security_group = _need(app.security_groups, c.params["secg"],
                                     "security-group")
        if "timeout" in c.params:
            s.set_timeout(_pos_int(c, "timeout"))
        return "OK"
    if c.action in ("remove", "force-remove"):
        s = _need(app.socks5_servers, c.alias, "socks5-server")
        s.stop()
        del app.socks5_servers[c.alias]
        return "OK"
    raise CmdError(f"unsupported action {c.action} for socks5-server")


def _mk_resource_resolver(app: Application):
    """`<alias>.<type>.vproxy.local` -> the live resource's bind address
    (the resource-introspection arm of DNSServer._run_internal). Types:
    tcp-lb, socks5-server, dns-server, switch."""
    from ..utils.ip import parse_ip as _pip

    def resolve(sub: str):
        if "." not in sub:
            return None
        alias, rtype = sub.split(".", 1)
        holder = {"tcp-lb": app.tcp_lbs,
                  "socks5-server": app.socks5_servers,
                  "dns-server": app.dns_servers,
                  "switch": app.switches}.get(rtype)
        res = holder.get(alias) if holder is not None else None
        if res is None:
            return None
        ip = getattr(res, "bind_ip", None)
        if ip is None:
            return None
        try:
            return _pip(ip)
        except (OSError, ValueError):
            return None

    return resolve


def _h_dns(app: Application, c: Command):
    if c.action == "add":
        if c.alias in app.dns_servers:
            raise CmdError(f"dns-server {c.alias} already exists")
        ip, port = _addr(c.params["address"])
        ups = _need(app.upstreams, c.params["upstream"], "upstream")
        elg = _opt_elg(app, c, "elg", app.worker_elg)
        secg = _opt_secg(app, c)
        d = DNSServer(c.alias, elg.next(), ip, port, ups, elg=elg,
                      ttl=int(c.params.get("ttl", 0)), security_group=secg,
                      resource_resolver=_mk_resource_resolver(app))
        d.start()
        app.dns_servers[c.alias] = d
        return "OK"
    if c.action in ("list", "list-detail"):
        if c.action == "list":
            return list(app.dns_servers.keys())
        return [f"{d.alias} -> bind {d.bind_ip}:{d.bind_port} rrsets {d.rrsets.alias} "
                f"ttl {d.ttl}" for d in app.dns_servers.values()]
    if c.action == "update":
        d = _need(app.dns_servers, c.alias, "dns-server")
        if "ttl" in c.params:
            d.ttl = int(c.params["ttl"])
        return "OK"
    if c.action in ("remove", "force-remove"):
        d = _need(app.dns_servers, c.alias, "dns-server")
        d.stop()
        del app.dns_servers[c.alias]
        return "OK"
    raise CmdError(f"unsupported action {c.action} for dns-server")


# ------------------------------------------------------------- vswitch

def _ctx_switch(app: Application, c: Command):
    chain = ([c.target] if c.target else []) + c.contexts
    for kind, alias in chain:
        if kind == "switch":
            return _need(app.switches, alias, "switch")
    raise CmdError(f"{c.type} requires `in/to switch <name>`")


def _ctx_vpc(app: Application, c: Command):
    """Resolve `... in vpc <vni> in switch <sw>` chains."""
    sw = _ctx_switch(app, c)
    chain = ([c.target] if c.target else []) + c.contexts
    for kind, alias in chain:
        if kind == "vpc":
            try:
                vni = int(alias)
            except ValueError:
                raise CmdError(f"bad vni {alias!r}")
            if vni not in sw.networks:
                raise CmdError(f"vpc {vni} not found in switch {sw.alias}")
            return sw, sw.networks[vni]
    raise CmdError(f"{c.type} requires `in vpc <vni> in switch <name>`")


def _h_switch(app: Application, c: Command):
    from ..vswitch.switch import Switch
    if c.action == "add" and c.target is not None:
        # remote switch link: add switch sw1 to switch sw0 address ip:port
        sw = _ctx_switch(app, c)
        ip, port = _addr(c.params["address"])
        sw.add_remote_switch(c.alias, ip, port)
        return "OK"
    if c.action == "add":
        if c.alias in app.switches:
            raise CmdError(f"switch {c.alias} already exists")
        ip, port = _addr(c.params["address"])
        elg = _opt_elg(app, c, "elg", app.worker_elg)
        secg = _opt_secg(app, c)
        sw = Switch(c.alias, elg.next(), ip, port,
                    mac_table_timeout_ms=int(c.params.get("mac-table-timeout",
                                                          300_000)),
                    arp_table_timeout_ms=int(c.params.get("arp-table-timeout",
                                                          4 * 3600_000)),
                    bare_vxlan_access=secg, elg=elg)
        sw.start()
        app.switches[c.alias] = sw
        return "OK"
    if c.action in ("list", "list-detail"):
        if c.action == "list":
            return list(app.switches.keys())

        def fc_str(s) -> str:
            fc = s.flowcache_info()
            if fc is None:
                return "off"
            state = "on" if fc["active"] else "idle"
            return (f"{state}(size={fc['size']},used={fc['used']},"
                    f"gen={fc['gen']},hit-rate={fc['hit_rate']})")
        return [f"{s.alias} -> bind {s.bind_ip}:{s.bind_port} "
                f"mac-table-timeout {s.mac_table_timeout_ms} "
                f"arp-table-timeout {s.arp_table_timeout_ms} "
                f"bare-vxlan-access {s.bare_access.alias} "
                f"flowcache {fc_str(s)}"
                for s in app.switches.values()]
    if c.action == "update":
        sw = _need(app.switches, c.alias, "switch")
        # hot-set table timeouts (SwitchHandle update): existing VPC
        # tables adopt the new TTLs immediately
        if "mac-table-timeout" in c.params:
            sw.mac_table_timeout_ms = _pos_int(c, "mac-table-timeout")
            for net in sw.networks.values():
                net.macs.timeout_ms = sw.mac_table_timeout_ms
        if "arp-table-timeout" in c.params:
            sw.arp_table_timeout_ms = _pos_int(c, "arp-table-timeout")
            for net in sw.networks.values():
                net.arps.timeout_ms = sw.arp_table_timeout_ms
        return "OK"
    if c.action in ("remove", "force-remove"):
        if c.target is not None:
            sw = _ctx_switch(app, c)
            try:
                sw.remove_iface(f"remote:{c.alias}")
            except KeyError:
                raise CmdError(f"remote switch {c.alias!r} not found")
            return "OK"
        sw = _need(app.switches, c.alias, "switch")
        # vpc proxies bound to this switch die with it
        for key in [k for k in app.vpc_proxies if k[0] == c.alias]:
            for p in app.vpc_proxies.pop(key).values():
                p.close()
        sw.stop()
        del app.switches[c.alias]
        return "OK"
    raise CmdError(f"unsupported action {c.action} for switch")


def _h_vpc(app: Application, c: Command):
    sw = _ctx_switch(app, c)
    if c.action == "add":
        try:
            vni = int(c.alias)
        except ValueError:
            raise CmdError(f"bad vni {c.alias!r}")
        if "v4network" not in c.params:
            raise CmdError("vpc requires v4network")
        v6 = Network.parse(c.params["v6network"]) if "v6network" in c.params else None
        anno = _anno_dict(c.params["annotations"]) if "annotations" in c.params else None
        try:
            sw.add_network(vni, Network.parse(c.params["v4network"]), v6,
                           annotations=anno)
        except ValueError as e:
            raise CmdError(str(e))
        return "OK"
    if c.action in ("list", "list-detail"):
        if c.action == "list":
            return [str(v) for v in sw.networks]
        return [f"{n.vni} -> v4network {n.v4net}"
                + (f" v6network {n.v6net}" if n.v6net else "")
                + (f" annotations {json.dumps(n.annotations, separators=(',', ':'))}"
                   if n.annotations else "")
                for n in sw.networks.values()]
    if c.action in ("remove", "force-remove"):
        try:
            vni = int(c.alias)
            sw.del_network(vni)
        except (KeyError, ValueError):
            raise CmdError(f"vpc {c.alias!r} not found")
        for p in app.vpc_proxies.pop((sw.alias, vni), {}).values():
            p.close()
        return "OK"
    raise CmdError(f"unsupported action {c.action} for vpc")


def _h_iface(app: Application, c: Command):
    sw = _ctx_switch(app, c)
    if c.action in ("list", "list-detail"):
        return [i.name for i in sw.list_ifaces()]
    if c.action in ("remove", "force-remove"):
        try:
            sw.remove_iface(c.alias)
        except KeyError:
            raise CmdError(f"iface {c.alias!r} not found")
        return "OK"
    raise CmdError(f"unsupported action {c.action} for iface")


def _h_route(app: Application, c: Command):
    from ..rules.ir import RouteRule
    sw, net = _ctx_vpc(app, c)
    if c.action == "add":
        network = Network.parse(c.params["network"])
        if "vni" in c.params:
            rule = RouteRule(c.alias, network, to_vni=int(c.params["vni"]))
        elif "via" in c.params:
            rule = RouteRule(c.alias, network,
                             via_ip=_parse_ip_str(c.params["via"]))
        else:
            raise CmdError("route requires `vni <n>` or `via <ip>`")
        try:
            net.add_route(rule)
        except ValueError as e:
            raise CmdError(str(e))
        return "OK"
    if c.action in ("list", "list-detail"):
        if c.action == "list":
            return [r.alias for r in net.routes.rules]
        out = []
        for r in net.routes.rules:
            tgt = f"vni {r.to_vni}" if r.to_vni else \
                f"via {format_ip(r.via_ip)}"
            out.append(f"{r.alias} -> network {r.rule} {tgt}")
        return out
    if c.action in ("remove", "force-remove"):
        try:
            net.remove_route(c.alias)
        except KeyError:
            raise CmdError(f"route {c.alias!r} not found")
        return "OK"
    raise CmdError(f"unsupported action {c.action} for route")


def _h_arp(app: Application, c: Command):
    sw, net = _ctx_vpc(app, c)
    if c.action == "add":
        # alias is the mac; `ip` given via address param? use network-less ip
        if "address" not in c.params:
            raise CmdError("arp add requires `address <ip>`")
        net.arps.record(_parse_ip_str(c.params["address"]),
                        _parse_mac_str(c.alias))
        return "OK"
    if c.action in ("list", "list-detail"):
        macs = {m: getattr(i, "name", "?") for m, i in net.macs.entries()}
        out = []
        for ip_s, mac_s in net.arps.entries():
            out.append(f"{mac_s} -> ip {ip_s} iface {macs.get(mac_s, '?')}")
        return out
    raise CmdError(f"unsupported action {c.action} for arp")


def _h_user(app: Application, c: Command):
    sw = _ctx_switch(app, c)
    if c.action == "add":
        if "password" not in c.params or "vni" not in c.params:
            raise CmdError("user requires `password <p>` and `vni <n>`")
        try:
            sw.add_user(c.alias, c.params["password"], int(c.params["vni"]))
        except ValueError as e:
            raise CmdError(str(e))
        return "OK"
    from ..vswitch.switch import display_user_name
    if c.action in ("list", "list-detail"):
        if c.action == "list":
            return [display_user_name(u) for u in sw.users]
        return [f"{display_user_name(u)} -> vni {vni}"
                for u, (_, vni, _pw) in sw.users.items()]
    if c.action in ("remove", "force-remove"):
        try:
            sw.del_user(c.alias)
        except KeyError:
            raise CmdError(f"user {c.alias!r} not found")
        except ValueError as e:  # format-invalid alias, e.g. too short
            raise CmdError(str(e))
        return "OK"
    raise CmdError(f"unsupported action {c.action} for user")


def _h_ucli(app: Application, c: Command):
    sw = _ctx_switch(app, c)
    if c.action == "add":
        for k in ("password", "vni", "address"):
            if k not in c.params:
                raise CmdError(f"user-client requires `{k}`")
        ip, port = _addr(c.params["address"])
        sw.add_user_client(c.alias, c.params["password"],
                           int(c.params["vni"]), ip, port)
        return "OK"
    if c.action in ("list", "list-detail"):
        return [i.name for i in sw.list_ifaces() if i.name.startswith("ucli:")]
    if c.action in ("remove", "force-remove"):
        try:
            sw.remove_iface(f"ucli:{c.alias}")
        except KeyError:
            raise CmdError(f"user-client {c.alias!r} not found")
        return "OK"
    raise CmdError(f"unsupported action {c.action} for user-client")


def _h_tap(app: Application, c: Command):
    sw = _ctx_switch(app, c)
    if c.action == "add":
        if "vni" not in c.params:
            raise CmdError("tap requires `vni <n>`")
        anno = _anno_dict(c.params["annotations"]) if "annotations" in c.params else None
        try:
            iface = sw.add_tap(c.alias, int(c.params["vni"]),
                               post_script=c.params.get("post-script"),
                               annotations=anno)
        except OSError as e:
            raise CmdError(str(e))
        return iface.dev
    if c.action in ("list", "list-detail"):
        return [i.name for i in sw.list_ifaces() if i.name.startswith("tap:")]
    if c.action in ("remove", "force-remove"):
        try:
            sw.remove_iface(f"tap:{c.alias}")
        except KeyError:
            raise CmdError(f"tap {c.alias!r} not found")
        return "OK"
    raise CmdError(f"unsupported action {c.action} for tap")


def _h_ip(app: Application, c: Command):
    from ..vswitch.switch import synthetic_mac
    from ..vswitch.packets import mac_str, parse_mac
    sw, net = _ctx_vpc(app, c)
    if c.action == "add":
        ip = _parse_ip_str(c.alias)
        mac = (_parse_mac_str(c.params["mac"]) if "mac" in c.params
               else synthetic_mac(net.vni, ip))
        net.ips.add(ip, mac)
        return "OK"
    if c.action in ("list", "list-detail"):
        return [f"{format_ip(ip)} -> mac {mac_str(mac)}"
                for ip, mac in net.ips.ips().items()]
    if c.action in ("remove", "force-remove"):
        net.ips.remove(_parse_ip_str(c.alias))
        return "OK"
    raise CmdError(f"unsupported action {c.action} for ip")


def _nonneg_int(c: "Command", key: str, what: str = "") -> int:
    """Non-negative integer param; 0 is meaningful (max-sessions 0 =
    restore the default ceiling, on add and update alike)."""
    try:
        v = int(c.params[key])
    except ValueError:
        raise CmdError(f"bad {what or key}: {c.params[key]!r}")
    if v < 0:
        raise CmdError(f"{what or key} must be >= 0, got {v}")
    return v


def _pos_int(c: "Command", key: str, what: str = "") -> int:
    """Positive-integer param: `timeout 0` (or a seconds-vs-ms typo
    going negative) would turn idle sweeps into kill-everything loops."""
    try:
        v = int(c.params[key])
    except ValueError:
        raise CmdError(f"bad {what or key}: {c.params[key]!r}")
    if v <= 0:
        raise CmdError(f"{what or key} must be positive, got {v}")
    return v


def _parse_ip_str(s: str) -> bytes:
    from ..utils.ip import parse_ip as _p
    try:
        return _p(s)
    except (OSError, ValueError):
        raise CmdError(f"bad ip {s!r}")


def _parse_mac_str(s: str) -> bytes:
    from ..vswitch.packets import PacketError, parse_mac
    try:
        return parse_mac(s)
    except (PacketError, ValueError):
        raise CmdError(f"bad mac {s!r}")


def _all_lbs(app: Application) -> dict:
    out: dict = {}
    out.update(app.tcp_lbs)
    out.update(app.socks5_servers)
    return out


def _stat_target(app: Application, c: Command):
    """Resolve `in ...` chain for statistics channels."""
    if not c.contexts:
        raise CmdError(f"{c.type} requires an `in` chain")
    kind, alias = c.contexts[0]
    if kind in ("tcp-lb", "socks5-server"):
        return _need(_all_lbs(app), alias, kind)
    if kind == "server":
        if len(c.contexts) < 2 or c.contexts[1][0] != "server-group":
            raise CmdError("server stats require `in server-group`")
        sg = _need(app.server_groups, c.contexts[1][1], "server-group")
        for s in sg.servers:
            if s.name == alias:
                return s
        raise CmdError(f"server {alias!r} not found")
    raise CmdError(f"stats not supported on {kind}")


def _lb_context(app: Application, c: Command):
    if not c.contexts:
        raise CmdError(f"{c.type} requires `in tcp-lb|socks5-server <name>`")
    kind, alias = c.contexts[0]
    if kind not in ("tcp-lb", "socks5-server"):
        raise CmdError(f"{c.type} lives in tcp-lb/socks5-server")
    return _need(_all_lbs(app), alias, kind)


def _h_server_sock(app: Application, c: Command):
    """Listening sockets of a frontend (ResourceType ss): one per
    acceptor loop under REUSEPORT sharding."""
    lb = _lb_context(app, c)
    if c.action in ("list", "list-detail"):
        return [f"{ss.ip}:{ss.port} -> loop {ss.loop.name}"
                for ss in lb.server_socks]
    raise CmdError(f"unsupported action {c.action} for server-sock")


def _sessions_of(lb) -> list:
    """(desc, bytes_in, bytes_out) per live spliced session. Pump state
    is loop-confined (the lock-free native engine frees pumps on the
    owning loop thread), so each loop's stats are read ON that loop via
    call_sync — a direct cross-thread pump_stat would race pump_free."""
    out = []
    for lid, loop in list(lb._watch_loops.items()):
        def collect(lid=lid, loop=loop):
            rows = []
            for pid, ent in list(lb._pump_watch.get(lid, {}).items()):
                try:
                    a2b, b2a, _err = loop.pump_stat(pid)
                except OSError:
                    continue
                rows.append((ent[2] if len(ent) > 2 else "?", a2b, b2a))
            return rows
        try:
            out.extend(loop.call_sync(collect))
        except (OSError, RuntimeError):
            continue  # loop died mid-listing; its sessions are gone
    return out


def _h_session(app: Application, c: Command):
    """Live proxied sessions (ResourceType sess): spliced pairs with
    their byte counters; `list` returns the count."""
    lb = _lb_context(app, c)
    if c.action == "list":
        return [str(lb.active_sessions)]
    if c.action == "list-detail":
        rows = [f"{desc} bytes-in {a2b} bytes-out {b2a}"
                for desc, a2b, b2a in _sessions_of(lb)]
        other = lb.active_sessions - len(rows)
        if other > 0:  # L7 / handshaking sessions have no pump yet
            rows.append(f"({other} non-spliced sessions)")
        return rows
    raise CmdError(f"unsupported action {c.action} for session")


def _h_connection(app: Application, c: Command):
    """Live connections (ResourceType conn): both legs of each spliced
    session, frontend first (the reference lists front and back
    connections individually)."""
    lb = _lb_context(app, c)
    if c.action == "list":
        return [str(2 * lb.active_sessions)]
    if c.action == "list-detail":
        out = []
        sess = _sessions_of(lb)
        for desc, a2b, b2a in sess:
            front, _, back = desc.partition(" -> ")
            out.append(f"{front} -> {lb.bind_ip}:{lb.bind_port} "
                       f"bytes-in {a2b} bytes-out {b2a}")
            out.append(f"local -> {back} bytes-in {b2a} bytes-out {a2b}")
        other = lb.active_sessions - len(sess)
        if other > 0:
            out.append(f"({2 * other} connections of non-spliced sessions)")
        return out
    raise CmdError(f"unsupported action {c.action} for connection")


def _h_stats(app: Application, c: Command):
    t = _stat_target(app, c)
    if c.type == "bytes-in":
        return [str(getattr(t, "bytes_in", 0))]
    if c.type == "bytes-out":
        return [str(getattr(t, "bytes_out", 0))]
    if c.type == "accepted-conn-count":
        return [str(getattr(t, "accepted", 0))]
    raise CmdError(f"unsupported stat {c.type}")


def _h_eventlog(app: Application, c: Command):
    """`list event-log` — the flight-recorder ring (utils/events):
    connection lifecycle, loop stalls, classify failovers, health-check
    edges. list-detail returns the raw event dicts (what /events
    serves); list returns human-form lines. `since=`/`until=` bound the
    window in monotonic ns — the SAME clock trace spans stamp t_ns
    with, so a capture or incident window joins directly."""
    from ..utils.events import EVENT_PLANES, FlightRecorder
    plane = c.params.get("plane")
    if plane is not None and plane not in EVENT_PLANES:
        raise CmdError(f"unknown event plane {plane!r} "
                       f"(one of {', '.join(EVENT_PLANES)})")

    def _ns(key):
        v = c.params.get(key)
        if v is None:
            return None
        try:
            return int(v)
        except ValueError:
            raise CmdError(f"{key} must be an integer (monotonic ns), "
                           f"got {v!r}")

    since, until = _ns("since"), _ns("until")
    if c.action == "list":
        return FlightRecorder.get().lines(plane=plane, since=since,
                                          until=until)
    if c.action == "list-detail":
        return FlightRecorder.get().snapshot(plane=plane, since=since,
                                             until=until)
    raise CmdError(f"unsupported action {c.action} for event-log")


def _h_trace(app: Application, c: Command):
    """`list trace` — recent sampled request traces (id, span count,
    planes touched, end-to-end us); `list-detail trace` the raw trace
    summaries (what GET /trace serves). The waterfall of ONE trace is
    the bare `trace <id>` line (outside the resource grammar, like
    `drain`) — both control surfaces accept it."""
    from ..utils import trace as TR
    if c.action == "list":
        return [f"[{t['trace']}] {t['total_us']}us spans={t['spans']} "
                f"planes={','.join(t['planes'])}"
                for t in TR.summaries()]
    if c.action == "list-detail":
        return TR.summaries()
    raise CmdError(f"unsupported action {c.action} for trace")


def _h_analytics(app: Application, c: Command):
    """`list analytics` — one summary line per dimension (top entry,
    rate, update counts); `list-detail analytics` the full snapshot
    dict (what GET /analytics serves). The per-dimension table is the
    bare `top <dim>` verb."""
    from ..utils import sketch as SK
    if c.action == "list":
        st = SK.status()
        out = [f"analytics {'on' if st['enabled'] else 'off'} "
               f"window={st['window_s']:g}s k={st['k']} "
               f"cm={st['cm']['width']}x{st['cm']['depth']}"]
        for d in SK.DIMS:
            top = SK.top_table(d, 1)
            ds = st["dims"][d]
            lead = (f"#0 {top[0]['key']} count={top[0]['count']} "
                    f"{top[0]['rate']:.1f}/s" if top else "(idle)")
            out.append(f"{d}: updates={ds['updates']} "
                       f"rotations={ds['rotations']} {lead}")
        return out
    if c.action == "list-detail":
        # the reference's snapshot_with_fleet() without a cluster node
        return SK.snapshot()
    raise CmdError(f"unsupported action {c.action} for analytics")


def _h_policy(app: Application, c: Command):
    """`add policy <name> dim=<d> rate=<r> burst=<b>
    action=monitor|throttle|shed [tenant=<cidr|key>]` — the
    sketch-driven admission policies (policing/engine). Heavy hitters
    of `dim` get a token bucket at `rate`/s with `burst` headroom and
    `action` on over-quota; `tenant` scopes the policy and names its
    weight class for the fair-shed order (docs/robustness.md).
    Replicated + persisted like every rule resource."""
    from ..policing import engine as policing
    eng = policing.default()
    if c.action == "add":
        if any(p["name"] == c.alias for p in eng.list_policies()):
            raise CmdError(f"policy {c.alias} already exists")
        for k in ("dim", "rate", "burst", "action"):
            if k not in c.params:
                raise CmdError(f"policy requires `{k}=<value>`")
        try:
            pol = policing.Policy(
                c.alias, c.params["dim"], float(c.params["rate"]),
                float(c.params["burst"]), c.params["action"],
                tenant=c.params.get("tenant"))
        except ValueError as e:
            raise CmdError(str(e))
        eng.set_policy(pol)
        eng.tick()  # enforce against the current top-K now, not in ~1s
        return "OK"
    if c.action == "list":
        return [p["name"] for p in eng.list_policies()]
    if c.action == "list-detail":
        out = [f"{p['name']} -> dim {p['dim']} rate {p['rate']:g} "
               f"burst {p['burst']:g} action {p['action']}"
               + (f" tenant {p['tenant']}" if p["tenant"] else "")
               for p in eng.list_policies()]
        st = eng.status()
        out.append(f"policing {'on' if st['enabled'] else 'off'} "
                   f"seq {st['seq']} keys {st['keys']} "
                   f"installs {st['tables_installed_total']} "
                   f"gossip-merges {st['gossip_merges_total']} "
                   f"policed {st['policed_total']}")
        return out
    if c.action in ("remove", "force-remove"):
        if not eng.remove_policy(c.alias) and c.action == "remove":
            raise CmdError(f"policy {c.alias!r} not found")
        eng.tick()  # drop the keys (and native recs) it was policing
        return "OK"
    raise CmdError(f"unsupported action {c.action} for policy")


def _h_fault(app: Application, c: Command):
    """`add fault <site> [probability p] [count n] [match m] [seed s]`
    arms a named failpoint (utils/failpoint — the chaos-testing
    injection sites); without an explicit seed the probability coin is
    derived from VPROXY_TPU_FAILPOINT_SEED so storm/chaos runs replay;
    `remove fault <site>` disarms; `list fault` shows armed faults with
    hit counts (same view as `GET /faults`)."""
    from ..utils import failpoint
    if c.action == "add":
        try:
            failpoint.arm(
                c.alias,
                probability=float(c.params.get("probability", "1.0")),
                count=int(c.params["count"]) if "count" in c.params else None,
                match=c.params.get("match"),
                seed=int(c.params["seed"]) if "seed" in c.params else None)
        except ValueError as e:
            raise CmdError(str(e))
        return "OK"
    if c.action == "list":
        return [f["name"] for f in failpoint.active()]
    if c.action == "list-detail":
        return [f"{f['name']} -> probability {f['probability']} "
                f"count {f['count'] if f['count'] is not None else 'inf'} "
                f"match {f['match'] or '*'} hits {f['hits']}"
                for f in failpoint.active()]
    if c.action in ("remove", "force-remove"):
        if not failpoint.disarm(c.alias) and c.action == "remove":
            raise CmdError(f"fault {c.alias!r} not armed")
        return "OK"
    raise CmdError(f"unsupported action {c.action} for fault")


def _h_resolver(app: Application, c: Command):
    """The reference's resolver is a singleton named "(default)"
    (ResolverHandle.java:10-16); dns-cache lives inside it."""
    if c.action in ("list", "list-detail"):
        return ["(default)"]
    raise CmdError(f"unsupported action {c.action} for resolver")


def _h_dnscache(app: Application, c: Command):
    ctx = c.target or (c.contexts[0] if c.contexts else None)
    if ctx is not None and (ctx[0] != "resolver" or ctx[1] != "(default)"):
        raise CmdError("dns-cache lives in `resolver (default)`")
    res = app.get_resolver()
    if c.action == "list":
        return sorted({k[0] for k in res._cache})
    if c.action == "list-detail":
        import time as _t
        now = _t.monotonic()
        out = []
        for (name, qtype), (expiry, addrs) in sorted(res._cache.items()):
            from ..utils.ip import format_ip
            out.append(f"{name} -> [{','.join(format_ip(bytes(a)) for a in addrs)}]"
                       f" ttl={max(0, int(expiry - now))}")
        return out
    if c.action in ("remove", "force-remove"):
        gone = [k for k in res._cache if k[0] == c.alias]
        if not gone:
            raise CmdError(f"dns-cache {c.alias!r} not found")
        for k in gone:
            del res._cache[k]
        return "OK"
    raise CmdError(f"unsupported action {c.action} for dns-cache")


def _h_proxy(app: Application, c: Command):
    """`add proxy <ip:port> to vpc <vni> in switch <sw> address <tgt>`
    — in-VPC user-space listener bridged to a host address
    (vswitch/ProxyHolder)."""
    from ..vswitch.proxy import VpcProxy

    sw, net = _ctx_vpc(app, c)  # validates the vpc exists in the switch
    key = (sw.alias, net.vni)
    store = app.vpc_proxies.get(key, {})
    if c.action == "add":
        if c.alias in store:
            raise CmdError(f"proxy {c.alias} already exists")
        lip, lport = _addr(c.alias)
        if "address" not in c.params:
            raise CmdError("proxy requires `address <target ip:port>`")
        tip, tport = _addr(c.params["address"])
        try:
            p = VpcProxy(sw, net.vni, lip, lport, tip, tport)
        except OSError as e:
            raise CmdError(f"proxy listen failed: {e}")
        app.vpc_proxies.setdefault(key, {})[c.alias] = p
        return "OK"
    if c.action == "list":
        return list(store.keys())
    if c.action == "list-detail":
        return [f"{p.alias} -> {p.target[0]}:{p.target[1]} "
                f"sessions={p.sessions}" for p in store.values()]
    if c.action in ("remove", "force-remove"):
        p = _need(store, c.alias, "proxy")
        p.close()
        del store[c.alias]
        return "OK"
    raise CmdError(f"unsupported action {c.action} for proxy")


def _h_respc(app: Application, c: Command):
    from .resp import RESPController
    if c.action == "add":
        if c.alias in app.resp_controllers:
            raise CmdError(f"resp-controller {c.alias} already exists")
        if "address" not in c.params:
            raise CmdError("resp-controller requires `address <ip:port>`")
        ip, port = _addr(c.params["address"])
        ctl = RESPController(app, ip, port,
                             password=c.params.get("password"))
        ctl.start()
        app.resp_controllers[c.alias] = ctl
        return "OK"
    if c.action == "list":
        return list(app.resp_controllers.keys())
    if c.action == "list-detail":
        return [f"{a} -> {ctl.bind_ip}:{ctl.bind_port}"
                for a, ctl in app.resp_controllers.items()]
    if c.action in ("remove", "force-remove"):
        ctl = _need(app.resp_controllers, c.alias, "resp-controller")
        ctl.stop()
        del app.resp_controllers[c.alias]
        return "OK"
    raise CmdError(f"unsupported action {c.action} for resp-controller")


def _h_httpc(app: Application, c: Command):
    from .http_controller import HttpController
    if c.action == "add":
        if c.alias in app.http_controllers:
            raise CmdError(f"http-controller {c.alias} already exists")
        if "address" not in c.params:
            raise CmdError("http-controller requires `address <ip:port>`")
        ip, port = _addr(c.params["address"])
        ctl = HttpController(app, ip, port)
        ctl.start()
        app.http_controllers[c.alias] = ctl
        return "OK"
    if c.action == "list":
        return list(app.http_controllers.keys())
    if c.action == "list-detail":
        return [f"{a} -> {ctl.bind_ip}:{ctl.bind_port}"
                for a, ctl in app.http_controllers.items()]
    if c.action in ("remove", "force-remove"):
        ctl = _need(app.http_controllers, c.alias, "http-controller")
        ctl.stop()
        del app.http_controllers[c.alias]
        return "OK"
    raise CmdError(f"unsupported action {c.action} for http-controller")


# resource types whose subsystem is not ported yet -> the ROADMAP
# Queue A item that ports it
NOT_PORTED = {
    "cluster-node": 8,
    "docker-network-plugin-controller": 10,
}


def _not_ported(app: Application, c: Command):
    raise CmdError(f"{c.type}: not ported yet "
                   f"(ROADMAP Queue A item {NOT_PORTED[c.type]})")


_HANDLERS = {
    "fault": _h_fault,
    "event-log": _h_eventlog,
    "trace": _h_trace,
    "analytics": _h_analytics,
    "policy": _h_policy,
    "cluster-node": _not_ported,
    "resolver": _h_resolver,
    "dns-cache": _h_dnscache,
    "proxy": _h_proxy,
    "resp-controller": _h_respc,
    "http-controller": _h_httpc,
    "docker-network-plugin-controller": _not_ported,
    "event-loop-group": _h_elg,
    "event-loop": _h_el,
    "upstream": _h_ups,
    "server-group": _h_sg,
    "server": _h_svr,
    "security-group": _h_secg,
    "security-group-rule": _h_secgr,
    "cert-key": _h_ck,
    "switch": _h_switch,
    "vpc": _h_vpc,
    "iface": _h_iface,
    "route": _h_route,
    "arp": _h_arp,
    "user": _h_user,
    "user-client": _h_ucli,
    "tap": _h_tap,
    "ip": _h_ip,
    "tcp-lb": _h_tl,
    "socks5-server": _h_socks5,
    "dns-server": _h_dns,
    "server-sock": _h_server_sock,
    "session": _h_session,
    "connection": _h_connection,
    "bytes-in": _h_stats,
    "bytes-out": _h_stats,
    "accepted-conn-count": _h_stats,
}
