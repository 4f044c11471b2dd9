"""HttpController — REST control surface.

Parity: app controller/HttpController.java (routes :59-320, swagger
doc/api.yaml): CRUD under /api/v1/module/<resource>, /healthz, plus a
raw command endpoint. Built on the embeddable vserver HTTP lib exactly
as the reference's controller is built on its vserver. JSON bodies use
the command grammar's param names; list endpoints return JSON arrays.

The port's copy of vproxy_tpu/control/http_controller.py, same routes
and payloads. No cluster node can boot in the port (ROADMAP Queue A
item 8), so /cluster, /analytics and the switch module answer as the
reference does without one.
"""
from __future__ import annotations

import json
from typing import Optional

from ..lib.vserver import HttpServer, RoutingContext
from ..net.eventloop import SelectorEventLoop
from .app import Application
from .command import CmdError, Command

# url segment -> command resource type
MODULES = {
    "tcp-lb": "tcp-lb", "socks5-server": "socks5-server",
    "dns-server": "dns-server", "event-loop-group": "event-loop-group",
    "upstream": "upstream", "server-group": "server-group",
    "security-group": "security-group", "cert-key": "cert-key",
    "switch": "switch",
    "resp-controller": "resp-controller",
    "http-controller": "http-controller",
}
FLAG_KEYS = {"allow-non-backend", "deny-non-backend"}


def _anno(rule) -> dict:
    d = {}
    if getattr(rule, "host", None) is not None:
        d["vproxy/hint-host"] = rule.host
    if getattr(rule, "port", 0):
        d["vproxy/hint-port"] = str(rule.port)
    if getattr(rule, "uri", None) is not None:
        d["vproxy/hint-uri"] = rule.uri
    return d


# typed list-detail JSON per module (HttpController.java:59-320 returns
# per-resource objects, doc/api.yaml schemas) — built straight from the
# component objects, not by re-parsing command-grammar strings
def _details(app, rtype: str) -> list:
    if rtype == "tcp-lb":
        return [{
            "name": a, "address": f"{lb.bind_ip}:{lb.bind_port}",
            "protocol": lb.protocol, "backend": lb.backend.alias,
            "securityGroup": lb.security_group.alias,
            "inBufferSize": lb.in_buffer_size, "timeout": lb.timeout_ms,
            "activeSessions": getattr(lb, "active_sessions", 0),
            "listOfCertKey": [ck.alias for ck in lb.cert_keys],
            "lanes": (lambda _l: _l.stat() if _l is not None
                      else {"on": False})(lb.lanes),
            # consistent-hash routing state (docs/perf.md maglev):
            # table sizes, generations, last-resize remap fractions
            "maglev": lb.maglev_stat(),
            # admission state (docs/robustness.md adaptive overload):
            # mode, bounds, and the controller EWMAs when adaptive
            "overload": lb.overload_stat(),
        } for a, lb in app.tcp_lbs.items()]
    if rtype == "socks5-server":
        return [{
            "name": a, "address": f"{s.bind_ip}:{s.bind_port}",
            "backend": s.backend.alias,
            "securityGroup": s.security_group.alias,
            "allowNonBackend": getattr(s, "allow_non_backend", False),
        } for a, s in app.socks5_servers.items()]
    if rtype == "dns-server":
        return [{
            "name": a, "address": f"{d.bind_ip}:{d.bind_port}",
            "rrsets": d.rrsets.alias, "ttl": d.ttl,
            "securityGroup": d.security_group.alias,
            "queries": getattr(d, "queries", 0),
        } for a, d in app.dns_servers.items()]
    if rtype == "event-loop-group":
        return [{"name": a, "eventLoopList": elg.loop_names()}
                for a, elg in app.elgs.items()]
    if rtype == "upstream":
        return [{
            "name": a, "serverGroupList": [{
                "name": h.alias, "weight": h.weight,
                "annotations": _anno(h.annotations),
            } for h in u.handles],
            # classify-engine state (docs/perf.md sharded engine):
            # generation bumps on every atomic standby-table swap
            "engine": {
                "backend": u._matcher.backend,
                "rules": u._matcher.size(),
                "generation": u._matcher.generation,
                "tableBytes": u._matcher.published_table_bytes(),
                "checksum": u._matcher.checksum(),
                # fused classify+pick state (docs/perf.md fused
                # dispatch): packed-table availability, serving kernel
                # tier, packed device bytes — with the launch counters
                # on /metrics this makes "one launch per batch"
                # operator-verifiable
                "fused": (u._matcher.fused_stat()
                          if hasattr(u._matcher, "fused_stat")
                          else {"available": False}),
            },
        } for a, u in app.upstreams.items()]
    if rtype == "server-group":
        return [{
            "name": a, "method": g.method,
            "timeout": g.hc.timeout_ms, "period": g.hc.period_ms,
            "up": g.hc.up, "down": g.hc.down,
            "protocol": g.hc.protocol,
            "annotations": _anno(g.annotations),
            "serverList": [{
                "name": s.name, "address": f"{s.ip}:{s.port}",
                "weight": s.weight, "currentlyUp": s.healthy,
                "connCount": getattr(s, "conn_count", 0),
            } for s in g.servers],
        } for a, g in app.server_groups.items()]
    if rtype == "security-group":
        return [{
            "name": a,
            "defaultRule": "allow" if sg.default_allow else "deny",
            "ruleList": [{
                "name": r.alias,
                "network": f"{r.network}",
                "protocol": r.protocol.value,
                "portRange": f"{r.min_port},{r.max_port}",
                "rule": "allow" if r.allow else "deny",
            } for r in sg.rules],
        } for a, sg in app.security_groups.items()]
    if rtype == "cert-key":
        return [{"name": a, "cert": ck.cert_path, "key": ck.key_path,
                 "dnsNames": ck.dns_names}
                for a, ck in app.cert_keys.items()]
    if rtype == "switch":
        return [{
            "name": a, "address": f"{sw.bind_ip}:{sw.bind_port}",
            "vpcList": sorted(sw.networks.keys()),
            "ifaceCount": len(sw.list_ifaces()),
        } for a, sw in app.switches.items()]
    if rtype == "resp-controller":
        return [{"name": a, "address": f"{c.bind_ip}:{c.bind_port}"}
                for a, c in app.resp_controllers.items()]
    if rtype == "http-controller":
        return [{"name": a, "address": f"{c.bind_ip}:{c.bind_port}"}
                for a, c in app.http_controllers.items()]
    raise CmdError(f"no detail view for {rtype}")


class HttpController:
    def __init__(self, app: Application, bind_ip: str, bind_port: int,
                 loop: Optional[SelectorEventLoop] = None):
        self.app = app
        self.loop = loop or app.control_loop
        self.bind_ip, self.bind_port = bind_ip, bind_port
        self._srv: Optional[HttpServer] = None

    def start(self) -> None:
        from ..utils import failpoint, lifecycle
        srv = HttpServer(self.loop)

        def healthz(r: RoutingContext) -> None:
            # `draining` + 503 once graceful drain begins, so upstream
            # LBs probing this controller steer traffic away
            if lifecycle.is_draining():
                r.resp.status(503).end({"status": "draining"})
            else:
                r.resp.end({"status": "ok"})

        srv.get("/healthz", healthz)
        srv.get("/faults", lambda r: r.resp.end(failpoint.active()))

        # fleet view (cluster plane): never booted in the port
        srv.get("/cluster", lambda r: r.resp.end({"enabled": False}))

        def trace_ep(r: RoutingContext) -> None:
            # span-level request tracing (docs/observability.md):
            # summaries, or one trace's spans via ?id= — the same
            # payloads the inspection server's /trace serves
            from ..utils import trace as TR
            try:
                tid = int(r.req.query.get("id", "0"))
            except ValueError:
                tid = 0
            if tid:
                r.resp.end({"trace": tid, "spans": TR.get_trace(tid)})
            else:
                r.resp.end({"sample_every": TR.sample_every(),
                            "traces": TR.summaries()})

        srv.get("/trace", trace_ep)

        def analytics_ep(r: RoutingContext) -> None:
            # heavy-hitter tables (docs/observability.md traffic
            # analytics): local top-K per dimension — same payload as
            # the inspection server's /analytics (one shared assembly)
            from ..utils import sketch as SK
            out = SK.snapshot()
            # per-node policed attribution (the enforcement half of
            # the analytics loop)
            from ..policing import engine as PE
            out["policing"] = {"self": PE.default().policed_by_node(),
                               "peers": {}}
            r.resp.end(out)

        srv.get("/analytics", analytics_ep)

        def policing_ep(r: RoutingContext) -> None:
            # Guardian enforcement surface (docs/robustness.md): engine
            # status + declared policies + the live per-key bucket
            # table — same payload as the inspection server's /policing
            from ..policing import engine as PE
            eng = PE.default()
            st = eng.status()
            st["policy_list"] = eng.list_policies()
            st["table"] = eng.table_snapshot()
            st["policed_by_node"] = eng.policed_by_node()
            st["shed_receipt"] = eng.shed_receipt()
            r.resp.end(st)

        srv.get("/policing", policing_ep)

        def workload_ep(r: RoutingContext) -> None:
            # the workload-capture artifact (utils/workload): the
            # current window's fitted model — same payload as the
            # inspection server's /workload, consumed live by
            # tools/replay.py (docs/replay.md)
            from ..utils import workload as WL
            r.resp.end(WL.export_model())

        srv.get("/workload", workload_ep)
        srv.post("/api/v1/command", self._command)
        srv.all("/api/v1/module/*", self._module)
        srv.listen(self.bind_port, self.bind_ip)
        self.bind_port = srv.port
        self._srv = srv

    def stop(self) -> None:
        if self._srv is not None:
            srv, self._srv = self._srv, None
            srv.close()

    # ----------------------------------------------------------- handlers

    def _command(self, r: RoutingContext) -> None:
        try:
            cmd = r.req.json().get("command", "")
            r.resp.end({"result": Command.execute(self.app, cmd)})
        except CmdError as e:
            r.resp.status(400).end({"error": str(e)})
        except json.JSONDecodeError as e:
            r.resp.status(400).end({"error": f"bad json: {e}"})
        except Exception as e:
            r.resp.status(500).end({"error": f"{type(e).__name__}: {e}"})

    def _module(self, r: RoutingContext) -> None:
        parts = [p for p in r.req.params.get("*", "").split("/") if p]
        if not parts or parts[0] not in MODULES:
            r.resp.status(404).end({"error": "no such module"})
            return
        rtype = MODULES[parts[0]]
        name = parts[1] if len(parts) > 1 else None
        sub = parts[2:] if len(parts) > 2 else []
        try:
            status, payload = self._dispatch(r.req.method, rtype, name, sub,
                                             r.req.body)
        except CmdError as e:
            status, payload = 400, {"error": str(e)}
        except json.JSONDecodeError as e:
            status, payload = 400, {"error": f"bad json: {e}"}
        except Exception as e:
            status, payload = 500, {"error": f"{type(e).__name__}: {e}"}
        r.resp.status(status).end(payload)

    @staticmethod
    def _cmdline(action: str, rtype: str, name: str, params: dict) -> str:
        toks = [action, rtype, name]
        for k, v in params.items():
            if k in FLAG_KEYS:
                if v:
                    toks.append(k)
            elif k == "annotations":
                toks += [k, json.dumps(v, separators=(",", ":"))
                         if isinstance(v, dict) else str(v)]
            else:
                toks += [k, str(v)]
        return " ".join(toks)

    # GET /module/{name}/<sub> answers from the typed object directly
    SUB_KEYS = {"server": "serverList", "server-group": "serverGroupList",
                "security-group-rule": "ruleList",
                "event-loop": "eventLoopList"}

    def _dispatch(self, method: str, rtype: str, name, sub, body: bytes):
        app = self.app
        if method == "GET":
            details = _details(app, rtype)
            if name is None:
                return 200, details
            obj = next((d for d in details if d["name"] == name), None)
            if obj is None:
                return 404, {"error": f"{rtype} {name} not found"}
            if not sub or sub == ["detail"]:
                return 200, obj
            key = self.SUB_KEYS.get(sub[0])
            if key is not None and key in obj:
                return 200, obj[key]
            return 200, Command.execute(
                app, f"list-detail {sub[0]} in {rtype} {name}")
        if method == "POST":
            params = json.loads(body or b"{}")
            if name is None:
                name = params.pop("name", None)
                if not name:
                    return 400, {"error": "name required"}
            if sub:  # POST /module/server-group/sg0/server {name, address,...}
                sname = params.pop("name", None)
                line = self._cmdline("add", sub[0], sname, params)
                line += f" to {rtype} {name}"
                return 200, {"result": Command.execute(app, line)}
            return 200, {"result": Command.execute(
                app, self._cmdline("add", rtype, name, params))}
        if method == "PUT":
            if name is None:
                return 405, {"error": "PUT requires a resource name"}
            params = json.loads(body or b"{}")
            return 200, {"result": Command.execute(
                app, self._cmdline("update", rtype, name, params))}
        if method == "DELETE":
            if name is None:
                return 405, {"error": "DELETE requires a resource name"}
            if sub:
                return 200, {"result": Command.execute(
                    app, f"remove {sub[0]} {sub[1]} from {rtype} {name}")}
            return 200, {"result": Command.execute(app,
                                                   f"force-remove {rtype} {name}")}
        return 405, {"error": f"method {method} not allowed"}
