"""Config persistence — the config IS a replayable command script.

Parity: app process/Shutdown.java — currentConfig() walks live resources
emitting `add ...` commands in dependency order (:269-760), save writes
the last-config file, load replays each line through the normal command
engine (:761). Auto-save runs hourly on the control loop (Main.java:371).

The port's copy of vproxy_tpu/control/persist.py, same config format:
a file saved by either package loads in the other.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from .app import (Application, DEFAULT_ACCEPTOR_ELG, DEFAULT_CONTROL_ELG,
                  DEFAULT_WORKER_ELG)
from .command import Command, _rule_to_anno

DEFAULT_DIR = os.environ.get("VPROXY_TPU_HOME", os.path.expanduser("~/.vproxy_tpu"))
LAST_CONFIG = os.path.join(DEFAULT_DIR, "vproxy.last")
_BUILTIN_ELGS = {DEFAULT_ACCEPTOR_ELG, DEFAULT_WORKER_ELG, DEFAULT_CONTROL_ELG}


def current_config(app: Application) -> str:
    """Serialize the resource graph to `add ...` commands in dependency
    order: elgs, security-groups(+rules), server-groups(+servers),
    upstreams(+attachments), then the frontends."""
    lines: list[str] = []
    for name, elg in app.elgs.items():
        if name in _BUILTIN_ELGS:
            continue
        lines.append(f"add event-loop-group {name}")
        for ln in elg.loop_names():
            lines.append(f"add event-loop {ln} to event-loop-group {name}")
    for g in app.security_groups.values():
        lines.append(f"add security-group {g.alias} default "
                     f"{'allow' if g.default_allow else 'deny'}")
        for r in g.rules:
            lines.append(
                f"add security-group-rule {r.alias} to security-group {g.alias} "
                f"network {r.network} protocol {r.protocol.value} "
                f"port-range {r.min_port},{r.max_port} "
                f"default {'allow' if r.allow else 'deny'}")
    for g in app.server_groups.values():
        elg_part = "" if g.elg is app.worker_elg else f" event-loop-group {g.elg.name}"
        anno = _rule_to_anno(g.annotations)
        anno_part = f" annotations {anno}" if anno != "{}" else ""
        lines.append(
            f"add server-group {g.alias} timeout {g.hc.timeout_ms} "
            f"period {g.hc.period_ms} up {g.hc.up} down {g.hc.down} "
            f"protocol {g.hc.protocol} method {g.method}{elg_part}{anno_part}")
        for s in g.servers:
            lines.append(f"add server {s.name} to server-group {g.alias} "
                         f"address {s.ip}:{s.port} weight {s.weight}")
    for u in app.upstreams.values():
        lines.append(f"add upstream {u.alias}")
        for h in u.handles:
            anno = _rule_to_anno(h.annotations)
            anno_part = f" annotations {anno}" if anno != "{}" else ""
            lines.append(f"add server-group {h.alias} to upstream {u.alias} "
                         f"weight {h.weight}{anno_part}")
    for ck in app.cert_keys.values():
        lines.append(f"add cert-key {ck.alias} cert {ck.cert_path} "
                     f"key {ck.key_path}")
    from ..components.tcplb import MAX_SESSIONS as _MAX_SESSIONS
    from ..components.tcplb import POOL_SIZE as _POOL_SIZE
    for lb in app.tcp_lbs.values():
        secg_part = ("" if lb.security_group.alias == "(allow-all)"
                     else f" security-group {lb.security_group.alias}")
        ck_part = ("" if not lb.cert_keys else
                   " cert-key " + ",".join(ck.alias for ck in lb.cert_keys))
        ms_part = ("" if lb.max_sessions == _MAX_SESSIONS
                   else f" max-sessions {lb.max_sessions}")
        pool_part = ("" if lb.pool_size == _POOL_SIZE
                     else f" pool-size {lb.pool_size}")
        lines.append(
            f"add tcp-lb {lb.alias} address {lb.bind_ip}:{lb.bind_port} "
            f"upstream {lb.backend.alias} protocol {lb.protocol} "
            f"timeout {lb.timeout_ms} "
            f"in-buffer-size {lb.in_buffer_size}{secg_part}{ck_part}"
            f"{ms_part}{pool_part}")
    for s in app.socks5_servers.values():
        flag = " allow-non-backend" if s.allow_non_backend else ""
        secg_part = ("" if s.security_group.alias == "(allow-all)"
                     else f" security-group {s.security_group.alias}")
        lines.append(
            f"add socks5-server {s.alias} address {s.bind_ip}:{s.bind_port} "
            f"upstream {s.backend.alias} timeout {s.timeout_ms}"
            f"{secg_part}{flag}")
    for d in app.dns_servers.values():
        secg_part = ("" if d.security_group.alias == "(allow-all)"
                     else f" security-group {d.security_group.alias}")
        lines.append(f"add dns-server {d.alias} address {d.bind_ip}:{d.bind_port} "
                     f"upstream {d.rrsets.alias} ttl {d.ttl}{secg_part}")
    for sw in app.switches.values():
        secg_part = ("" if sw.bare_access.alias == "(allow-all)"
                     else f" security-group {sw.bare_access.alias}")
        lines.append(
            f"add switch {sw.alias} address {sw.bind_ip}:{sw.bind_port} "
            f"mac-table-timeout {sw.mac_table_timeout_ms} "
            f"arp-table-timeout {sw.arp_table_timeout_ms}{secg_part}")
        for net in sw.networks.values():
            v6 = f" v6network {net.v6net}" if net.v6net else ""
            anno = (" annotations " + json.dumps(net.annotations,
                                                 separators=(",", ":"))
                    if net.annotations else "")
            lines.append(f"add vpc {net.vni} to switch {sw.alias} "
                         f"v4network {net.v4net}{v6}{anno}")
            from ..utils.ip import format_ip
            from ..vswitch.packets import mac_str
            from ..vswitch.switch import synthetic_mac
            for ip, mac in net.ips.ips().items():
                # non-default macs (e.g. the docker gateway mac) must
                # survive the replay or post-reload Joins break
                mac_part = ("" if mac == synthetic_mac(net.vni, ip)
                            else f" mac {mac_str(mac)}")
                lines.append(f"add ip {format_ip(ip)} to vpc {net.vni} "
                             f"in switch {sw.alias}{mac_part}")
            for r in net.routes.rules:
                tgt = f"vni {r.to_vni}" if r.to_vni else \
                    f"via {format_ip(r.via_ip)}"
                lines.append(f"add route {r.alias} to vpc {net.vni} "
                             f"in switch {sw.alias} network {r.rule} {tgt}")
        from ..vswitch.switch import display_user_name
        for user, (_key, vni, password) in sw.users.items():
            lines.append(f"add user {display_user_name(user)} "
                         f"to switch {sw.alias} "
                         f"password {password} vni {vni}")
        for iface in sw.list_ifaces():
            if iface.name.startswith("remote:"):
                lines.append(
                    f"add switch {iface.alias} to switch {sw.alias} "
                    f"address {iface.remote[0]}:{iface.remote[1]}")
            elif iface.name.startswith("tap:"):
                ps = (f" post-script {iface.post_script}"
                      if iface.post_script else "")
                anno = (" annotations " + json.dumps(
                    iface.annotations, separators=(",", ":"))
                    if iface.annotations else "")
                lines.append(f"add tap {iface.dev} to switch {sw.alias} "
                             f"vni {iface.local_side_vni}{ps}{anno}")
    # the reference emits docker plugin controllers here; the port has
    # none until ROADMAP Queue A item 10 lands, and their add command
    # refuses, so no app can hold one
    from ..policing import engine as _policing
    for p in _policing.default().list_policies():
        tenant_part = f" tenant={p['tenant']}" if p["tenant"] else ""
        lines.append(f"add policy {p['name']} dim={p['dim']} "
                     f"rate={p['rate']:g} burst={p['burst']:g} "
                     f"action={p['action']}{tenant_part}")
    return "\n".join(lines) + ("\n" if lines else "")


def save(app: Application, path: Optional[str] = None) -> str:
    path = path or LAST_CONFIG
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(current_config(app))
    return path


def load(app: Application, path: Optional[str] = None) -> int:
    """Replay a config file through the command engine; returns the number
    of commands executed."""
    path = path or LAST_CONFIG
    n = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            Command.execute(app, line)
            n += 1
    return n


def start_auto_save(app: Application, interval_ms: int = 3600_000,
                    path: Optional[str] = None):
    """Hourly auto-save on the control loop (Main.java:369-371)."""
    return app.control_loop.period(interval_ms, lambda: save(app, path))
