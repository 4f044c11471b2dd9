"""Switch — the virtual L2/L3 SDN switch resource.

The port of `vproxy_tpu/vswitch/switch.py`, same names and behaviour.

Parity: core vswitch/Switch.java:36 — ONE UDP socket receives every
VXLAN/encrypted frame (:50); the sender address maps to an iface in the
registry with a 60s activity timeout (:629-799, IFACE_TIMEOUT :630);
user management (add/del user = per-user AES-256 key + assigned VNI);
`handleNetworkAndGetVXLanPacket` (:643-744): plain VXLAN is gated by the
bare-access SecurityGroup, anything else must decrypt as a
VProxySwitchPacket under a known user's key; ping packets refresh the
iface and are answered. Per-VNI VpcNetwork + NetworkStack do L2/L3.
"""
from __future__ import annotations

import hashlib
import time
from typing import Optional

from ..components.secgroup import SecurityGroup
from ..net import vtl
from ..net.eventloop import SelectorEventLoop
from ..rules.ir import Proto
from ..utils.log import Logger
from ..utils.ip import Network, parse_ip
from . import swmetrics
from .iface import (BareVXLanIface, Iface, RemoteSwitchIface, TapIface,
                    UserClientIface, UserIface, tap_supported)
from .network import ARP_TABLE_TIMEOUT, MAC_TABLE_TIMEOUT, VpcNetwork
from .packets import (PacketError, VPROXY_TYPE_PING, VPROXY_TYPE_VXLAN,
                      VProxySwitchPacket, Vxlan)
from .stack import NetworkStack

_log = Logger("switch")

IFACE_TIMEOUT_MS = 60_000  # Switch.java:630


def format_user_name(user: str) -> str:
    """3-8 chars [a-zA-Z0-9], padded to 8 with '+' so the name is exactly
    8 base64 chars = the 6 raw bytes on the wire (Switch.formatUserName
    :431-446, Consts.USER_PADDING). Without this, a short name crashes
    the encrypted-packet encoder at SEND time with a base64 error."""
    if not (3 <= len(user) <= 8):
        raise ValueError("invalid user, should be at least 3 chars and "
                         "at most 8 chars")
    if not all(c.isascii() and c.isalnum() for c in user):
        raise ValueError("invalid user, should only contain a-zA-Z0-9")
    return user + "+" * (8 - len(user))


def display_user_name(user: str) -> str:
    """Wire form ('+'-padded to 8) back to the operator's name."""
    return user.rstrip("+")


def synthetic_mac(vni: int, ip: bytes) -> bytes:
    """Deterministic locally-administered mac for a synthetic ip."""
    h = hashlib.sha256(vni.to_bytes(4, "big") + ip).digest()
    return bytes([0x02]) + h[:5]


class Switch:
    def __init__(self, alias: str, loop: SelectorEventLoop, bind_ip: str,
                 bind_port: int,
                 mac_table_timeout_ms: int = MAC_TABLE_TIMEOUT,
                 arp_table_timeout_ms: int = ARP_TABLE_TIMEOUT,
                 bare_vxlan_access: Optional[SecurityGroup] = None,
                 matcher_backend: Optional[str] = None, elg=None):
        self.alias = alias
        self.loop = loop
        self.elg = elg  # attach target for loop-death re-homing
        self.bind_ip = bind_ip
        self.bind_port = bind_port
        self.mac_table_timeout_ms = mac_table_timeout_ms
        self.arp_table_timeout_ms = arp_table_timeout_ms
        self.bare_access = bare_vxlan_access or SecurityGroup.allow_all()
        self.matcher_backend = matcher_backend
        self.networks: dict[int, VpcNetwork] = {}
        # user -> (key, vni, password); password kept for config persistence
        # (Shutdown.currentConfig serializes users with their passwords)
        self.users: dict[str, tuple[bytes, int, str]] = {}
        self.ifaces: dict = {}  # key -> (Iface, last_active_ts)
        # bumped on any registry mutation; the fast path's remote cache
        # (vswitch/fastpath.py) keys its validity on it
        self._reg_version = 0
        # remote (ip, port) -> registry key, so the per-datagram sender
        # lookup is O(1) instead of a scan over every registered iface
        self._remote_idx: dict[tuple[str, int], tuple] = {}
        self.stack = NetworkStack(self)
        # vectorized burst fast path (vswitch/fastpath.py); slow-path
        # leftovers keep the object pipeline. VPROXY_TPU_SWITCH_FASTPATH=0
        # forces the pure object path (A/B + debugging escape hatch).
        import os as _os
        self.fastpath = None
        if _os.environ.get("VPROXY_TPU_SWITCH_FASTPATH", "1") != "0":
            from .fastpath import SwitchFastPath
            self.fastpath = SwitchFastPath(self)
        # native flow cache (native/vtl.cpp): the in-C exact-match flow
        # table + forwarding loop. Needs the fast path (it compiles the
        # entries) and the native provider. VPROXY_TPU_FLOWCACHE=0 forces
        # the pure Python data plane (A/B + escape hatch).
        self._fc = None           # C table handle (vtl.flowcache_new)
        self._fc_active = False   # poll/install gate (bench A/B toggle)
        self._fc_enabled = (
            self.fastpath is not None
            and _os.environ.get("VPROXY_TPU_FLOWCACHE", "1") != "0")
        # multiqueue ingress: N EXTRA SO_REUSEPORT sockets, each drained
        # by a plain thread running the C forwarding loop — hits scale
        # across cores because vtl_switch_poll releases the GIL. Misses
        # are handed to the owning loop for classification. Per-entry
        # seqlocks in the C table make concurrent probe-vs-install safe.
        self._n_pollers = int(_os.environ.get("VPROXY_TPU_SWITCH_POLLERS",
                                              "0"))
        self._pollers: list = []
        self._poller_fds: list[int] = []
        self._pollers_stop = False
        self._fd: Optional[int] = None
        self._sweeper = None
        self._hh_task = None  # analytics flow-drain periodic
        self.started = False

    # ------------------------------------------------------------ control

    def start(self) -> None:
        if self.started:
            return
        self._init_flowcache()
        self.bare_access.add_listener(self._gen_bump)
        self._bind(self.loop)
        if self.elg is not None:
            self.elg.attach(self)
        self.started = True

    # ------------------------------------------------------- flow cache

    def _init_flowcache(self) -> None:
        if not self._fc_enabled or self._fc is not None:
            return
        if vtl.PROVIDER != "native" or not vtl.flowcache_supported():
            return
        import os as _os
        size = int(_os.environ.get("VPROXY_TPU_FLOWCACHE_SIZE", "65536"))
        ttl = int(_os.environ.get("VPROXY_TPU_FLOWCACHE_TTL_MS", "10000"))
        self._fc = vtl.flowcache_new(size, ttl)
        self._fc_active = True
        # analytics: the flow cache's per-entry hit tallies gate on the
        # same C atomic as the lane shards — push the current knob
        from ..utils import sketch
        sketch.push_native_knob()

    def flow_handle(self):
        """C flow-table handle for the fast path's entry compiler, or
        None when the native cache is off/inactive."""
        return self._fc if self._fc_active else None

    def set_flowcache(self, on: bool) -> None:
        """Hot A/B toggle (bench + operators). Entries survive a
        disable/enable cycle: mutations keep bumping the generation
        while inactive, so surviving entries stay correctly gated.
        Poller threads follow the toggle (their REUSEPORT sockets close
        on disable so the kernel rehashes all flows to the main sock)."""
        if on and self._fc is None:
            self._fc_enabled = True
            self._init_flowcache()
        self._fc_active = bool(on) and self._fc is not None
        if self._fc_active and self.started:
            self._start_pollers()
            self._arm_hh_task()  # a cache created by THIS hot-enable
            # missed _bind's arming — without this the per-entry hit
            # tallies would accumulate with no drain forever
        elif not self._fc_active:
            self._stop_pollers()

    def _arm_hh_task(self) -> None:
        """Arm the analytics flow-drain periodic (idempotent; on the
        owning loop). The tick itself gates on sketch.enabled()."""
        if self._fc is None or not vtl.hh_supported():
            return
        from ..utils import sketch

        def arm() -> None:
            if self._hh_task is None and self._fc is not None:
                self._hh_task = self.loop.period(
                    max(500, int(sketch.WINDOW_S * 250)),
                    self._hh_flow_tick)
        self.loop.run_on_loop(arm)

    # ------------------------------------------------ multiqueue pollers

    def _start_pollers(self) -> None:
        if (self._pollers or self._n_pollers <= 0 or self._fc is None
                or not self._fc_active or self._fd is None
                or vtl.PROVIDER != "native"):
            return
        import threading
        self._pollers_stop = False
        for i in range(self._n_pollers):
            try:
                fd = vtl.udp_bind(self.bind_ip, self.bind_port,
                                  reuseport=True)
            except OSError:
                break  # main sock not reuseport-bound: feature inactive
            vtl.set_rcvbuf(fd, 4 << 20)
            self._poller_fds.append(fd)
            th = threading.Thread(target=self._poller_main, args=(fd,),
                                  name=f"swpoll-{self.alias}-{i}",
                                  daemon=True)
            self._pollers.append(th)
            th.start()

    def _stop_pollers(self) -> None:
        if not self._pollers:
            return
        self._pollers_stop = True
        ths, self._pollers = self._pollers, []
        self._poller_fds = []
        for th in ths:
            th.join(timeout=2.0)  # wait_readable parks at most 200ms

    @staticmethod
    def _mirror_blocks() -> bool:
        """A hot mirror tapping the switch must see EVERY frame: the C
        lane is bypassed entirely while it is armed (cached hits would
        be invisible to the tap)."""
        from ..utils.mirror import Mirror
        mir = Mirror.get()
        return mir.hot and mir.wants("switch")

    def _poller_main(self, fd: int) -> None:
        """One multiqueue lane: park in poll(2), drain through the C
        forwarding loop, hand misses to the owning event loop. The
        thread closes its own socket on exit (no cross-thread close/fd
        reuse race)."""
        import errno as _errno
        try:
            while not self._pollers_stop:
                try:
                    if vtl.wait_readable(fd, 200) <= 0:
                        continue
                    if self._pollers_stop:
                        return
                    fc = self._fc
                    if fc is None or not self._fc_active:
                        return
                    if self._mirror_blocks():
                        # drain this lane straight to the object path
                        # so the mirror sees frames the cache would eat
                        got = vtl.recvmmsg(fd)
                        if got:
                            self.loop.run_on_loop(
                                lambda m=got: self._input_batch(
                                    m, small_ok=True))
                        continue
                    handled, miss = vtl.switch_poll(fc, fd)
                except OSError as e:
                    # a dead socket ends the lane (shutdown path); a
                    # transient error (ENOBUFS under pressure) must NOT
                    # silently cost 1/N ingress capacity forever
                    if self._pollers_stop or e.errno == _errno.EBADF:
                        return
                    _log.warn(f"switch {self.alias}: poller lane "
                              f"error (retrying): {e!r}")
                    time.sleep(0.01)
                    continue
                if handled:
                    swmetrics.rx(handled)
                if miss:
                    self.loop.run_on_loop(
                        lambda m=miss: self._input_batch(m, small_ok=True))
        finally:
            vtl.close(fd)

    def _hh_flow_tick(self) -> None:
        """Fold the C flow-table hit tallies into the flows dimension
        (utils/sketch). Bounded: at most 8 drain calls per tick — the
        cursor resumes next tick; each call is one quick C walk."""
        from ..net.vtl import _HH_DRAIN_MAX, hh_flow_drain
        from ..utils import sketch
        fc = self._fc
        if fc is None or not sketch.enabled():
            return
        try:
            for _ in range(8):
                recs = hh_flow_drain(fc)
                if recs:
                    sketch.ingest_hh_recs(recs)
                if len(recs) < _HH_DRAIN_MAX:
                    break
        except OSError:
            pass

    def _gen_bump(self, *_a) -> None:
        """Every route/ACL/MAC/ARP/owned-ip/iface mutation lands here:
        one C atomic bump invalidates every installed flow entry (probe
        sees a stale generation -> forced miss -> Python re-decides).
        The switch.flowcache.stale failpoint suppresses one bump to
        prove the gate is what prevents stale forwarding."""
        fc = self._fc
        if fc is None:
            return
        from ..utils import failpoint
        if failpoint.hit("switch.flowcache.stale", self.alias):
            return
        vtl.switch_gen_bump(fc)

    def _bump_registry(self) -> None:
        self._reg_version += 1
        self._gen_bump()

    def flowcache_info(self) -> Optional[dict]:
        """`list-detail switch` / tests: THIS switch's table occupancy
        and probe outcomes (an old .so reporting only 3 stat fields
        falls back to the process-global tallies)."""
        if self._fc is None:
            return None
        st = vtl.flowcache_stat(self._fc)
        size, used, gen = st[0], st[1], st[2]
        if len(st) >= 5:
            hits, misses = st[3], st[4]
        else:
            c = vtl.flowcache_counters()
            hits, misses = c[0], c[1]
        return {"active": self._fc_active, "size": size, "used": used,
                "gen": gen, "hits": hits, "misses": misses,
                "hit_rate": round(hits / (hits + misses), 4)
                if hits + misses else 0.0}

    def _bind(self, loop) -> None:
        def mk() -> None:
            # reuseport when multiqueue pollers are configured: their
            # sockets join this binding and the kernel shards flows
            self._fd = vtl.udp_bind(
                self.bind_ip, self.bind_port,
                reuseport=self._n_pollers > 0 and self._fc is not None)
            # bursty VXLAN ingress: the default ~200KB rcvbuf holds only
            # a few hundred datagrams — absorb whole bursts instead
            vtl.set_rcvbuf(self._fd, 4 << 20)
            if self.bind_port == 0:
                _, self.bind_port = vtl.sock_name(self._fd)
            loop.add(self._fd, vtl.EV_READ, self._on_readable)
            self._sweeper = loop.period(IFACE_TIMEOUT_MS // 4,
                                        self._sweep_ifaces)
            from ..utils import sketch
            if self._fc is not None and vtl.hh_supported():
                # analytics tick: drain the C per-flow hit tallies into
                # the flows dimension (a fraction of the window so the
                # epoch rotation sees fresh counts). Armed regardless
                # of the CURRENT knob — the tick itself gates on
                # sketch.enabled(), so a runtime configure(True) starts
                # flowing without a rebind (a boot-time-only gate left
                # the flows dim permanently empty after a late enable).
                # set_flowcache(True) arms via _arm_hh_task for caches
                # created after boot.
                self._hh_task = loop.period(
                    max(500, int(sketch.WINDOW_S * 250)),
                    self._hh_flow_tick)
        try:
            loop.call_sync(mk)
        except OSError as e:
            raise OSError(f"switch {self.alias}: bind failed: {e}") from e
        self._start_pollers()

    def on_loop_death(self, group, lp) -> None:
        """Re-home the switch's VXLAN sock onto a surviving loop when
        the hosting loop dies. VPC state and MAC/ARP tables are plain
        host memory and survive. Ifaces:

        * fd-less (bare-vxlan / remote-switch / user server side) —
          survive untouched; their traffic rides the re-homed sock;
        * user-client — re-arms its keepalive periodic on the new loop;
        * tap — its /dev/net/tun fd died with the loop and is dropped
          from the registry WITHOUT close() (the dead loop released the
          fd; closing the stale number could hit a reused descriptor).
        """
        from .iface import TapIface, UserClientIface
        if lp is not self.loop or not self.started:
            return
        self._fd = None
        self._sweeper = None
        self._hh_task = None  # died with the loop; _bind re-arms it
        for key, (iface, ts) in list(self.ifaces.items()):
            if isinstance(iface, TapIface):
                del self.ifaces[key]
                self._bump_registry()
                self._unindex(key, iface)
                for net in self.networks.values():
                    net.macs.remove_iface(iface)
        if not group.loops:
            self.started = False
            group.detach(self)
            return
        self.loop = group.next()
        try:
            self._bind(self.loop)
        except OSError as e:
            _log.alert(f"switch {self.alias}: re-home bind failed: {e!r}; "
                       f"switch is down")
            self.started = False
            group.detach(self)
            return
        for _key, (iface, _ts) in list(self.ifaces.items()):
            if isinstance(iface, UserClientIface):
                iface._periodic = None  # old timer died with the loop
                iface.attach(self)
        if not self.started:  # raced a concurrent stop(): undo the bind
            self._undo_rehome_bind()

    def _undo_rehome_bind(self) -> None:
        fd, self._fd = self._fd, None
        sweeper, self._sweeper = self._sweeper, None
        hh_task, self._hh_task = self._hh_task, None
        lp2 = self.loop

        def rm() -> None:
            if sweeper is not None:
                sweeper.cancel()
            if hh_task is not None:
                hh_task.cancel()
            if fd is not None:
                lp2.remove(fd)
                vtl.close(fd)
        lp2.run_on_loop(rm)

    def stop(self) -> None:
        if not self.started:
            return
        self.started = False
        if self.elg is not None:
            self.elg.detach(self)
        self.bare_access.remove_listener(self._gen_bump)
        self._stop_pollers()
        fd = self._fd
        self._fd = None
        # detach the handle first (mutation hooks stop bumping), free on
        # the loop thread where the poll/install paths run
        fc, self._fc = self._fc, None
        self._fc_active = False

        def rm() -> None:
            if self._sweeper is not None:
                self._sweeper.cancel()
            if self._hh_task is not None:
                self._hh_task.cancel()
                self._hh_task = None
            for iface, _ in list(self.ifaces.values()):
                iface.close()
            self.ifaces.clear()
            self._reg_version += 1
            self._remote_idx.clear()
            if fd is not None:
                self.loop.remove(fd)
                vtl.close(fd)
            if fc is not None:
                vtl.flowcache_free(fc)
        self.loop.run_on_loop(rm)

    # ---------------------------------------------------------- resources

    def add_network(self, vni: int, v4net: Network,
                    v6net: Optional[Network] = None,
                    annotations: Optional[dict] = None) -> VpcNetwork:
        if vni in self.networks:
            raise ValueError(f"vpc {vni} already exists")
        net = VpcNetwork(vni, v4net, v6net, self.mac_table_timeout_ms,
                         self.arp_table_timeout_ms, self.matcher_backend,
                         annotations=annotations)
        # every table mutation (mapping changes only, not timestamp
        # refreshes) invalidates the native flow cache via one atomic
        net.macs.on_change = self._gen_bump
        net.arps.on_change = self._gen_bump
        net.ips.on_change = self._gen_bump
        net.on_route_change = self._gen_bump
        self.networks[vni] = net
        self._gen_bump()
        return net

    def del_network(self, vni: int) -> None:
        if vni not in self.networks:
            raise KeyError(vni)
        del self.networks[vni]
        self._gen_bump()

    def add_user(self, user: str, password: str, vni: int) -> None:
        """user: 3-8 chars [a-zA-Z0-9], stored '+'-padded to 8 (the wire
        form); key derived from password (Aes256Key: sha256 of the
        password bytes)."""
        user = format_user_name(user)
        if user in self.users:
            raise ValueError(f"user {display_user_name(user)} already exists")
        key = hashlib.sha256(password.encode()).digest()
        self.users[user] = (key, vni, password)

    def del_user(self, user: str) -> None:
        del self.users[format_user_name(user)]

    def key_for_user(self, user: str) -> Optional[bytes]:
        ent = self.users.get(user)
        return ent[0] if ent is not None else None

    def add_remote_switch(self, alias: str, ip: str, port: int) -> RemoteSwitchIface:
        iface = RemoteSwitchIface(alias, ip, port)
        self._register(("remote", alias), iface, permanent=True)
        return iface

    def add_user_client(self, user: str, password: str, vni: int,
                        ip: str, port: int) -> UserClientIface:
        user = format_user_name(user)
        key = hashlib.sha256(password.encode()).digest()
        iface = UserClientIface(user, key, ip, port)
        iface.local_side_vni = vni
        self._register(("ucli", user, (ip, port)), iface, permanent=True)
        iface.attach(self)
        return iface

    def add_tap(self, pattern: str, vni: int,
                post_script: Optional[str] = None,
                annotations: Optional[dict] = None) -> TapIface:
        """post_script: executable run after the device exists with DEV
        set to the tap name (Switch.addTap's post-script hook — the
        docker driver uses it to move the tap into a container netns
        after a restart)."""
        if not tap_supported():
            raise OSError("tap devices not available (/dev/net/tun)")
        iface = TapIface(pattern, vni, self.loop, self._tap_frame,
                         annotations=annotations)
        iface.post_script = post_script
        if post_script:
            import os
            import subprocess
            if os.path.exists(post_script):
                try:
                    r = subprocess.run(["/bin/bash", post_script],
                                       env={**os.environ, "DEV": iface.dev},
                                       capture_output=True, timeout=10)
                except subprocess.TimeoutExpired:
                    iface.close()
                    raise OSError(f"post script {post_script} timed out "
                                  "(10s); tap removed")
                if r.returncode != 0:
                    iface.close()
                    raise OSError(
                        f"post script {post_script} failed "
                        f"({r.returncode}): {r.stderr.decode()[:200]}")
        self._register(("tap", iface.dev), iface, permanent=True)
        return iface

    def list_ifaces(self) -> list[Iface]:
        return [i for i, _ in self.ifaces.values()]

    def ifaces_for_vni(self, vni: int):
        out = []
        for iface, _ in self.ifaces.values():
            if iface.local_side_vni in (0, vni):
                out.append(iface)
        return out

    def _close_iface(self, iface: Iface) -> None:
        """Close AFTER the generation bump — and for tap ifaces (the
        only kind whose fd lives inside native flow entries) after a
        grace period longer than any in-flight C poll round, so a
        racing hit can never write() a recycled descriptor."""
        if isinstance(iface, TapIface) and self._fc is not None:
            import threading
            threading.Timer(0.2, iface.close).start()
        else:
            iface.close()

    def remove_iface(self, name: str) -> None:
        for key, (iface, _) in list(self.ifaces.items()):
            if iface.name == name:
                # generation bump BEFORE the close: a poller hitting a
                # native TAP entry must never write a recycled fd
                del self.ifaces[key]
                self._bump_registry()
                self._close_iface(iface)
                self._unindex(key, iface)
                for net in self.networks.values():
                    net.macs.remove_iface(iface)
                return
        raise KeyError(name)

    # ---------------------------------------------------------- data path

    def send_udp(self, data: bytes, remote: tuple[str, int]) -> None:
        if self._fd is not None:
            try:
                if vtl.sendto(self._fd, data, remote[0], remote[1]) < 0:
                    swmetrics.drop("egress_short_write")  # EAGAIN
            except OSError:
                swmetrics.drop("egress_short_write")

    def send_udp_many(self, datas: list, remote: tuple[str, int]) -> int:
        """Batched same-destination egress (fast-path groups): one
        sendmmsg when the native provider offers it. -> count accepted
        by the kernel (datagram drops under pressure are normal — and
        counted as egress_short_write so the drop rate is visible)."""
        if self._fd is None:
            return 0
        try:
            if vtl.PROVIDER == "native" and hasattr(vtl, "sendmmsg"):
                n = vtl.sendmmsg(self._fd, datas, remote[0], remote[1])
            else:
                n = 0
                for d in datas:
                    if vtl.sendto(self._fd, d, remote[0], remote[1]) < 0:
                        break
                    n += 1
            swmetrics.drop("egress_short_write", len(datas) - n)
            return n
        except OSError:
            swmetrics.drop("egress_short_write", len(datas))
            return 0

    def _register(self, key, iface: Iface, permanent: bool = False):
        self._bump_registry()
        self.ifaces[key] = (iface, float("inf") if permanent else time.monotonic())
        r = getattr(iface, "remote", None)
        if r is not None:
            if key[0] == "bare":
                # a configured link (remote-switch / ucli / user) for the
                # same addr keeps priority over an ad-hoc bare identity
                self._remote_idx.setdefault(r, key)
            else:
                self._remote_idx[r] = key
        return iface

    def _unindex(self, key, iface: Iface) -> None:
        r = getattr(iface, "remote", None)
        if r is None or self._remote_idx.get(r) != key:
            return
        del self._remote_idx[r]
        # repopulate from surviving ifaces with the same remote, keeping
        # configured links (remote-switch/ucli/user) ahead of bare ones —
        # identity must not be lost when a shadowing iface goes away
        fallback = None
        for k, (i, _) in self.ifaces.items():
            if getattr(i, "remote", None) == r:
                if k[0] != "bare":
                    self._remote_idx[r] = k
                    return
                fallback = k
        if fallback is not None:
            self._remote_idx[r] = fallback

    def _touch(self, key) -> None:
        ent = self.ifaces.get(key)
        if ent is not None and ent[1] != float("inf"):
            self.ifaces[key] = (ent[0], time.monotonic())

    def _sweep_ifaces(self) -> None:
        now = time.monotonic()
        for key, (iface, ts) in list(self.ifaces.items()):
            if ts == float("inf"):
                continue
            if (now - ts) * 1000 > IFACE_TIMEOUT_MS:
                del self.ifaces[key]
                self._bump_registry()  # before close: see remove_iface
                self._close_iface(iface)
                self._unindex(key, iface)
                for net in self.networks.values():
                    net.macs.remove_iface(iface)

    def _tap_frame(self, iface: TapIface, ether) -> None:
        self.stack.input_vxlan(Vxlan(iface.local_side_vni, ether), iface)

    RECV_BURST = 1024  # datagrams drained per wakeup before batch classify

    def _on_readable(self, fd: int, ev: int) -> None:
        """Drain a burst, then process it with batched ACL + LPM: the
        reference handles one datagram per handler pass
        (Switch.java:629-799); here the burst is the unit so the 5k-rule
        bare ACL and 50k-route LPM cost ONE device dispatch each per
        burst, not per packet. With the native flow cache active the
        drain runs INSIDE C (vtl_switch_poll): repeat-flow datagrams are
        forwarded without ever reaching Python and only misses surface
        here as a burst."""
        if self._fc_active and self._fc is not None \
                and not self._mirror_blocks():
            self._poll_native(fd)
            return
        batched = vtl.PROVIDER == "native" and hasattr(vtl, "recvmmsg")
        while self._fd is not None:
            burst = []
            if batched:  # one syscall per up-to-_MMSG_MAX dgrams
                while len(burst) < self.RECV_BURST:
                    got = vtl.recvmmsg(fd)
                    if not got:
                        break
                    burst.extend(got)
            else:
                while len(burst) < self.RECV_BURST:
                    r = vtl.recvfrom(fd)
                    if r is None:
                        break
                    burst.append(r)
            if not burst:
                return
            self._input_batch(burst)
            if len(burst) < self.RECV_BURST:
                return

    def _poll_native(self, fd: int) -> None:
        """The flow-cached drain: C forwards hits, misses accumulate
        into a Python burst (up to RECV_BURST before classify, so the
        cold-start all-miss case keeps today's amortization)."""
        fc = self._fc
        pending: list = []
        while self._fd is not None:
            handled, miss = vtl.switch_poll(fc, fd)
            if handled:
                swmetrics.rx(handled)
            if miss:
                pending.extend(miss)
            done = not handled and not miss
            if pending and (done or len(pending) >= self.RECV_BURST):
                # small miss bursts still classify+install (small_ok):
                # a trickle flow must compile its entry, not stay on
                # the per-packet object path forever
                self._input_batch(pending, small_ok=True)
                pending = []
            if done:
                return

    def _parse_bare(self, data: bytes) -> Optional[Vxlan]:
        """Plain VXLAN? (Switch.java:643-744 tries vxlan flags first.)"""
        if len(data) >= 8 and data[0] & 0x08 and not data[1] and not data[2]:
            try:
                return Vxlan.parse(data)
            except PacketError:
                return None
        return None

    def _resolve_remote_key(self, remote: tuple[str, int]):
        """-> (iface, registry key) for a bare sender addr, registered/
        refreshed. A configured remote-switch/ucli link for this addr
        reuses that iface identity instead of a new bare one (the index
        keeps configured links in priority — _register)."""
        key = self._remote_idx.get(remote)
        ent = self.ifaces.get(key) if key is not None else None
        if ent is None:
            key = ("bare", remote)
            ent = self.ifaces.get(key)  # unindexed survivor: reuse, don't orphan
            if ent is None:
                known = self._register(key, BareVXLanIface(*remote))
            else:
                known = ent[0]
                self._remote_idx.setdefault(remote, key)
        else:
            known = ent[0]
        self._touch(key)
        return known, key

    def _resolve_remote(self, remote: tuple[str, int]):
        return self._resolve_remote_key(remote)[0]

    def _resolve_bare(self, pkt: Vxlan, remote: tuple[str, int]):
        known = self._resolve_remote(remote)
        if known.local_side_vni:
            pkt = Vxlan(known.local_side_vni, pkt.ether)
        return pkt, known

    def _input_batch(self, burst, small_ok: bool = False) -> None:
        swmetrics.rx(len(burst))
        pending = None
        if self.fastpath is not None:
            # leftovers (control frames, non-bare, v6) run through the
            # object pipeline FIRST in arrival order, so their table
            # learns are visible to the vectorized rows flushed after
            burst, pending = self.fastpath.split(burst, small_ok)
            if not burst:
                if pending is not None:
                    self.fastpath.flush(pending)
                return
        bare: list = []    # (Vxlan, remote)
        other: list = []   # (data, remote) — encrypted / non-vxlan
        for data, ip, port in burst:
            pkt = self._parse_bare(data)
            if pkt is not None:
                bare.append((pkt, (ip, port)))
            else:
                other.append((data, (ip, port)))
        admitted = []
        if bare:
            allowed = self.bare_access.allow_batch(
                Proto.UDP, [parse_ip(r[0]) for _, r in bare],
                [self.bind_port] * len(bare))
            admitted = [self._resolve_bare(pkt, remote)
                        for (pkt, remote), ok in zip(bare, allowed) if ok]
            swmetrics.drop("acl_deny", len(bare) - len(admitted))
        if admitted:
            self.stack.input_vxlan_batch(admitted)
        for data, remote in other:
            self._input(data, remote)
        if pending is not None:
            self.fastpath.flush(pending)

    def _input(self, data: bytes, remote: tuple[str, int]) -> None:
        pkt = self._parse_bare(data)
        if pkt is not None:
            if not self.bare_access.allow(Proto.UDP, parse_ip(remote[0]),
                                          self.bind_port):
                swmetrics.drop("acl_deny")
                return
            pkt, known = self._resolve_bare(pkt, remote)
            self.stack.input_vxlan(pkt, known)
            return
        # 2) encrypted vproxy switch packet under a known user key
        def key_for(user: str):
            # server side: configured users; client side: ucli iface keys
            k = self.key_for_user(user)
            if k is not None:
                return k
            for iface, _ in self.ifaces.values():
                if isinstance(iface, UserClientIface) and iface.user == user:
                    return iface.key
            return None

        try:
            sp = VProxySwitchPacket.parse(data, key_for)
        except PacketError:
            return
        ent = self.users.get(sp.user)
        if ent is not None:
            _, vni, _pw = ent
            key = ("user", sp.user, remote)
            if key not in self.ifaces:
                self._register(key, UserIface(sp.user, remote, vni))
            self._touch(key)
            iface = self.ifaces[key][0]
        else:
            # client side receiving from the server it dialed
            iface = None
            for k, (i, _) in self.ifaces.items():
                if isinstance(i, UserClientIface) and i.user == sp.user \
                        and i.remote == remote:
                    iface, key = i, k
                    break
            if iface is None:
                return
            self._touch(key)
        if sp.type == VPROXY_TYPE_PING:
            if isinstance(iface, UserIface):
                iface.send_ping(self)  # pong so the client keeps us alive
            return
        if sp.vxlan is not None:
            pkt = sp.vxlan
            if iface.local_side_vni:
                pkt = Vxlan(iface.local_side_vni, pkt.ether)
            self.stack.input_vxlan(pkt, iface)
