"""Pure-Python FD provider — the fallback backend behind the provider
seam.

Parity: the reference selects its FD backend with `-Dvfd=provided|jdk|
posix|windows` (vfd/FDProvider.java:17-36); `jdk` is the pure-JDK
fallback that works without the native library. This module is that
fallback for this framework: the same surface as the native layer
(net/vtl.py over native/vtl.cpp) built on `socket`/`select.epoll`,
selected with VPROXY_TPU_FD_PROVIDER=py or automatically when libvtl.so
cannot be built/loaded. Semantics mirror the native engine exactly —
including the bidirectional splice pump's ring/EOF/FIN-propagation
behavior and the poll loop's pump-done notification contract — so every
layer above (event loop, connections, TcpLB splice mode) runs unchanged,
only slower (bytes cross the interpreter).

The port's copy of vproxy_tpu/net/vtl_py.py, same names and behaviour.
"""
from __future__ import annotations

import errno
import os
import select
import socket
import struct
from typing import Optional

EV_READ = 1
EV_WRITE = 2
EV_ERROR = 4
EV_PUMP_DONE = 8

AGAIN = -errno.EAGAIN

# fd -> socket object for sockets created here (keeps them alive; lets
# accept/sendto/recvfrom/getsockname use the object API on the raw fd)
_socks: dict[int, socket.socket] = {}

# [bytes_spliced, write_calls, short_writes, tls_handshakes] — parity
# with the native provider's vtl_pump_counters (vtl.pump_counters());
# the py provider has no TLS pump so [3] stays 0
PUMP_COUNTERS = [0, 0, 0, 0]

_BLOCKING_IO = (BlockingIOError,)


def _reg(s: socket.socket) -> int:
    s.setblocking(False)
    fd = s.fileno()
    _socks[fd] = s
    return fd


def defer_accept_secs() -> int:
    """VPROXY_TPU_DEFER_ACCEPT (seconds, 0 = off; read per listen so
    benches/tests can toggle it at runtime): listeners only surface
    connections to accept() once the first bytes arrive, so empty
    accepts never wake the loop. Leave off for server-first protocols —
    their clients wait for a banner and would stall out the defer
    window before sending anything. The ONE parser for both providers
    (vtl.py re-exports it)."""
    try:
        return int(os.environ.get("VPROXY_TPU_DEFER_ACCEPT", "0") or "0")
    except ValueError:
        return 0


def tcp_listen(ip: str, port: int, backlog: int = 512,
               reuseport: bool = False, v6: bool = False) -> int:
    s = socket.socket(socket.AF_INET6 if v6 else socket.AF_INET,
                      socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuseport:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        secs = defer_accept_secs()
        if secs > 0 and hasattr(socket, "TCP_DEFER_ACCEPT"):
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_DEFER_ACCEPT, secs)
        s.bind((ip, port))
        s.listen(backlog)
    except OSError:
        s.close()
        raise
    return _reg(s)


def accept(lfd: int):
    s = _socks.get(lfd)
    if s is None:
        raise OSError(errno.EBADF, "not a provider socket")
    try:
        c, addr = s.accept()
    except _BLOCKING_IO:
        return None
    fd = _reg(c)
    if c.family == socket.AF_UNIX:
        return fd, "", 0
    return fd, addr[0], addr[1]


def tcp_connect(ip: str, port: int) -> int:
    s = socket.socket(socket.AF_INET6 if ":" in ip else socket.AF_INET,
                      socket.SOCK_STREAM)
    s.setblocking(False)
    try:
        s.connect((ip, port))
    except BlockingIOError:
        pass
    except OSError:
        s.close()
        raise
    return _reg(s)


def finish_connect(fd: int) -> int:
    s = _socks.get(fd)
    if s is None:
        return -errno.EBADF
    return -s.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)


def unix_listen(path: str, backlog: int = 512) -> int:
    if os.path.exists(path):
        st = os.stat(path)
        import stat as stat_m
        if not stat_m.S_ISSOCK(st.st_mode):
            raise OSError(errno.EADDRINUSE, "path exists and is not a socket")
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        probe.setblocking(False)
        try:
            probe.connect(path)
        except (ConnectionRefusedError, FileNotFoundError):
            os.unlink(path)  # dead leftover
        except OSError:
            pass
        finally:
            probe.close()
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        s.bind(path)
        s.listen(backlog)
    except OSError:
        s.close()
        raise
    return _reg(s)


def unix_connect(path: str) -> int:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.setblocking(False)
    try:
        s.connect(path)
    except BlockingIOError:
        pass
    except OSError:
        s.close()
        raise
    return _reg(s)


def udp_bind(ip: str, port: int, reuseport: bool = False) -> int:
    s = socket.socket(socket.AF_INET6 if ":" in ip else socket.AF_INET,
                      socket.SOCK_DGRAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuseport:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind((ip, port))
    except OSError:
        s.close()
        raise
    return _reg(s)


def udp_socket(v6: bool = False) -> int:
    return _reg(socket.socket(
        socket.AF_INET6 if v6 else socket.AF_INET, socket.SOCK_DGRAM))


def recvfrom(fd: int, n: int = 65536):
    s = _socks.get(fd)
    if s is None:
        raise OSError(errno.EBADF, "not a provider socket")
    try:
        data, addr = s.recvfrom(n)
    except _BLOCKING_IO:
        return None
    return data, addr[0], addr[1]


def sendto(fd: int, data: bytes, ip: str, port: int) -> int:
    s = _socks.get(fd)
    if s is None:
        raise OSError(errno.EBADF, "not a provider socket")
    try:
        return s.sendto(data, (ip, port))
    except _BLOCKING_IO:
        return AGAIN


def read(fd: int, n: int = 65536):
    try:
        return os.read(fd, n)
    except _BLOCKING_IO:
        return None


def write(fd: int, data: bytes) -> int:
    try:
        return os.write(fd, data)
    except _BLOCKING_IO:
        return AGAIN


def close(fd: int) -> None:
    s = _socks.pop(fd, None)
    if s is not None:
        s.close()
        return
    try:
        os.close(fd)
    except OSError:
        pass


def shutdown_wr(fd: int) -> None:
    s = _socks.get(fd)
    try:
        if s is not None:
            s.shutdown(socket.SHUT_WR)
        else:
            socket.socket(fileno=os.dup(fd)).shutdown(socket.SHUT_WR)
    except OSError:
        pass


def set_rcvbuf(fd: int, nbytes: int) -> None:
    import os as _os
    import socket as _s
    try:
        _s.socket(fileno=_os.dup(fd)).setsockopt(
            _s.SOL_SOCKET, _s.SO_RCVBUF, nbytes)
    except OSError:
        pass


def set_nodelay(fd: int, on: bool = True) -> None:
    s = _socks.get(fd)
    try:
        if s is not None:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1 if on else 0)
    except OSError:
        pass


def sock_name(fd: int, peer: bool = False):
    s = _socks.get(fd)
    if s is None:
        raise OSError(errno.EBADF, "not a provider socket")
    addr = s.getpeername() if peer else s.getsockname()
    if s.family == socket.AF_UNIX:
        return addr if isinstance(addr, str) else "", 0
    return addr[0], addr[1]


def check(r: int) -> int:
    if isinstance(r, int) and r < 0:
        raise OSError(-r, os.strerror(-r))
    return r


# ----------------------------------------------------------------- pump


class _Pump:
    """Mirror of the native Pump: two rings, EOF/FIN propagation,
    byte counters, dead/err state (native/vtl.cpp pump engine)."""

    __slots__ = ("id", "fd_a", "fd_b", "cap", "a2b", "b2a", "a_eof",
                 "b_eof", "a_wr_shut", "b_wr_shut", "dead", "err",
                 "bytes_a2b", "bytes_b2a")

    def __init__(self, pid: int, fd_a: int, fd_b: int, cap: int):
        self.id = pid
        self.fd_a, self.fd_b = fd_a, fd_b
        self.cap = cap
        self.a2b = bytearray()
        self.b2a = bytearray()
        self.a_eof = self.b_eof = False
        self.a_wr_shut = self.b_wr_shut = False
        self.dead = False
        self.err = 0
        self.bytes_a2b = self.bytes_b2a = 0


class _PyLoop:
    """Mirror of the native Loop: epoll + wake eventfd + handler
    registry + pump engine + deferred pump-done notifications."""

    def __init__(self):
        self.ep = select.epoll()
        self.wakefd = os.eventfd(0, os.EFD_NONBLOCK | os.EFD_CLOEXEC) \
            if hasattr(os, "eventfd") else None
        if self.wakefd is None:
            self._wr, self.wakefd = None, None
            r, w = os.pipe2(os.O_NONBLOCK | os.O_CLOEXEC)
            self.wakefd, self._wr = r, w
        else:
            self._wr = None
        # fd -> [kind, tag, interest, pump]; kind: 0 py, 1 wake, 2/3 pump
        self.handlers: dict[int, list] = {}
        self.pumps: dict[int, _Pump] = {}
        self.done_pumps: list[int] = []
        self.next_pump_id = 1
        self.handlers[self.wakefd] = [1, 0, EV_READ, None]
        self.ep.register(self.wakefd, select.EPOLLIN)

    # --- registry ---

    @staticmethod
    def _to_ep(ev: int) -> int:
        e = 0
        if ev & EV_READ:
            e |= select.EPOLLIN
        if ev & EV_WRITE:
            e |= select.EPOLLOUT
        return e

    def add(self, fd: int, events: int, tag: int) -> int:
        if fd in self.handlers:
            return -errno.EEXIST
        try:
            self.ep.register(fd, self._to_ep(events))
        except OSError as e:
            return -(e.errno or errno.EINVAL)
        self.handlers[fd] = [0, tag, events, None]
        return 0

    def mod(self, fd: int, events: int, tag: int) -> int:
        h = self.handlers.get(fd)
        if h is None:
            return -errno.ENOENT
        h[1] = tag
        try:
            self.ep.modify(fd, self._to_ep(events))
        except OSError as e:
            return -(e.errno or errno.EINVAL)
        h[2] = events
        return 0

    def delete(self, fd: int) -> int:
        if fd not in self.handlers:
            return -errno.ENOENT
        try:
            self.ep.unregister(fd)
        except OSError:
            pass
        del self.handlers[fd]
        return 0

    def wakeup(self) -> int:
        try:
            if self._wr is not None:
                os.write(self._wr, b"\x01")
            else:
                os.eventfd_write(self.wakefd, 1)
        except (BlockingIOError, OSError):
            pass
        return 0

    # --- pump engine (mirror of pump_flow/pump_run/pump_kill) ---

    def _pump_kill(self, p: _Pump, err: int) -> None:
        if p.dead:
            return
        p.dead = True
        p.err = err
        for fd in (p.fd_a, p.fd_b):
            if fd in self.handlers:
                try:
                    self.ep.unregister(fd)
                except OSError:
                    pass
                del self.handlers[fd]
            close(fd)
        self.done_pumps.append(p.id)

    def _drain(self, p: _Pump, dst: int, ring: bytearray,
               ctr_attr: str) -> bool:
        """ring -> dst until EAGAIN/empty. False = pump killed."""
        while ring:
            want = min(len(ring), 262144)
            try:
                n = os.write(dst, memoryview(ring)[:262144])
            except _BLOCKING_IO:
                PUMP_COUNTERS[1] += 1
                PUMP_COUNTERS[2] += 1
                return True
            except OSError as e:
                self._pump_kill(p, e.errno or errno.EPIPE)
                return False
            PUMP_COUNTERS[1] += 1
            if n < want:
                PUMP_COUNTERS[2] += 1
            if n <= 0:
                return True
            PUMP_COUNTERS[0] += n
            del ring[:n]
            setattr(p, ctr_attr, getattr(p, ctr_attr) + n)
        return True

    def _flow(self, p: _Pump, src: int, dst: int, ring: bytearray,
              eof_attr: str, shut_attr: str, ctr_attr: str) -> bool:
        # flush pending ring -> dst
        if not self._drain(p, dst, ring, ctr_attr):
            return False
        # refill from src (with immediate write-through)
        while not getattr(p, eof_attr) and len(ring) < p.cap:
            try:
                data = os.read(src, p.cap - len(ring))
            except _BLOCKING_IO:
                break
            except OSError as e:
                self._pump_kill(p, e.errno or errno.EIO)
                return False
            if data == b"":
                setattr(p, eof_attr, True)
                break
            ring += data
            if not self._drain(p, dst, ring, ctr_attr):
                return False
        if getattr(p, eof_attr) and not ring and not getattr(p, shut_attr):
            try:
                s = _socks.get(dst)
                if s is not None:
                    s.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            setattr(p, shut_attr, True)
        return True

    def _pump_run(self, p: _Pump) -> None:
        if p.dead:
            return
        if not self._flow(p, p.fd_a, p.fd_b, p.a2b, "a_eof", "b_wr_shut",
                          "bytes_a2b"):
            return
        if not self._flow(p, p.fd_b, p.fd_a, p.b2a, "b_eof", "a_wr_shut",
                          "bytes_b2a"):
            return
        if p.a_eof and p.b_eof and not p.a2b and not p.b2a:
            self._pump_kill(p, 0)
            return
        self._pump_interest(p)

    def _pump_interest(self, p: _Pump) -> None:
        ha = self.handlers.get(p.fd_a)
        hb = self.handlers.get(p.fd_b)
        if ha is None or hb is None:
            return
        ia = ib = 0
        if not p.a_eof and len(p.a2b) < p.cap:
            ia |= EV_READ
        if p.b2a:
            ia |= EV_WRITE
        if not p.b_eof and len(p.b2a) < p.cap:
            ib |= EV_READ
        if p.a2b:
            ib |= EV_WRITE
        for fd, h, want in ((p.fd_a, ha, ia), (p.fd_b, hb, ib)):
            if h[2] != want:
                try:
                    self.ep.modify(fd, self._to_ep(want))
                    h[2] = want
                except OSError:
                    pass

    def pump_new(self, fd_a: int, fd_b: int, bufsize: int) -> int:
        if fd_a in self.handlers or fd_b in self.handlers:
            return 0
        # parity with the native pump: NODELAY is the pump's job now
        # (tcplb._handover no longer sets it) — best-effort, non-TCP
        # fds (unix pairs) just don't have the option
        for fd in (fd_a, fd_b):
            s = _socks.get(fd)
            if s is not None:
                try:
                    s.setsockopt(socket.IPPROTO_TCP,
                                 socket.TCP_NODELAY, 1)
                except OSError:
                    pass
        pid = self.next_pump_id
        self.next_pump_id += 1
        p = _Pump(pid, fd_a, fd_b, bufsize)
        try:
            self.ep.register(fd_a, select.EPOLLIN)
            self.ep.register(fd_b, select.EPOLLIN)
        except OSError:
            try:
                self.ep.unregister(fd_a)
            except OSError:
                pass
            return 0
        self.handlers[fd_a] = [2, pid, EV_READ, p]
        self.handlers[fd_b] = [3, pid, EV_READ, p]
        self.pumps[pid] = p
        self._pump_run(p)  # kick: buffered bytes may be ready
        return pid

    # --- poll ---

    def poll(self, tags_buf, evs_buf, cap: int, timeout_ms: int) -> int:
        out = 0

        def flush_done():
            nonlocal out
            while self.done_pumps and out < cap:
                tags_buf[out] = self.done_pumps.pop()
                evs_buf[out] = EV_PUMP_DONE
                out += 1

        flush_done()
        if out:
            return out
        try:
            events = self.ep.poll(-1 if timeout_ms < 0 else timeout_ms / 1000.0,
                                  min(cap, 256))
        except InterruptedError:
            return 0
        except OSError as e:
            return -(e.errno or errno.EIO)
        for fd, e in events:
            h = self.handlers.get(fd)
            if h is None:  # torn down earlier in this batch
                continue
            kind = h[0]
            if kind == 1:  # wake
                try:
                    while os.read(self.wakefd, 8):
                        pass
                except (BlockingIOError, OSError):
                    pass
            elif kind == 0:  # py handler
                ve = 0
                if e & (select.EPOLLIN | select.EPOLLHUP):
                    ve |= EV_READ
                if e & select.EPOLLOUT:
                    ve |= EV_WRITE
                if e & select.EPOLLERR:
                    ve |= EV_ERROR
                if ve and out < cap:
                    tags_buf[out] = h[1]
                    evs_buf[out] = ve
                    out += 1
            else:  # pump side
                p = h[3]
                if e & select.EPOLLERR:
                    err = 0
                    s = _socks.get(fd)
                    if s is not None:
                        err = s.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
                    self._pump_kill(p, err or errno.EIO)
                else:
                    self._pump_run(p)
        flush_done()
        return out

    def free(self) -> None:
        for p in self.pumps.values():
            if not p.dead:
                close(p.fd_a)
                close(p.fd_b)
        self.pumps.clear()
        try:
            self.ep.close()
        except OSError:
            pass
        for fd in (self.wakefd, self._wr):
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass


class PyLib:
    """Method-for-method stand-in for the ctypes CDLL handle: the event
    loop calls LIB.vtl_* without knowing which provider is behind it."""

    def vtl_new(self):
        return _PyLoop()

    def vtl_free(self, lp) -> None:
        lp.free()

    def vtl_wakeup(self, lp) -> int:
        return lp.wakeup()

    def vtl_add(self, lp, fd, events, tag) -> int:
        return lp.add(fd, events, tag)

    def vtl_mod(self, lp, fd, events, tag) -> int:
        return lp.mod(fd, events, tag)

    def vtl_del(self, lp, fd) -> int:
        return lp.delete(fd)

    def vtl_poll(self, lp, tags_buf, evs_buf, cap, timeout_ms) -> int:
        return lp.poll(tags_buf, evs_buf, cap, timeout_ms)

    def vtl_pump_new(self, lp, fd_a, fd_b, bufsize) -> int:
        return lp.pump_new(fd_a, fd_b, bufsize)

    def vtl_pump_stat(self, lp, pid, out) -> int:
        p = lp.pumps.get(pid)
        if p is None:
            return -errno.ENOENT
        out[0], out[1], out[2] = p.bytes_a2b, p.bytes_b2a, p.err
        return 0

    def vtl_pump_close(self, lp, pid) -> int:
        p = lp.pumps.get(pid)
        if p is None:
            return -errno.ENOENT
        lp._pump_kill(p, 0)
        return 0

    def vtl_pump_free(self, lp, pid) -> int:
        p = lp.pumps.pop(pid, None)
        if p is None:
            return -errno.ENOENT
        if not p.dead:
            lp._pump_kill(p, 0)
            lp.pumps.pop(pid, None)
        return 0


LIB = PyLib()

EXPORTS = ("LIB", "tcp_listen", "accept", "tcp_connect", "finish_connect",
           "unix_listen", "unix_connect", "udp_bind", "udp_socket",
           "recvfrom", "sendto", "read", "write", "close", "shutdown_wr",
           "set_nodelay", "sock_name", "check")
