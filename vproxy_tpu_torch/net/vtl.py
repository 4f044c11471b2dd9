"""The FD provider seam: native host runtime by default, pure-Python
fallback behind the same surface.

The port's copy of vproxy_tpu/net/vtl.py, with its own build. Parity:
the reference's `-Dvfd=provided|jdk|posix` backend selection
(vfd/FDProvider.java:17-36). Here VPROXY_TPU_FD_PROVIDER picks:

* "native" (default) — ctypes binding for native/vtl.cpp, this
  package's copy of the C++ runtime. `build_library()` compiles it with
  g++ at first import (the reference Makefile's flags) into `_build/`
  beside the package, which .gitignore lists: keyed by the source's
  content, under a lock file (concurrent processes build it once),
  written to a temporary name and renamed into place. `SOURCE` is the
  file it builds from, `LIB_PATH` the library it loaded.
* "py" — net/vtl_py.py, stdlib sockets + select.epoll with a Python
  splice pump; also the automatic fallback when the native library
  cannot be built or loaded (no toolchain), like the reference falling
  back to the JDK backend where the JNI library is absent.

VPROXY_TPU_VTL_SO loads an explicit library instead (a sanitizer or
side-by-side build), as-is and loudly.

All fd-returning calls raise OSError on negative return; I/O calls
return -EAGAIN as the sentinel AGAIN instead of raising (hot path).
"""
from __future__ import annotations

import ctypes
import errno
import fcntl
import hashlib
import os
import struct
import subprocess
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "vtl.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
LIB_PATH: Optional[str] = None  # the loaded library (None: py provider)

EV_READ = 1
EV_WRITE = 2
EV_ERROR = 4
EV_PUMP_DONE = 8

AGAIN = -errno.EAGAIN


def build_library(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Compile `source` once; -> `<build_dir>/libvtl_<content hash>.so`.
    The hash covers the source, the compiler and its flags, so an edited
    source builds a new library and an unchanged one is reused. One
    process builds under the lock file while the others wait; the
    compiler writes a temporary name that is renamed into place, so no
    process ever loads a half-written library. Raises OSError when the
    compiler is missing or fails."""
    cxx = os.environ.get("CXX", "g++")
    with open(source, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(
        src + " ".join((cxx, *CXX_FLAGS)).encode()).hexdigest()[:16]
    lib = os.path.join(build_dir, f"libvtl_{tag}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".libvtl.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(lib):
            return lib
        tmp = f"{lib}.{os.getpid()}.tmp"
        try:
            r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, source],
                               capture_output=True, text=True)
        except OSError as e:
            raise OSError(e.errno, f"libvtl: cannot run {cxx}: {e}") from e
        if r.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise OSError(errno.EIO, f"libvtl: {cxx} failed "
                          f"({r.returncode}): {r.stderr[-2000:]}")
        os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    # VPROXY_TPU_VTL_SO points at an explicit build artifact — a
    # sanitizer build loaded under LD_PRELOAD of its runtime, or any
    # side-by-side A/B build. An explicit path is loaded as-is: no
    # rebuild, and failures are loud.
    global LIB_PATH
    path = os.environ.get("VPROXY_TPU_VTL_SO", "") or build_library()
    lib = ctypes.CDLL(path)
    LIB_PATH = path
    c = ctypes.c_int
    p = ctypes.c_void_p
    u64 = ctypes.c_uint64
    lib.vtl_new.restype = p
    lib.vtl_free.argtypes = [p]
    lib.vtl_wakeup.argtypes = [p]
    lib.vtl_add.argtypes = [p, c, ctypes.c_uint32, u64]
    lib.vtl_mod.argtypes = [p, c, ctypes.c_uint32, u64]
    lib.vtl_del.argtypes = [p, c]
    lib.vtl_poll.argtypes = [p, ctypes.POINTER(u64), ctypes.POINTER(ctypes.c_uint32), c, c]
    lib.vtl_tcp_listen.argtypes = [ctypes.c_char_p, c, c, c, c]
    lib.vtl_accept.argtypes = [c, ctypes.c_char_p, c, ctypes.POINTER(c)]
    lib.vtl_tcp_connect.argtypes = [ctypes.c_char_p, c, c]
    lib.vtl_unix_listen.argtypes = [ctypes.c_char_p, c]
    lib.vtl_unix_connect.argtypes = [ctypes.c_char_p]
    lib.vtl_finish_connect.argtypes = [c]
    lib.vtl_udp_bind.argtypes = [ctypes.c_char_p, c, c, c]
    lib.vtl_udp_socket.argtypes = [c]
    lib.vtl_recvfrom.argtypes = [c, p, c, ctypes.c_char_p, c, ctypes.POINTER(c)]
    lib.vtl_sendto.argtypes = [c, p, c, ctypes.c_char_p, c, c]
    lib.vtl_read.argtypes = [c, p, c]
    lib.vtl_write.argtypes = [c, p, c]
    lib.vtl_close.argtypes = [c]
    lib.vtl_shutdown_wr.argtypes = [c]
    lib.vtl_set_nodelay.argtypes = [c, c]
    lib.vtl_set_rcvbuf.argtypes = [c, c]
    try:  # absent from a prebuilt pre-defer-accept .so: knob is a no-op
        lib.vtl_set_defer_accept.argtypes = [c, c]
    except AttributeError:
        pass
    lib.vtl_sock_name.argtypes = [c, c, ctypes.c_char_p, c, ctypes.POINTER(c)]
    lib.vtl_pump_new.argtypes = [p, c, c, c]
    lib.vtl_pump_new.restype = u64
    lib.vtl_pump_stat.argtypes = [p, u64, ctypes.POINTER(u64)]
    lib.vtl_pump_close.argtypes = [p, u64]
    lib.vtl_pump_free.argtypes = [p, u64]
    try:  # accept fast lane (absent from an older prebuilt .so)
        lib.vtl_pump_connect.argtypes = [p, c, ctypes.c_char_p, c, c, c]
        lib.vtl_pump_connect.restype = u64
        lib.vtl_pump_abort_connect.argtypes = [p, u64]
        lib.vtl_pump_stat2.argtypes = [p, u64, ctypes.POINTER(u64)]
    except AttributeError:
        pass
    try:  # absent from a prebuilt pre-counters .so: pump_counters()
        lib.vtl_pump_counters.argtypes = [ctypes.POINTER(u64)]
    except AttributeError:  # then reports zeros, everything else works
        pass
    i64 = ctypes.c_longlong
    lib.vtl_tls_init.argtypes = []
    lib.vtl_tls_ctx_new.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.vtl_tls_ctx_new.restype = i64
    lib.vtl_tls_ctx_free.argtypes = [i64]
    lib.vtl_tls_pump_new.argtypes = [p, c, c, c, i64]
    lib.vtl_tls_pump_new.restype = u64
    lib.vtl_recv_peek.argtypes = [c, ctypes.c_void_p, c]
    lib.vtl_recvmmsg.argtypes = [c, ctypes.c_void_p, c, c,
                                 ctypes.POINTER(c), ctypes.c_char_p, c,
                                 ctypes.POINTER(c)]
    lib.vtl_sendmmsg.argtypes = [c, ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.POINTER(c), c, ctypes.c_char_p,
                                 c, c]
    try:  # accept lanes (absent from an older prebuilt .so)
        lib.vtl_lanes_new.argtypes = [ctypes.c_char_p, c, c, c, c, c, c,
                                      c, c]
        lib.vtl_lanes_new.restype = p
        lib.vtl_lanes_free.argtypes = [p]
        lib.vtl_lanes_close_listeners.argtypes = [p]
        lib.vtl_lanes_shutdown.argtypes = [p, c]
        lib.vtl_lanes_port.argtypes = [p]
        lib.vtl_lanes_engine.argtypes = [p]
        lib.vtl_lanes_errno.argtypes = []
        lib.vtl_lanes_active.argtypes = [p]
        lib.vtl_lanes_active.restype = ctypes.c_longlong
        lib.vtl_lanes_set_punt_all.argtypes = [p, c]
        lib.vtl_lanes_set_limit.argtypes = [p, ctypes.c_longlong]
        lib.vtl_lanes_set_timeout.argtypes = [p, c]
        lib.vtl_lanes_stat.argtypes = [p, ctypes.POINTER(u64)]
        lib.vtl_lane_counters.argtypes = [ctypes.POINTER(u64)]
        lib.vtl_lane_gen.argtypes = [p]
        lib.vtl_lane_gen.restype = u64
        lib.vtl_lane_gen_bump.argtypes = [p]
        lib.vtl_lane_install.argtypes = [p, ctypes.c_char_p, c,
                                         ctypes.POINTER(ctypes.c_int32), c,
                                         u64]
        lib.vtl_lane_poll.argtypes = [p, c, ctypes.c_void_p, c, c]
        lib.vtl_lane_rec_size.argtypes = []
        lib.vtl_lane_punt_size.argtypes = []
        lib.vtl_uring_probe.argtypes = []
    except AttributeError:
        pass
    try:  # adaptive-overload lane shed (absent from an older prebuilt .so)
        lib.vtl_lanes_set_shed.argtypes = [p, c]
        lib.vtl_close_rst.argtypes = [c]
    except AttributeError:
        pass
    try:  # maglev consistent-hash pick (absent from an older prebuilt .so)
        lib.vtl_maglev_rec_size.argtypes = []
        lib.vtl_maglev_pick.argtypes = [ctypes.POINTER(ctypes.c_int32), c,
                                        ctypes.c_char_p, c, c, c]
        lib.vtl_lane_maglev_install.argtypes = [
            p, ctypes.c_char_p, c, ctypes.POINTER(ctypes.c_int32), c, c,
            u64]
        lib.vtl_flow_maglev_install.argtypes = [
            p, ctypes.POINTER(ctypes.c_int32), c, u64]
        lib.vtl_flow_maglev_pick.argtypes = [p, ctypes.c_char_p, c, c, c]
    except AttributeError:
        pass
    try:  # span tracing + lane stage histograms (absent from an older prebuilt .so)
        lib.vtl_trace_rec_size.argtypes = []
        lib.vtl_trace_set_sample.argtypes = [u64]
        lib.vtl_trace_set_ring_cap.argtypes = [c]
        lib.vtl_trace_drain.argtypes = [p, c, ctypes.c_void_p, c]
        lib.vtl_trace_counters.argtypes = [ctypes.POINTER(u64)]
        lib.vtl_lanes_stage_stat.argtypes = [p, c, ctypes.POINTER(u64)]
    except AttributeError:
        pass
    try:  # traffic-analytics HH shards (absent from an older prebuilt .so)
        lib.vtl_hh_rec_size.argtypes = []
        lib.vtl_hh_set_enabled.argtypes = [c]
        lib.vtl_hh_hash.argtypes = [ctypes.c_char_p, c]
        lib.vtl_hh_hash.restype = u64
        lib.vtl_hh_counters.argtypes = [ctypes.POINTER(u64)]
        lib.vtl_hh_drain.argtypes = [p, c, ctypes.c_void_p, c]
        lib.vtl_hh_flow_drain.argtypes = [p, ctypes.c_void_p, c]
    except AttributeError:
        pass
    try:  # workload-capture histograms + knob (absent from an older prebuilt .so)
        lib.vtl_workload_set_enabled.argtypes = [c]
        lib.vtl_lanes_capture_stat.argtypes = [p, c, ctypes.POINTER(u64)]
    except AttributeError:
        pass
    try:  # policing probe + knob (absent from an older prebuilt .so)
        lib.vtl_police_rec_size.argtypes = []
        lib.vtl_police_set_enabled.argtypes = [c]
        lib.vtl_police_install.argtypes = [p, ctypes.c_char_p, c, u64]
        lib.vtl_police_counters.argtypes = [p, ctypes.POINTER(u64)]
        lib.vtl_police_check.argtypes = [p, ctypes.c_char_p, c, u64]
    except AttributeError:
        pass
    try:  # switch flow cache (absent from an older prebuilt .so)
        lib.vtl_flowcache_new.argtypes = [c, c]
        lib.vtl_flowcache_new.restype = p
        lib.vtl_flowcache_free.argtypes = [p]
        lib.vtl_switch_gen_bump.argtypes = [p]
        lib.vtl_switch_gen.argtypes = [p]
        lib.vtl_switch_gen.restype = u64
        lib.vtl_switch_poll.argtypes = [p, c, ctypes.c_void_p, c, c,
                                        ctypes.POINTER(c), ctypes.c_char_p,
                                        c, ctypes.POINTER(c),
                                        ctypes.POINTER(c)]
        lib.vtl_flow_install.argtypes = [p, ctypes.c_char_p, c, u64]
        lib.vtl_flowcache_counters.argtypes = [ctypes.POINTER(u64)]
        lib.vtl_flowcache_stat.argtypes = [p, ctypes.POINTER(u64)]
        lib.vtl_flow_rec_size.argtypes = []
        lib.vtl_wait_readable.argtypes = [c, c]
    except AttributeError:
        pass
    return lib


PROVIDER = os.environ.get("VPROXY_TPU_FD_PROVIDER", "")
if PROVIDER not in ("", "native", "py"):
    raise ValueError(f"VPROXY_TPU_FD_PROVIDER={PROVIDER!r}: "
                     "expected 'native' or 'py'")
if PROVIDER == "py":
    LIB = None
elif PROVIDER == "native":
    LIB = _load()  # explicitly requested: build/load errors fail LOUDLY
    PROVIDER = "native"
else:  # unset: native with automatic pure-python fallback
    try:
        LIB = _load()
        PROVIDER = "native"
    except Exception as _native_err:  # no toolchain / bad .so
        import sys as _sys
        print(f"# vtl: native provider unavailable ({_native_err!r}); "
              "falling back to the pure-python provider", file=_sys.stderr)
        LIB = None


def check(r: int) -> int:
    if r < 0:
        raise OSError(-r, os.strerror(-r))
    return r


# the one parser for the defer-accept knob, shared with the py provider
from .vtl_py import defer_accept_secs  # noqa: E402


def tcp_listen(ip: str, port: int, backlog: int = 512, reuseport: bool = False,
               v6: bool = False) -> int:
    fd = check(LIB.vtl_tcp_listen(ip.encode(), port, backlog,
                                  1 if reuseport else 0, 1 if v6 else 0))
    secs = defer_accept_secs()
    if secs > 0:
        try:
            LIB.vtl_set_defer_accept(fd, secs)  # best-effort
        except AttributeError:
            pass  # prebuilt .so without the symbol
    return fd


def accept(lfd: int):
    """-> (fd, ip, port) or None on EAGAIN."""
    buf = ctypes.create_string_buffer(64)
    port = ctypes.c_int(0)
    fd = LIB.vtl_accept(lfd, buf, 64, ctypes.byref(port))
    if fd == AGAIN:
        return None
    check(fd)
    return fd, buf.value.decode(), port.value


def tcp_connect(ip: str, port: int) -> int:
    return check(LIB.vtl_tcp_connect(ip.encode(), port, 1 if ":" in ip else 0))


def finish_connect(fd: int) -> int:
    return LIB.vtl_finish_connect(fd)  # 0 ok else -errno


def unix_listen(path: str, backlog: int = 512) -> int:
    """Unix-domain stream listener (UDSPath analog); clears stale
    socket files nothing is accepting on."""
    return check(LIB.vtl_unix_listen(path.encode(), backlog))


def unix_connect(path: str) -> int:
    return check(LIB.vtl_unix_connect(path.encode()))


def udp_bind(ip: str, port: int, reuseport: bool = False) -> int:
    return check(LIB.vtl_udp_bind(ip.encode(), port, 1 if ":" in ip else 0,
                                  1 if reuseport else 0))


def udp_socket(v6: bool = False) -> int:
    return check(LIB.vtl_udp_socket(1 if v6 else 0))


def recvfrom(fd: int, n: int = 65536):
    """-> (data, ip, port) or None on EAGAIN."""
    buf = ctypes.create_string_buffer(n)
    ipb = ctypes.create_string_buffer(64)
    port = ctypes.c_int(0)
    r = LIB.vtl_recvfrom(fd, buf, n, ipb, 64, ctypes.byref(port))
    if r == AGAIN:
        return None
    check(r)
    return buf.raw[:r], ipb.value.decode(), port.value


def sendto(fd: int, data: bytes, ip: str, port: int) -> int:
    r = LIB.vtl_sendto(fd, data, len(data), ip.encode(), port,
                       1 if ":" in ip else 0)
    return r if r == AGAIN else check(r)


def read(fd: int, n: int = 65536):
    """-> bytes (b'' on EOF) or None on EAGAIN."""
    buf = ctypes.create_string_buffer(n)
    r = LIB.vtl_read(fd, buf, n)
    if r == AGAIN:
        return None
    check(r)
    return buf.raw[:r]


def write(fd: int, data: bytes) -> int:
    """-> bytes written, or AGAIN (<0)."""
    r = LIB.vtl_write(fd, data, len(data))
    return r if r == AGAIN else check(r)


def close(fd: int) -> None:
    LIB.vtl_close(fd)


def shutdown_wr(fd: int) -> None:
    LIB.vtl_shutdown_wr(fd)


# SO_LINGER {on=1, linger=0} — precomputed: close_rst runs once per
# refused connection during a flash crowd, exactly the path whose whole
# point is being cheap
import socket as _socket  # noqa: E402

_LINGER0 = struct.pack("ii", 1, 0)


def set_linger0(fd: int) -> None:
    """Arm SO_LINGER {on, 0} WITHOUT closing: the next close — whoever
    owns it (a Connection, the pump teardown) — sends an RST instead of
    a FIN. Half-open-flood kills use this so slowloris sessions leave
    no TIME_WAIT behind."""
    try:
        s = _socket.socket(fileno=fd)
    except OSError:
        return
    try:
        s.setsockopt(_socket.SOL_SOCKET, _socket.SO_LINGER, _LINGER0)
    except OSError:
        pass
    finally:
        s.detach()  # fd ownership stays with the caller


def close_rst(fd: int) -> None:
    """Close with an RST (SO_LINGER {on, 0}) instead of a FIN: overload
    sheds must not park one TIME_WAIT per refused connection — a flash
    crowd would exhaust the table long before it exhausts the proxy.
    One C call when the .so has it (the shed path runs once per refused
    connection — no python socket-object round trip); the pure-python
    fallback degrades to a plain close when the fd isn't a socket
    (set_linger0's no-op path)."""
    fn = getattr(LIB, "vtl_close_rst", None)
    if fn is not None:
        fn(fd)
        return
    set_linger0(fd)
    close(fd)


def set_rcvbuf(fd: int, nbytes: int) -> None:
    """Best-effort receive-buffer sizing (bursty UDP ingress)."""
    LIB.vtl_set_rcvbuf(fd, nbytes)


def set_nodelay(fd: int, on: bool = True) -> None:
    LIB.vtl_set_nodelay(fd, 1 if on else 0)


def sock_name(fd: int, peer: bool = False):
    buf = ctypes.create_string_buffer(64)
    port = ctypes.c_int(0)
    check(LIB.vtl_sock_name(fd, 1 if peer else 0, buf, 64, ctypes.byref(port)))
    return buf.value.decode(), port.value


# ----------------------------------------------------- provider fallback

if LIB is None:
    from . import vtl_py as _py
    PROVIDER = "py"
    LIB = _py.LIB
    for _n in _py.EXPORTS:
        if _n != "LIB":
            globals()[_n] = getattr(_py, _n)


# ---------------------------------------------------- pump capabilities

_pump_nodelay_cached: bool = None  # type: ignore[assignment]


def pump_sets_nodelay() -> bool:
    """True when the pump setup applies TCP_NODELAY itself (a native
    .so with the fast lane, via pump_set_nodelay, and the py provider's
    pump_new). An older prebuilt .so does neither — callers must keep setting it
    explicitly or every spliced session runs with Nagle enabled."""
    global _pump_nodelay_cached
    if _pump_nodelay_cached is None:
        if PROVIDER == "py":
            _pump_nodelay_cached = True
        else:
            _pump_nodelay_cached = hasattr(LIB, "vtl_pump_connect")
    return _pump_nodelay_cached


# -------------------------------------------------------- pump counters

def pump_counters() -> tuple:
    """Process-global splice-pump counters: (bytes_spliced, write_calls,
    short_writes, tls_handshakes). Native provider reads the C atomics
    (vtl_pump_counters); the py provider keeps its own tallies; an old
    .so without the symbol reports zeros."""
    if PROVIDER == "py":
        from . import vtl_py as _p
        return tuple(_p.PUMP_COUNTERS)
    try:
        fn = LIB.vtl_pump_counters
    except AttributeError:
        return (0, 0, 0, 0)
    out = (ctypes.c_uint64 * 4)()
    fn(out)
    return tuple(int(x) for x in out)


# --------------------------------------------------------------- fdtrace

_TRACED_FNS = ("tcp_listen", "accept", "tcp_connect", "finish_connect",
               "unix_listen", "unix_connect", "udp_bind", "udp_socket",
               "recvfrom", "sendto", "read", "write", "close",
               "shutdown_wr", "set_nodelay", "sock_name")
_trace_installed = False


def _trace_fmt(v) -> str:
    if isinstance(v, (bytes, bytearray)):
        return f"<{len(v)}B>"
    if isinstance(v, tuple):
        return "(" + ",".join(_trace_fmt(x) for x in v) + ")"
    return repr(v)


def enable_fdtrace() -> None:
    """Log every syscall-layer call with args and result — the
    reference's `-Dvfdtrace=1` dynamic FD proxy
    (vfd/TraceInvocationHandler.java, VFDConfig.java:21). Enabled at
    import via VPROXY_TPU_FDTRACE=1 or programmatically; idempotent.
    The C-internal splice pump and epoll loop are not traced (like the
    reference, which wraps FDs, not libae internals)."""
    global _trace_installed
    if _trace_installed:
        return
    _trace_installed = True
    import functools

    from ..utils.log import Logger
    log = Logger("fdtrace")
    g = globals()
    for name in _TRACED_FNS:
        fn = g[name]

        @functools.wraps(fn)
        def traced(*a, __fn=fn, __name=name, **kw):
            args = ",".join(_trace_fmt(x) for x in a)
            try:
                r = __fn(*a, **kw)
            except OSError as e:
                log.info(f"{__name}({args}) !> {e!r}")
                raise
            log.info(f"{__name}({args}) -> {_trace_fmt(r)}")
            return r

        g[name] = traced


if os.environ.get("VPROXY_TPU_FDTRACE", "") == "1":
    enable_fdtrace()


# ----------------------------------------------------------- native TLS
#
# OpenSSL (libssl.so.3, dlopen'd by the native layer) terminating TLS
# INSIDE the splice pump: the reference runs SSLEngine wrap/unwrap at
# engine speed (SSLWrapRingBuffer.java:23 / SSLUnwrapRingBuffer.java:28);
# here the handshake + record layer run in C against the client fd while
# plaintext rides the same pump rings — TLS bytes never enter Python.

def tls_available() -> bool:
    """Native TLS pump usable? (native provider + libssl resolvable)."""
    if LIB is None:
        return False
    return LIB.vtl_tls_init() == 0


def tls_ctx_new(cert_path: str, key_path: str) -> int:
    """-> native SSL_CTX handle; raises on bad cert/key."""
    h = LIB.vtl_tls_ctx_new(cert_path.encode(), key_path.encode())
    if h < 0:
        raise OSError(-h, f"tls ctx: {os.strerror(int(-h))}")
    return int(h)


def tls_ctx_free(handle: int) -> None:
    if LIB is not None and handle:
        LIB.vtl_tls_ctx_free(handle)


def recv_peek(fd: int, maxlen: int = 16384):
    """MSG_PEEK read (bytes stay queued); None on EAGAIN."""
    buf = ctypes.create_string_buffer(maxlen)
    n = LIB.vtl_recv_peek(fd, buf, maxlen)
    if n == AGAIN:
        return None
    check(n)
    return buf.raw[:n]


# -------------------------------------------------------- batched UDP
#
# One syscall + one ctypes crossing per BURST instead of per datagram:
# the switch's ingress drain and the fast path's per-iface egress
# groups are syscall-bound once the per-packet work is vectorized.

_MMSG_SLOT = 65536  # any legal UDP datagram fits whole (no truncation)
_MMSG_MAX = 64
_mmsg_tls = None  # lazy threading.local: every receiver thread gets
                  # its own buffers (the ctypes call releases the GIL,
                  # so a shared buffer would tear between threads)


def recvmmsg(fd: int):
    """-> [(data, ip, port), ...] (possibly empty on EAGAIN)."""
    global _mmsg_tls
    if _mmsg_tls is None:
        import threading
        _mmsg_tls = threading.local()
    b = getattr(_mmsg_tls, "bufs", None)
    if b is None:
        b = _mmsg_tls.bufs = (
            ctypes.create_string_buffer(_MMSG_SLOT * _MMSG_MAX),
            (ctypes.c_int * _MMSG_MAX)(),
            ctypes.create_string_buffer(64 * _MMSG_MAX),
            (ctypes.c_int * _MMSG_MAX)())
    buf, lens, ips, ports = b
    n = LIB.vtl_recvmmsg(fd, buf, _MMSG_SLOT, _MMSG_MAX, lens, ips, 64,
                         ports)
    if n <= 0:
        check(n)
        return []
    base = ctypes.addressof(buf)
    out = []
    for i in range(n):
        # string_at copies only the received bytes (buf.raw would
        # copy the whole slot*max buffer per call)
        ip = ips[64 * i: 64 * (i + 1)].split(b"\0", 1)[0].decode()
        out.append((ctypes.string_at(base + i * _MMSG_SLOT, lens[i]),
                    ip, ports[i]))
    return out


# ------------------------------------------------------ switch flow cache
#
# The switch's native fast lane (native/vtl.cpp "switch flow cache"):
# an in-C exact-match flow table consulted by vtl_switch_poll before any
# byte reaches Python. The numpy fast path (vswitch/fastpath.py) acts as
# the flow-entry COMPILER: after classifying a miss burst it installs
# the resolved actions through flow_install, packed as FLOW_REC records
# (layout mirrored by the C FlowRec; vtl_flow_rec_size guards ABI
# drift). Correctness rides the generation gate: every mutation calls
# switch_gen_bump and a stale-generation probe is a forced miss.

# sender_ip u32, sender_port u16, vni 3s, eth_dst 6s, eth_type 2s,
# ip_src 4s, ip_dst 4s, proto B | action B, flags B, drop_reason B,
# new_vni 3s, new_dst 6s, new_src 6s, out_ip u32, out_port u16, tap_fd i
FLOW_REC = struct.Struct("<IH3s6s2s4s4sBBBB3s6s6sIHi")
# field-name contract with the C FlowRec (FlowKey flattened), checked
# name/offset/size/type field-by-field by tools/vlint's ABI pass — the
# total-size guard alone lets two compensating field errors through
FLOW_REC_FIELDS = ("sender_ip", "sender_port", "vni", "eth_dst",
                   "eth_type", "ip_src", "ip_dst", "proto", "action",
                   "flags", "drop_reason", "new_vni", "new_dst",
                   "new_src", "out_ip", "out_port", "tap_fd")
# index contract with the C g_fc_drop table
FLOW_DROP_REASONS = ("acl_deny", "same_iface", "route_miss",
                     "unknown_vni", "egress_short_write", "other")

_fc_supported: bool = None  # type: ignore[assignment]


def flowcache_supported() -> bool:
    """Native provider with the flow-cache symbols AND a matching
    install-record ABI (a stale committed .so fails the size check and
    the switch silently stays on the Python path)."""
    global _fc_supported
    if _fc_supported is None:
        ok = PROVIDER == "native" and hasattr(LIB, "vtl_flowcache_new")
        if ok:
            try:
                ok = int(LIB.vtl_flow_rec_size()) == FLOW_REC.size
            except Exception:
                ok = False
        _fc_supported = ok
    return _fc_supported


def flowcache_new(size: int, ttl_ms: int) -> int:
    """-> flow table handle (size rounded up to a power of two)."""
    return LIB.vtl_flowcache_new(size, ttl_ms)


def flowcache_free(handle: int) -> None:
    if handle:
        LIB.vtl_flowcache_free(handle)


def switch_gen_bump(handle: int) -> None:
    """One C atomic — safe from any thread, called on every mutation."""
    LIB.vtl_switch_gen_bump(handle)


def switch_gen(handle: int) -> int:
    return int(LIB.vtl_switch_gen(handle))


def flow_install(handle: int, packed: bytes, n: int, gen: int) -> int:
    """Install n FLOW_REC records stamped with `gen` (read before the
    classification that compiled them); -> entries installed (0 when a
    mutation landed in between — conservative skip)."""
    return LIB.vtl_flow_install(handle, packed, n, gen)


def flowcache_counters() -> tuple:
    """(hit, miss, evict, stale, fwd, drop[6 reasons]) — process-global
    C atomics; zeros when the provider/.so lacks the cache."""
    if not flowcache_supported():
        return (0,) * (5 + len(FLOW_DROP_REASONS))
    out = (ctypes.c_uint64 * (5 + len(FLOW_DROP_REASONS)))()
    LIB.vtl_flowcache_counters(out)
    return tuple(int(x) for x in out)


def flowcache_stat(handle: int) -> tuple:
    """-> (capacity, used_slots, generation, hits, misses) for ONE
    table (the counters() tallies blend every switch in the process)."""
    out = (ctypes.c_uint64 * 5)()
    n = LIB.vtl_flowcache_stat(handle, out)
    return tuple(int(out[i]) for i in range(n))


def wait_readable(fd: int, timeout_ms: int) -> int:
    """Blocking readable-park for poller threads (GIL released in C):
    1 readable, 0 timeout; raises on a dead fd."""
    return check(LIB.vtl_wait_readable(fd, timeout_ms))


def switch_poll(handle: int, fd: int):
    """Run the native forwarding loop over the switch's UDP socket.
    -> (handled_in_c, misses) where misses is a [(data, ip, port)] burst
    in recvmmsg's shape and handled_in_c counts datagrams fully consumed
    in C (forwarded or reason-counted drops)."""
    global _mmsg_tls
    if _mmsg_tls is None:
        import threading
        _mmsg_tls = threading.local()
    b = getattr(_mmsg_tls, "bufs", None)
    if b is None:
        b = _mmsg_tls.bufs = (
            ctypes.create_string_buffer(_MMSG_SLOT * _MMSG_MAX),
            (ctypes.c_int * _MMSG_MAX)(),
            ctypes.create_string_buffer(64 * _MMSG_MAX),
            (ctypes.c_int * _MMSG_MAX)())
    buf, lens, ips, ports = b
    drained = ctypes.c_int(0)
    n = LIB.vtl_switch_poll(handle, fd, buf, _MMSG_SLOT, _MMSG_MAX, lens,
                            ips, 64, ports, ctypes.byref(drained))
    if n < 0:
        check(n)
    base = ctypes.addressof(buf)
    out = []
    for i in range(n):
        ip = ips[64 * i: 64 * (i + 1)].split(b"\0", 1)[0].decode()
        out.append((ctypes.string_at(base + i * _MMSG_SLOT, lens[i]),
                    ip, ports[i]))
    return drained.value - n, out


# --------------------------------------------------------- accept lanes
#
# The C accept plane (native/vtl.cpp "accept lanes"): N lane threads own
# SO_REUSEPORT listeners and run the whole short-connection lifetime —
# accept4 batch, route lookup against the C-resident lane entry, backend
# connect, splice, close — without crossing ctypes. Python is the
# lane-entry COMPILER (components/lanes.py): it installs the resolved
# backend set + WRR sequence stamped with the generation read before
# compilation, and every mutation bumps one C atomic so a stale entry is
# a forced punt. vtl_lane_poll is the lane thread's park (GIL released);
# it returns punt records for the connections Python must serve.

# ip 46s, port u16, v6 u8, weight u8 — must match the C LaneRec
LANE_REC = struct.Struct("<46sHBB")
LANE_REC_FIELDS = ("ip", "port", "v6", "weight")  # vlint ABI contract
# same layout, separate ABI guard — must match the C MaglevRec
MAGLEV_REC = struct.Struct("<46sHBB")
MAGLEV_REC_FIELDS = ("ip", "port", "v6", "weight")
# fd i32, kind i32, err i32, cport u16, bport u16, cip 46s, bip 46s,
# trace_id u64 (0 = unsampled; else python continues the C-side trace)
LANE_PUNT = struct.Struct("<iiiHH46s46sQ")
LANE_PUNT_FIELDS = ("fd", "kind", "err", "cport", "bport", "cip",
                    "bip", "trace_id")
LANE_PUNT_CLASSIC = 0
LANE_PUNT_CONNECT_FAIL = 1
ESHUTDOWN = -errno.ESHUTDOWN

_lanes_supported: bool = None  # type: ignore[assignment]


def lanes_supported() -> bool:
    """Native provider with the lane symbols AND matching record ABIs
    (a stale committed .so fails the size checks and TcpLB silently
    stays on the classic accept path)."""
    global _lanes_supported
    if _lanes_supported is None:
        ok = PROVIDER == "native" and hasattr(LIB, "vtl_lanes_new")
        if ok:
            try:
                ok = (int(LIB.vtl_lane_rec_size()) == LANE_REC.size
                      and int(LIB.vtl_lane_punt_size()) == LANE_PUNT.size)
            except Exception:
                ok = False
        _lanes_supported = ok
    return _lanes_supported


def uring_probe() -> int:
    """Runtime io_uring capability bitmask: bit0 io_uring_setup works,
    bit1 ACCEPT, bit2 CONNECT, bit3 POLL_ADD, bit4 SPLICE, bit5 SEND_ZC.
    0 on kernels without io_uring (this container's 4.4) or a .so built
    with -DVTL_NO_URING — the lanes then run the epoll engine."""
    if PROVIDER != "native" or not hasattr(LIB, "vtl_uring_probe"):
        return 0
    return int(LIB.vtl_uring_probe())


def uring_probe_fields() -> dict:
    """The probe as named BENCH/artifact fields."""
    m = uring_probe()
    return {"setup": bool(m & 1), "accept": bool(m & 2),
            "connect": bool(m & 4), "poll": bool(m & 8),
            "splice": bool(m & 16), "send_zc": bool(m & 32)}


def lanes_new(ip: str, port: int, backlog: int, nlanes: int, bufsize: int,
              uring: bool, timeout_ms: int, connect_timeout_ms: int) -> int:
    """-> lanes handle; raises OSError on bind failure. Lane listeners
    honor the same VPROXY_TPU_DEFER_ACCEPT knob as tcp_listen."""
    h = LIB.vtl_lanes_new(ip.encode(), port, backlog, nlanes, bufsize,
                          1 if uring else 0, timeout_ms,
                          connect_timeout_ms, defer_accept_secs())
    if not h:
        # the real reason (EINVAL bad lane count, EMFILE, EADDRINUSE...)
        # — a config error must not masquerade as a port conflict
        err = 0
        try:
            err = int(LIB.vtl_lanes_errno())
        except AttributeError:
            pass
        err = err or errno.EADDRINUSE
        raise OSError(err, f"accept lanes ({nlanes}) on {ip}:{port}: "
                      f"{os.strerror(err)}")
    return h


def lanes_active(handle: int) -> int:
    """Live lane-owned sessions — ONE atomic load (the per-accept
    overload check's read; lanes_stat is the detail surface)."""
    return int(LIB.vtl_lanes_active(handle))


def lanes_port(handle: int) -> int:
    return int(LIB.vtl_lanes_port(handle))


def lanes_engine(handle: int) -> str:
    return "uring" if LIB.vtl_lanes_engine(handle) else "epoll"


def lanes_close_listeners(handle: int) -> None:
    LIB.vtl_lanes_close_listeners(handle)


def lanes_shutdown(handle: int, grace_ms: int = 500) -> None:
    LIB.vtl_lanes_shutdown(handle, grace_ms)


def lanes_free(handle: int) -> None:
    if handle:
        LIB.vtl_lanes_free(handle)


def lanes_set_punt_all(handle: int, on: bool) -> None:
    LIB.vtl_lanes_set_punt_all(handle, 1 if on else 0)


def lanes_set_limit(handle: int, n: int) -> None:
    LIB.vtl_lanes_set_limit(handle, n)


def lanes_set_timeout(handle: int, timeout_ms: int) -> None:
    """Hot-set the lane idle timeout (`update tcp-lb ... timeout`)."""
    LIB.vtl_lanes_set_timeout(handle, timeout_ms)


def lane_gen(handle: int) -> int:
    return int(LIB.vtl_lane_gen(handle))


def lane_gen_bump(handle: int) -> None:
    """One C atomic — safe from any thread, called on every mutation."""
    LIB.vtl_lane_gen_bump(handle)


def lane_install(handle: int, packed: bytes, n: int, seq: list,
                 gen: int) -> int:
    """Install n LANE_REC backends + the WRR pick sequence, stamped with
    `gen` (read before the compile); -> usable sequence length, or
    -EAGAIN when a mutation raced the compile (caller recompiles)."""
    arr = (ctypes.c_int32 * len(seq))(*seq)
    return int(LIB.vtl_lane_install(handle, packed, n, arr, len(seq), gen))


def maglev_supported() -> bool:
    """Native provider with the maglev symbols AND a matching install-
    record ABI (a stale committed .so fails the size check and every
    maglev-mode lane compile falls back to the WRR/punt paths)."""
    if PROVIDER != "native" or not hasattr(LIB, "vtl_lane_maglev_install"):
        return False
    try:
        return int(LIB.vtl_maglev_rec_size()) == MAGLEV_REC.size
    except Exception:
        return False


def lane_maglev_install(handle: int, packed: bytes, n: int, table,
                        hash_port: bool, gen: int) -> int:
    """Install n MAGLEV_REC backends + the slot->backend table (an
    int32 numpy array / sequence from rules/maglev.build_table), stamped
    with `gen` like lane_install; hash_port=False = source affinity.
    -> table size installed, or -EAGAIN on a raced mutation."""
    arr = (ctypes.c_int32 * len(table))(*[int(x) for x in table])
    return int(LIB.vtl_lane_maglev_install(handle, packed, n, arr,
                                           len(table),
                                           1 if hash_port else 0, gen))


def maglev_pick(table, ip: bytes, port: int,
                hash_port: bool = True) -> int:
    """Pick through the EXACT C lookup the lanes run (parity surface);
    -1 on an empty table. Raises on a .so without the symbol."""
    arr = (ctypes.c_int32 * len(table))(*[int(x) for x in table])
    return int(LIB.vtl_maglev_pick(arr, len(table), ip, len(ip), port,
                                   1 if hash_port else 0))


def flow_maglev_install(handle: int, table, gen: int) -> int:
    """Attach the maglev table to a flow cache (generation-gated like
    flow_install: 0 when a mutation landed since `gen` was read)."""
    arr = (ctypes.c_int32 * len(table))(*[int(x) for x in table])
    return int(LIB.vtl_flow_maglev_install(handle, arr, len(table), gen))


def flow_maglev_pick(handle: int, ip: bytes, port: int,
                     hash_port: bool = True) -> int:
    """Pick through a flow cache's attached table; -1 when none."""
    return int(LIB.vtl_flow_maglev_pick(handle, ip, len(ip), port,
                                        1 if hash_port else 0))


def lanes_stat(handle: int) -> tuple:
    """(accepted, served, active, punt_classic, punt_stale, punt_fail,
    bytes, gen, engine, port, killed[, shed[, lat_ewma_us]]) for ONE
    lanes object — killed = lane-initiated teardowns (idle expiry,
    shutdown aborts), counted apart from served so hit_rate stays
    honest; shed = over-limit accepts RST-closed in C (adaptive
    overload; absent from an older prebuilt .so, which returns 11
    fields); lat_ewma_us = the C-plane accept->backend-connected EWMA
    the adaptive controller folds in (an older .so: 12 fields)."""
    out = (ctypes.c_uint64 * 13)()
    n = check(LIB.vtl_lanes_stat(handle, out))
    return tuple(int(out[i]) for i in range(n))


def lanes_set_shed(handle: int, on: bool) -> None:
    """Adaptive-overload shed mode: over-limit accepts RST-close inside
    the C accept plane (no punt, no TIME_WAIT). No-op on an older .so
    — over-limit accepts then keep punting to the python shed path."""
    fn = getattr(LIB, "vtl_lanes_set_shed", None)
    if fn is not None:
        fn(handle, 1 if on else 0)


def lane_counters() -> tuple:
    """(accepted, served, punt_classic, punt_stale, punt_fail) —
    process-global C atomics; zeros without the lanes .so."""
    if not lanes_supported():
        return (0,) * 5
    out = (ctypes.c_uint64 * 5)()
    LIB.vtl_lane_counters(out)
    return tuple(int(x) for x in out)


_LANE_PUNT_MAX = 128
_lane_tls = None  # per-thread punt buffers (each lane thread has its own)


def lane_poll(handle: int, idx: int, timeout_ms: int):
    """Park the lane thread in C for up to timeout_ms. -> list of punt
    tuples (fd, kind, err, cip, cport, bip, bport, trace_id), [] on
    timeout, or None once the lane drained after lanes_shutdown
    (thread exits)."""
    global _lane_tls
    if _lane_tls is None:
        import threading
        _lane_tls = threading.local()
    buf = getattr(_lane_tls, "buf", None)
    if buf is None:
        buf = _lane_tls.buf = ctypes.create_string_buffer(
            LANE_PUNT.size * _LANE_PUNT_MAX)
    n = LIB.vtl_lane_poll(handle, idx, buf, _LANE_PUNT_MAX, timeout_ms)
    if n == ESHUTDOWN:
        return None
    if n < 0:
        check(n)
    out = []
    for i in range(n):
        fd, kind, err, cport, bport, cip, bip, tid = \
            LANE_PUNT.unpack_from(buf, i * LANE_PUNT.size)
        out.append((fd, kind, err,
                    cip.split(b"\0", 1)[0].decode(), cport,
                    bip.split(b"\0", 1)[0].decode(), bport, tid))
    return out


# --------------------------------------------------------- span tracing
#
# The C accept plane's per-request tracing surface (native/vtl.cpp
# "span tracing", utils/trace.py is the process-wide collector): each
# lane thread writes fixed TraceRec records into its SPSC span ring;
# components/lanes.py drains them here. Overflow is counted in C
# (trace_counters) — never silent. The sampling knob lives in ONE C
# atomic (trace_set_sample) so python and C flip together.

# trace_id u64, t_start_ns u64, dur_ns u64, aux u64, lane u32,
# span u8, flags u8, err u16 — must match the C TraceRec
TRACE_REC = struct.Struct("<QQQQIBBH")
TRACE_REC_FIELDS = ("trace_id", "t_start_ns", "dur_ns", "aux", "lane",
                    "span", "flags", "err")
# span-id contract with the C TR_* defines (index == id)
TRACE_SPANS = ("accept", "route_pick", "connect", "splice", "close",
               "punt", "police")
# stage-index contract with the C LANE_STAGE_* defines: the
# vproxy_accept_stage_us stage each C-side histogram folds into
LANE_STAGES = ("backend_pick", "handover", "total")
LANE_STAGE_BUCKETS = 28  # log2 buckets incl. +Inf; Histogram parity

_trace_supported: bool = None  # type: ignore[assignment]


def trace_supported() -> bool:
    """Native provider with the trace symbols AND a matching record
    ABI (a stale committed .so fails the size check and the C plane
    silently contributes no spans — python-plane tracing still works)."""
    global _trace_supported
    if _trace_supported is None:
        ok = PROVIDER == "native" and hasattr(LIB, "vtl_trace_drain")
        if ok:
            try:
                ok = int(LIB.vtl_trace_rec_size()) == TRACE_REC.size
            except Exception:
                ok = False
        _trace_supported = ok
    return _trace_supported


def trace_set_sample(n: int) -> None:
    """Set the C-side 1-in-N sampling knob (0 = off). No-op on a .so
    without the trace surface."""
    fn = getattr(LIB, "vtl_trace_set_sample", None)
    if fn is not None:
        fn(max(0, int(n)))


def trace_set_ring_cap(cap: int) -> None:
    """Ring capacity for lanes created AFTER the call (tests shrink it
    to exercise overflow); clamped to a power of two."""
    fn = getattr(LIB, "vtl_trace_set_ring_cap", None)
    if fn is not None:
        fn(int(cap))


def trace_counters() -> tuple:
    """(spans_written, ring_overflow_drops) — process-global C atomics;
    zeros without the trace surface."""
    fn = getattr(LIB, "vtl_trace_counters", None)
    if fn is None or PROVIDER != "native":
        return (0, 0)
    out = (ctypes.c_uint64 * 2)()
    fn(out)
    return (int(out[0]), int(out[1]))


_TRACE_DRAIN_MAX = 256
_trace_tls = None  # per-thread drain buffers (each lane thread's own)


def trace_drain(handle: int, idx: int, maxrecs: int = _TRACE_DRAIN_MAX):
    """Drain one lane's span ring -> [(trace_id, t_start_ns, dur_ns,
    aux, lane, span, flags, err), ...]. SPSC contract: one concurrent
    caller per (handle, idx) — the lane's own python thread."""
    global _trace_tls
    if _trace_tls is None:
        import threading
        _trace_tls = threading.local()
    buf = getattr(_trace_tls, "buf", None)
    if buf is None:
        buf = _trace_tls.buf = ctypes.create_string_buffer(
            TRACE_REC.size * _TRACE_DRAIN_MAX)
    n = LIB.vtl_trace_drain(handle, idx, buf, min(maxrecs,
                                                  _TRACE_DRAIN_MAX))
    if n < 0:
        check(n)
    return [TRACE_REC.unpack_from(buf, i * TRACE_REC.size)
            for i in range(n)]


# ----------------------------------------------------- traffic analytics
#
# The C planes' heavy-hitter shards (native/vtl.cpp "traffic
# analytics"; utils/sketch.py owns the process-wide sketches): each
# accept lane coalesces (client, backend) observations into a lane-owned
# shard drained by that lane's OWN python thread (same OS thread as the
# producer — no concurrency), and the flow cache's per-entry hit
# tallies drain the same HH_REC shape. One hash contract: FNV-1a 64
# (vtl_hh_hash == sketch.fnv64, parity-tested).

# count u64, lane u32, dim u8, klen u8, key 54s — must match the C HHRec
HH_REC = struct.Struct("<QIBB54s")
HH_REC_FIELDS = ("count", "lane", "dim", "klen", "key")
# dim-index contract with the C HH_DIM_* defines (index == id); these
# map onto utils/sketch.DIMS entries of the same name
HH_DIMS = ("clients", "backends", "flows")

_hh_supported: bool = None  # type: ignore[assignment]


def hh_supported() -> bool:
    """Native provider with the analytics symbols AND a matching drain-
    record ABI (a stale committed .so fails the size check and the C
    planes silently contribute nothing — python-plane analytics still
    work)."""
    global _hh_supported
    if _hh_supported is None:
        ok = PROVIDER == "native" and hasattr(LIB, "vtl_hh_drain")
        if ok:
            try:
                ok = int(LIB.vtl_hh_rec_size()) == HH_REC.size
            except Exception:
                ok = False
        _hh_supported = ok
    return _hh_supported


def hh_set_enabled(on: bool) -> None:
    """Flip the one C analytics atomic (lanes + flow cache gate their
    per-event work on it). No-op on a .so without the surface."""
    fn = getattr(LIB, "vtl_hh_set_enabled", None)
    if fn is not None:
        fn(1 if on else 0)


def hh_hash(key: bytes) -> int:
    """The C-side FNV-1a 64 over raw key bytes — the py==C parity
    surface for utils/sketch.fnv64. Raises on a .so without it."""
    return int(LIB.vtl_hh_hash(bytes(key), len(key)))


def hh_counters() -> tuple:
    """(shard_updates, probe_window_overflows) — process-global C
    atomics; zeros without the analytics surface."""
    fn = getattr(LIB, "vtl_hh_counters", None)
    if fn is None or PROVIDER != "native":
        return (0, 0)
    out = (ctypes.c_uint64 * 2)()
    fn(out)
    return (int(out[0]), int(out[1]))


_HH_DRAIN_MAX = 256
_hh_tls = None  # per-thread drain buffers (each lane thread's own)


def _hh_buf():
    global _hh_tls
    if _hh_tls is None:
        import threading
        _hh_tls = threading.local()
    buf = getattr(_hh_tls, "buf", None)
    if buf is None:
        buf = _hh_tls.buf = ctypes.create_string_buffer(
            HH_REC.size * _HH_DRAIN_MAX)
    return buf


def _hh_unpack(buf, n: int) -> list:
    out = []
    for i in range(n):
        count, lane, dim, klen, key = HH_REC.unpack_from(
            buf, i * HH_REC.size)
        out.append((count, lane, dim, key[:klen]))
    return out


def hh_drain(handle: int, idx: int, maxrecs: int = _HH_DRAIN_MAX):
    """Drain one lane's analytics shard -> [(count, lane, dim,
    key_bytes), ...]. Same-thread contract as the shard's producer: the
    lane's own python thread, after its vtl_lane_poll returned."""
    buf = _hh_buf()
    n = LIB.vtl_hh_drain(handle, idx, buf, min(maxrecs, _HH_DRAIN_MAX))
    if n < 0:
        check(n)
    return _hh_unpack(buf, n)


def hh_flow_drain(handle: int, maxrecs: int = _HH_DRAIN_MAX):
    """Drain a flow cache's pending per-flow hit tallies (dim=flows,
    key = the 26-byte FlowKey). One caller per cache by contract — the
    owning switch's analytics tick; resumes its walk across calls."""
    fn = getattr(LIB, "vtl_hh_flow_drain", None)
    if fn is None:
        return []
    buf = _hh_buf()
    n = fn(handle, buf, min(maxrecs, _HH_DRAIN_MAX))
    if n < 0:
        check(n)
    return _hh_unpack(buf, n)


def lanes_stage_stat(handle: int, stage: int) -> tuple:
    """(count, sum_us, [28 log2 bucket counts]) for one LANE_STAGES
    entry of one Lanes object — cumulative; python merges the DELTAS
    into the vproxy_accept_stage_us histograms."""
    fn = getattr(LIB, "vtl_lanes_stage_stat", None)
    if fn is None:
        return (0, 0, [0] * LANE_STAGE_BUCKETS)
    out = (ctypes.c_uint64 * (2 + LANE_STAGE_BUCKETS))()
    check(fn(handle, stage, out))
    return (int(out[0]), int(out[1]),
            [int(out[2 + i]) for i in range(LANE_STAGE_BUCKETS)])


# capture-index contract with the C LANE_CAP_* defines: the workload
# histogram each lane-plane capture series folds into
LANE_CAPTURES = ("interarrival_us", "conn_bytes", "conn_duration_ms")


def lanes_capture_stat(handle: int, which: int) -> tuple:
    """(count, sum, [28 log2 bucket counts]) for one LANE_CAPTURES
    entry of one Lanes object — cumulative, like lanes_stage_stat;
    lane 0's tick merges the DELTAS into the workload/conn histograms."""
    fn = getattr(LIB, "vtl_lanes_capture_stat", None)
    if fn is None:
        return (0, 0, [0] * LANE_STAGE_BUCKETS)
    out = (ctypes.c_uint64 * (2 + LANE_STAGE_BUCKETS))()
    check(fn(handle, which, out))
    return (int(out[0]), int(out[1]),
            [int(out[2 + i]) for i in range(LANE_STAGE_BUCKETS)])


def workload_set_enabled(on: bool) -> None:
    """Push the workload-capture knob into the native plane (no-op on an
    older .so or the python provider — capture still works for the
    python-path planes, the lane plane just contributes nothing)."""
    fn = getattr(LIB, "vtl_workload_set_enabled", None)
    if fn is not None:
        fn(1 if on else 0)


# ------------------------------------------------------------- policing
#
# The C admission table (native/vtl.cpp "PoliceRec"): the policing
# engine (policing/engine.py) compiles its clients-dimension enforcement
# entries into POLICE_REC records and installs them generation-stamped
# into each TcpLB's lanes, where the accept path's probe is one
# open-addressed lookup + token-bucket debit. key_hash is fnv64 over the
# RAW client address bytes — the same bytes maglev_addr_bytes hands the
# C probe, so the engine hashes socket.inet_pton output, never the
# rendered string.

# key_hash u64, rate_mtok u32, burst_mtok u32, action u8, dim u8,
# pad 2s — must match the C PoliceRec
POLICE_REC = struct.Struct("<QIIBB2s")
POLICE_REC_FIELDS = ("key_hash", "rate_mtok", "burst_mtok", "action",
                     "dim", "pad")
# action-code contract with the C POLICE_ACT_* defines (index == id);
# these map onto policing/engine.ACTIONS entries of the same name
POLICE_ACTIONS = ("monitor", "throttle", "shed")

_police_supported: bool = None  # type: ignore[assignment]


def police_supported() -> bool:
    """Native provider with the policing symbols AND a matching install-
    record ABI (a stale committed .so fails the size check and the lanes
    silently run unpoliced — the python mirror still enforces)."""
    global _police_supported
    if _police_supported is None:
        ok = PROVIDER == "native" and hasattr(LIB, "vtl_police_install")
        if ok:
            try:
                ok = int(LIB.vtl_police_rec_size()) == POLICE_REC.size
            except Exception:
                ok = False
        _police_supported = ok
    return _police_supported


def police_set_enabled(on: bool) -> None:
    """Flip the one C policing atomic (the lane probes gate their work
    on it). No-op on a .so without the surface."""
    fn = getattr(LIB, "vtl_police_set_enabled", None)
    if fn is not None:
        fn(1 if on else 0)


def police_install(handle: int, packed: bytes, n: int, gen: int) -> int:
    """Install n POLICE_REC entries stamped with `gen` (read before the
    engine's compile); -> entries installed, or -EAGAIN when a mutation
    raced the compile (caller re-reads the generation and recompiles).
    Bucket state carries over for keys whose parameters are unchanged."""
    return int(LIB.vtl_police_install(handle, packed, n, gen))


def police_counters(handle: int) -> tuple:
    """(checked, shed, throttled, monitored, stale) for ONE lanes
    object — cumulative; lane 0's drain folds the DELTAS into the
    policing attribution (throttled excluded: the python mirror counts
    those once when it re-decides the punt)."""
    fn = getattr(LIB, "vtl_police_counters", None)
    if fn is None:
        return (0,) * 5
    out = (ctypes.c_uint64 * 5)()
    check(fn(handle, out))
    return tuple(int(x) for x in out)


def police_check(handle: int, key: bytes, now_ns: int) -> int:
    """Probe one raw key at an explicit timestamp through the EXACT
    accept-path logic (knob, generation gate, bucket debit) — the
    C==python parity surface. -2 knob off, -1 forced consult-miss
    (admit), 0 admit, else 1 + action code. Raises on a .so without
    the symbol."""
    return int(LIB.vtl_police_check(handle, bytes(key), len(key),
                                    now_ns))


def sendmmsg(fd: int, datas: list, ip: str, port: int) -> int:
    """Send many datagrams to ONE destination; -> count accepted."""
    n = len(datas)
    sent_total = 0
    ipb = ip.encode()
    v6 = 1 if ":" in ip else 0
    i = 0
    while i < n:
        chunk = datas[i: i + 512]
        ptrs = (ctypes.c_char_p * len(chunk))(*chunk)
        lens = (ctypes.c_int * len(chunk))(*[len(d) for d in chunk])
        r = LIB.vtl_sendmmsg(fd, ptrs, lens, len(chunk), ipb, port, v6)
        if r < 0:
            check(r)
        sent_total += r
        if r < len(chunk):
            break  # buffer pressure: remaining datagrams dropped
        i += len(chunk)
    return sent_total
