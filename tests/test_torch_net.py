"""Torch port, host event plane: loop, connections, FD providers, sniff.

The port's copies of vproxy_tpu's net/ modules run here on the CPU
(VPROXY_TPU_TORCH_DEVICE=cpu), against real loopback sockets:

* ports of tests/test_eventloop.py, tests/test_provider.py,
  tests/test_oom.py and the two wrapfd cases of
  tests/test_wrapfd_dhcp.py, on the port's modules;
* the port's libvtl: built from its own native/vtl.cpp into a build
  directory keyed by content (an edited source builds anew, concurrent
  processes build it once), exporting the current ABI, the port's vlint ABI
  pass over the port's vtl.cpp / vtl.py pair, and the fdtrace cases of
  tests/test_fdtrace.py;
* Maglev in three planes: the port's C pick (vtl.maglev_pick), the
  port's maglev.pick and the reference's;
* parse_client_hello_sni of the port == the reference's on stdlib
  ClientHellos and every truncation of them;
* ClassifyService delivering on a real port SelectorEventLoop: every
  callback on the loop thread, answers equal to the reference service's,
  and a submit after the loop closed delivered on the dispatcher;
* chip_smoke.py's event-plane phase at a small size, its answers equal
  to the reference's host index and Maglev pick.

Every socket binds 127.0.0.1:0, and every wait is bounded.
"""
import ctypes
import os
import random
import shutil
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

import chip_smoke as CS
from test_fused import mk_ips, mk_queries, mk_rules
from test_native_build import REQUIRED_SYMBOLS
from vproxy_tpu.net.sniff import parse_client_hello_sni as ref_sni
from vproxy_tpu.rules import engine as RE
from vproxy_tpu.rules import maglev as RM
from vproxy_tpu.rules.index import HintIndex as RefIndex
from vproxy_tpu.rules.ir import Hint as RefHint
from vproxy_tpu.rules.service import ClassifyService as RefService
from vproxy_tpu_torch.net import vtl, vtl_py
from vproxy_tpu_torch.net.connection import Connection, Handler, ServerSock
from vproxy_tpu_torch.net.eventloop import SelectorEventLoop
from vproxy_tpu_torch.net.sniff import MAX_HELLO, parse_client_hello_sni
from vproxy_tpu_torch.net.wrapfd import BlockingUdp, FileConn
from vproxy_tpu_torch.tools.vlint import structs as vstructs
from vproxy_tpu_torch.rules import engine as E
from vproxy_tpu_torch.rules import maglev as M
from vproxy_tpu_torch.rules.service import ClassifyService
from vproxy_tpu_torch.utils.ip import parse_ip

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_VTL_CPP = os.path.join(ROOT, "vproxy_tpu_torch", "native", "vtl.cpp")
PORT_VTL_PY = os.path.join(ROOT, "vproxy_tpu_torch", "net", "vtl.py")


@pytest.fixture
def loop():
    lp = SelectorEventLoop("test")
    lp.loop_thread()
    yield lp
    lp.close()


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("VPROXY_TPU_INSTALL_PACE", "0")


def wait_for(cond, timeout=5.0):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout:
            raise TimeoutError()
        time.sleep(0.005)


def run_child(code: str, **env):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60,
                          env={**os.environ, "PYTHONPATH": ROOT, **env})


# ------------------------------------------------- event loop and pump
# (ports of tests/test_eventloop.py)

def test_timers_and_cross_thread(loop):
    fired = []
    loop.run_on_loop(lambda: fired.append("x"))
    loop.run_on_loop(lambda: loop.delay(30, lambda: fired.append("t")))
    wait_for(lambda: fired == ["x", "t"])
    # periodic fires repeatedly then cancels
    count = []
    holder = {}

    def tick():
        count.append(1)
        if len(count) >= 3:
            holder["p"].cancel()
    loop.run_on_loop(lambda: holder.setdefault("p", loop.period(20, tick)))
    wait_for(lambda: len(count) >= 3)
    n = len(count)
    time.sleep(0.12)
    assert len(count) == n  # cancelled


def test_echo_server_and_client_conn(loop):
    got = []

    class Echo(Handler):
        def on_data(self, conn, data):
            conn.write(data)

    def on_accept(fd, ip, port):
        c = Connection(loop, fd, (ip, port))
        c.set_handler(Echo())

    holder = {}

    def mk():
        holder["srv"] = ServerSock(loop, "127.0.0.1", 0, on_accept)
    loop.run_on_loop(mk)
    wait_for(lambda: "srv" in holder)
    port = holder["srv"].port

    class Client(Handler):
        def on_connected(self, conn):
            conn.write(b"hello vtl")

        def on_data(self, conn, data):
            got.append(data)
            conn.close()

    def mkc():
        c = Connection.connect(loop, "127.0.0.1", port)
        c.set_handler(Client())
    loop.run_on_loop(mkc)
    wait_for(lambda: got)
    assert b"".join(got) == b"hello vtl"


def _echo_backend(serve):
    backend = socket.socket()
    backend.bind(("127.0.0.1", 0))
    backend.listen(8)
    threading.Thread(target=serve, args=(backend,), daemon=True).start()
    return backend.getsockname()[1]


def test_native_pump_splice_proxy(loop):
    """client <-> [proxy: accept + connect + native pump] <-> echo backend"""
    def serve(backend):
        c, _ = backend.accept()
        while True:
            d = c.recv(65536)
            if not d:
                break
            c.sendall(d)
        c.close()
    bport = _echo_backend(serve)
    done = {}

    def on_accept(cfd, ip, port):
        back = Connection.connect(loop, "127.0.0.1", bport)

        class Back(Handler):
            def on_connected(self, conn):
                bfd = conn.detach()
                loop.pump(cfd, bfd, 65536, lambda a2b, b2a, err:
                          done.setdefault("stat", (a2b, b2a, err)))

            def on_closed(self, conn, err):
                done.setdefault("stat", (0, 0, err or 1))
        back.set_handler(Back())

    holder = {}
    loop.run_on_loop(lambda: holder.setdefault(
        "srv", ServerSock(loop, "127.0.0.1", 0, on_accept)))
    wait_for(lambda: "srv" in holder)
    cli = socket.create_connection(("127.0.0.1", holder["srv"].port),
                                   timeout=5)
    payload = b"x" * 1_000_000

    def pump_out():
        cli.sendall(payload)
        cli.shutdown(socket.SHUT_WR)
    threading.Thread(target=pump_out, daemon=True).start()
    rx = b""
    while True:
        d = cli.recv(65536)
        if not d:
            break
        rx += d
    cli.close()
    assert rx == payload
    wait_for(lambda: "stat" in done)
    a2b, b2a, err = done["stat"]
    assert err == 0
    assert a2b == len(payload) and b2a == len(payload)


def test_pump_backend_reset(loop):
    """backend closes mid-stream -> pump reports and client sees EOF/RST"""
    def serve(backend):
        c, _ = backend.accept()
        c.recv(10)
        c.close()  # slam shut
    bport = _echo_backend(serve)
    done = {}

    def on_accept(cfd, ip, port):
        back = Connection.connect(loop, "127.0.0.1", bport)

        class Back(Handler):
            def on_connected(self, conn):
                bfd = conn.detach()
                loop.pump(cfd, bfd, 65536, lambda a2b, b2a, err:
                          done.setdefault("stat", (a2b, b2a, err)))
        back.set_handler(Back())

    holder = {}
    loop.run_on_loop(lambda: holder.setdefault(
        "srv", ServerSock(loop, "127.0.0.1", 0, on_accept)))
    wait_for(lambda: "srv" in holder)
    cli = socket.create_connection(("127.0.0.1", holder["srv"].port),
                                   timeout=5)
    cli.sendall(b"0123456789")
    # backend FIN is relayed: client sees EOF; the session stays
    # half-open until the client also closes (the splice semantics)
    assert cli.recv(100) == b""
    assert "stat" not in done
    cli.close()
    wait_for(lambda: "stat" in done)


# ------------------------------------------------------- FD providers
# (ports of tests/test_provider.py)

def test_env_selects_python_provider():
    r = run_child(
        "from vproxy_tpu_torch.net import vtl\n"
        "assert vtl.PROVIDER == 'py', vtl.PROVIDER\n"
        "assert type(vtl.LIB).__name__ == 'PyLib'\n"
        "assert vtl.LIB_PATH is None, vtl.LIB_PATH\n"
        "lfd = vtl.tcp_listen('127.0.0.1', 0)\n"
        "ip, port = vtl.sock_name(lfd)\n"
        "assert port > 0\n"
        "vtl.close(lfd)\n"
        "print('py provider ok')",
        VPROXY_TPU_FD_PROVIDER="py")
    assert r.returncode == 0, r.stderr
    assert "py provider ok" in r.stdout


def test_python_pump_splices_and_reports_done():
    """The Python pump mirrors the native engine: bidirectional bytes,
    FIN propagation, byte counters, EV_PUMP_DONE via poll."""
    lib = vtl_py.PyLib()
    lp = lib.vtl_new()
    a0, a1 = socket.socketpair()
    b0, b1 = socket.socketpair()
    for s in (a0, a1, b0, b1):
        s.setblocking(False)
    # register the pump ends with LIVE wrappers (detach invalidates the
    # original objects) — FIN propagation shuts down via the registry
    fd_a = a1.detach()
    fd_b = b0.detach()
    vtl_py._socks[fd_a] = socket.socket(fileno=fd_a)
    vtl_py._socks[fd_b] = socket.socket(fileno=fd_b)
    pid = lib.vtl_pump_new(lp, fd_a, fd_b, 8192)
    assert pid > 0
    a0.sendall(b"x" * 10000)   # a -> b
    b1.sendall(b"y" * 5000)    # b -> a
    tags = [0] * 64
    evs = [0] * 64
    got = {b1: b"", a0: b""}
    deadline = time.time() + 5
    done = False
    a0.shutdown(socket.SHUT_WR)
    b1.shutdown(socket.SHUT_WR)
    while time.time() < deadline and not done:
        n = lib.vtl_poll(lp, tags, evs, 64, 100)
        for i in range(n):
            if evs[i] == vtl_py.EV_PUMP_DONE:
                assert tags[i] == pid
                done = True
        for s in (b1, a0):
            try:
                got[s] += s.recv(65536)
            except BlockingIOError:
                continue
    # drain what is left after done; both peers must then see EOF (the
    # pump propagated the FINs)
    eofs = 0
    for s in (b1, a0):
        deadline2 = time.time() + 3
        while time.time() < deadline2:
            try:
                d = s.recv(65536)
            except BlockingIOError:
                time.sleep(0.01)
                continue
            except OSError:
                break
            if not d:
                eofs += 1
                break
            got[s] += d
    assert done
    assert eofs == 2, "peers must see the propagated FINs"
    assert got[b1] == b"x" * 10000
    assert got[a0] == b"y" * 5000
    out = [0, 0, 0]
    assert lib.vtl_pump_stat(lp, pid, out) == 0
    assert out[0] == 10000 and out[1] == 5000 and out[2] == 0
    assert lib.vtl_pump_free(lp, pid) == 0
    lib.vtl_free(lp)
    a0.close()
    b1.close()


# ----------------------------------------------------------------- OOM
# (ports of tests/test_oom.py)

def test_memoryerror_logs_and_exits_137():
    r = run_child(
        "from vproxy_tpu_torch.utils import oom\n"
        "oom.install()\n"
        "raise MemoryError('simulated heap exhaustion')\n")
    assert r.returncode == 137, (r.returncode, r.stderr)
    assert "out of memory" in r.stderr
    assert "simulated heap exhaustion" in r.stderr


def test_memoryerror_on_thread_exits_137():
    r = run_child(
        "import threading, time\n"
        "from vproxy_tpu_torch.utils import oom\n"
        "oom.install()\n"
        "t = threading.Thread(target=lambda: (_ for _ in ()).throw(\n"
        "    MemoryError('worker oom')))\n"
        "t.start(); t.join(); time.sleep(5)\n"
        "print('should not reach here')\n")
    assert r.returncode == 137, (r.returncode, r.stderr)
    assert "worker oom" in r.stderr
    assert "should not reach here" not in r.stdout


def test_memoryerror_in_loop_callback_exits_137():
    """The loop's callback guard must NOT swallow MemoryError the way it
    swallows ordinary handler errors."""
    r = run_child(
        "import time\n"
        "from vproxy_tpu_torch.utils import oom\n"
        "from vproxy_tpu_torch.net.eventloop import SelectorEventLoop\n"
        "oom.install()\n"
        "lp = SelectorEventLoop('t'); lp.loop_thread()\n"
        "lp.run_on_loop(lambda: (_ for _ in ()).throw(MemoryError('cb oom')))\n"
        "time.sleep(5)\n"
        "print('should not reach here')\n")
    assert r.returncode == 137, (r.returncode, r.stderr)
    assert "cb oom" in r.stderr
    assert "should not reach here" not in r.stdout


def test_other_exceptions_pass_through():
    r = run_child(
        "from vproxy_tpu_torch.utils import oom\n"
        "oom.install()\n"
        "raise ValueError('normal crash')\n")
    assert r.returncode == 1
    assert "ValueError: normal crash" in r.stderr
    assert "out of memory" not in r.stderr


# -------------------------------------------------------------- wrapfd
# (ports of the wrapfd cases of tests/test_wrapfd_dhcp.py)

def test_blocking_udp_roundtrip(loop):
    b = BlockingUdp(loop, "127.0.0.1", 0)
    try:
        peer = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        peer.bind(("127.0.0.1", 0))
        pport = peer.getsockname()[1]
        # blocking recv on a plain thread while the loop feeds the queue
        b.send(b"ping", "127.0.0.1", pport)
        data, addr = peer.recvfrom(100)
        assert data == b"ping"
        peer.sendto(b"pong", ("127.0.0.1", b.local[1]))
        data, ip, port = b.recv(timeout=5)
        assert data == b"pong" and port == pport
        with pytest.raises(TimeoutError):
            b.recv(timeout=0.05)
        peer.close()
    finally:
        b.close()


def test_file_conn_streams_and_backpressure(tmp_path, loop):
    p = tmp_path / "payload.bin"
    blob = os.urandom(200_000)
    p.write_bytes(blob)
    got = bytearray()
    events = {"eof": threading.Event(), "paused_at": None}
    fc = FileConn(loop, str(p))

    class H(Handler):
        def on_data(self, c, data):
            got.extend(data)
            if events["paused_at"] is None and len(got) >= 65536:
                events["paused_at"] = len(got)
                c.pause_reading()
                loop.delay(50, c.resume_reading)

        def on_eof(self, c):
            events["eof"].set()
            c.close()

        def on_closed(self, c, err):
            events["eof"].set()

    assert fc.length == len(blob)
    fc.set_handler(H())
    assert events["eof"].wait(10)
    assert bytes(got) == blob
    assert events["paused_at"] is not None  # backpressure exercised


# ------------------------------------------------------ the port's libvtl

# the surface tests/test_native_build.py requires of the reference's
# library, and the peek the accept path reads the ClientHello with
REQUIRED = REQUIRED_SYMBOLS + ("vtl_recv_peek",)
SIZE_FNS = {"FLOW_REC": "vtl_flow_rec_size", "LANE_REC": "vtl_lane_rec_size",
            "LANE_PUNT": "vtl_lane_punt_size",
            "MAGLEV_REC": "vtl_maglev_rec_size",
            "TRACE_REC": "vtl_trace_rec_size", "HH_REC": "vtl_hh_rec_size",
            "POLICE_REC": "vtl_police_rec_size"}

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build libvtl")


@needs_gxx
def test_port_vtl_rebuilds_on_source_change_and_exports_abi(tmp_path):
    """The build is keyed by content: the same source reuses its library,
    an edited copy builds a new one, and the library exports the surface
    vtl.py binds with every shared record the size its struct packs."""
    src = tmp_path / "vtl.cpp"
    shutil.copy(PORT_VTL_CPP, src)
    build = str(tmp_path / "_build")
    lib1 = vtl.build_library(str(src), build)
    t1 = os.path.getmtime(lib1)
    assert vtl.build_library(str(src), build) == lib1
    assert os.path.getmtime(lib1) == t1  # reused, not rebuilt
    with open(src, "a") as f:
        f.write("\n// an edit\n")
    lib2 = vtl.build_library(str(src), build)
    assert lib2 != lib1 and os.path.dirname(lib2) == build
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]
    lib = ctypes.CDLL(lib2)
    missing = [s for s in REQUIRED if not hasattr(lib, s)]
    assert not missing, missing
    model = vstructs.shared_model(ROOT)
    assert set(SIZE_FNS) == set(model) == set(vstructs.SHARED_RECORDS)
    for name, fn in SIZE_FNS.items():
        assert int(getattr(lib, fn)()) == getattr(vtl, name).size, name
    # the loaded library is the port's build of the port's source
    if vtl.PROVIDER == "native" and not os.environ.get("VPROXY_TPU_VTL_SO"):
        assert vtl.LIB_PATH.startswith(vtl.BUILD_DIR + os.sep)
        assert vtl.SOURCE == PORT_VTL_CPP


@needs_gxx
def test_port_vtl_concurrent_builders_build_once(tmp_path):
    """Three processes asking for the same library at once get one
    build: the same path, no temporary left behind."""
    src = tmp_path / "vtl.cpp"
    shutil.copy(PORT_VTL_CPP, src)
    with open(src, "a") as f:
        f.write("\n// concurrent builders\n")
    build = str(tmp_path / "_build")
    code = ("from vproxy_tpu_torch.net.vtl import build_library\n"
            f"print(build_library({str(src)!r}, {build!r}))\n")
    env = {**os.environ, "PYTHONPATH": ROOT, "VPROXY_TPU_FD_PROVIDER": "py"}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    assert sorted(f for f in os.listdir(build) if not f.startswith(".")) \
        == [os.path.basename(paths.pop())]


def test_fdtrace_logs_every_fd_op():
    """tests/test_fdtrace.py on the port's vtl: a child with
    VPROXY_TPU_FDTRACE=1 logs every syscall-layer op it performs on
    stderr, with args and results, failures included."""
    code = (
        "from vproxy_tpu_torch.net import vtl\n"
        "lfd = vtl.tcp_listen('127.0.0.1', 0)\n"
        "ip, port = vtl.sock_name(lfd)\n"
        "cfd = vtl.tcp_connect('127.0.0.1', port)\n"
        "vtl.close(cfd)\n"
        "vtl.close(lfd)\n"
        "try:\n"
        "    vtl.tcp_listen('300.1.1.1', 0)\n"
        "except OSError:\n"
        "    pass\n"
    )
    r = run_child(code, VPROXY_TPU_FDTRACE="1")
    assert r.returncode == 0, r.stderr
    err = r.stderr
    assert "[fdtrace] tcp_listen('127.0.0.1',0) -> " in err
    assert "[fdtrace] sock_name(" in err
    assert "[fdtrace] tcp_connect('127.0.0.1'," in err
    assert "[fdtrace] close(" in err
    assert "tcp_listen('300.1.1.1',0) !> " in err


def test_fdtrace_off_by_default():
    assert not vtl._trace_installed


def test_vlint_abi_pass_over_the_port_pair():
    assert vstructs.check_abi(ROOT, cpp_path=PORT_VTL_CPP,
                              py_path=PORT_VTL_PY) == []


def test_port_vtl_cpp_is_the_reference_code():
    """The port's vtl.cpp is the reference's line for line: only the
    text of `//` comments may differ."""
    with open(PORT_VTL_CPP) as a, open(os.path.join(
            ROOT, "vproxy_tpu", "native", "vtl.cpp")) as b:
        ours, ref = a.read().splitlines(), b.read().splitlines()
    assert len(ours) == len(ref)
    for i, (x, y) in enumerate(zip(ours, ref), 1):
        assert x.split("//")[0] == y.split("//")[0], i


# -------------------------------------------------------- Maglev planes

def _ents(n, weights=None):
    ws = weights or [10] * n
    return [(f"10.0.{i // 256}.{i % 256}:80", ws[i]) for i in range(n)]


@pytest.mark.skipif(not vtl.maglev_supported(),
                    reason="no native maglev symbols")
@pytest.mark.parametrize("entries,m,picks", [
    (_ents(5), 251, 500),  # tests/test_maglev.py's parity table
    (_ents(6, [10, 20, 10, 5, 10, 40]), 251, 500),
    ([(f"10.{i // 250}.{i % 250}.1:80", 1 + i % 4) for i in range(256)],
     65537, 40),  # chip_smoke.py's table
])
def test_maglev_three_planes_pick_identically(entries, m, picks):
    tab = M.build_table(entries, m)
    rtab = RM.build_table(entries, m)
    assert tab.tobytes() == rtab.tobytes()
    rng = random.Random(7)
    for _ in range(picks):
        ip = bytes(rng.randrange(256) for _ in range(rng.choice((4, 16))))
        port = rng.randrange(65536)
        assert vtl.maglev_pick(tab, ip, port, True) == \
            M.pick(tab, ip, port) == RM.pick(rtab, ip, port)
        assert vtl.maglev_pick(tab, ip, 0, False) == \
            M.pick(tab, ip, None) == RM.pick(rtab, ip, None)


# ---------------------------------------------------------------- sniff

SNI_HOSTS = ("fuzz.example.com", "svc7.ns7.example.com", "a.io",
             "x" * 63 + "." + "y" * 60 + ".example.net",
             "Mixed.Case.Example.ORG")


@pytest.mark.parametrize("host", SNI_HOSTS)
def test_sni_parse_matches_reference_on_every_truncation(host):
    hello = CS.tls_hellos([host])[0]
    assert len(hello) <= MAX_HELLO
    sni, complete = parse_client_hello_sni(hello)
    assert complete and sni is not None and sni.lower() == host.lower()
    for i in range(len(hello) + 1):
        assert parse_client_hello_sni(hello[:i]) == ref_sni(hello[:i]), i
    rng = random.Random(len(host))
    for _ in range(200):  # corrupted bytes, same verdicts
        b = bytearray(hello)
        for _ in range(rng.randint(1, 4)):
            b[rng.randrange(len(b))] = rng.randrange(256)
        assert parse_client_hello_sni(bytes(b)) == ref_sni(bytes(b))
    for blob in (b"GET / HTTP/1.1\r\n\r\n", b"\x16\x03\x01", b""):
        assert parse_client_hello_sni(blob) == ref_sni(blob)


# ------------------------------------------- ClassifyService on the loop

BACKENDS = [(f"10.9.{i // 250}.{i % 250}:80", 1 + i % 4) for i in range(11)]


def pairs(rules):
    """-> (port pair on the CPU, reference pair) over the same tables."""
    return (M.FusedPair(E.HintMatcher(rules), M.MaglevMatcher(BACKENDS,
                                                              m=251)),
            RM.FusedPair(RE.HintMatcher(rules, backend="jax"),
                         RM.MaglevMatcher(BACKENDS, m=251)))


def submit_all(svc, kind, target, payloads, loop=None):
    """Submit every payload; -> [(answer, thread name)] in order."""
    got = [None] * len(payloads)
    evs = [threading.Event() for _ in payloads]

    def cb_for(i):
        def cb(*res):
            got[i] = (tuple(res[:-1]), threading.current_thread().name)
            evs[i].set()
        return cb

    for i, p in enumerate(payloads):
        if kind == "cpick":
            svc.submit_classify_pick(target, *p, cb_for(i), loop=loop)
        else:
            svc.submit_hint(target, p, cb_for(i), loop=loop)
    for ev in evs:
        assert ev.wait(30)
    return got


def _payloads(kind, rules, b):
    hints, ips = mk_queries(rules, b), mk_ips(b)
    ports = [None if i % 3 == 0 else 1024 + i for i in range(b)]
    if kind == "cpick":
        return list(zip(hints, ips, ports))
    return hints


@pytest.mark.parametrize("kind", ["hint", "cpick"])
def test_service_delivers_on_the_loop_thread_vs_reference(cpu, loop, kind):
    rules = mk_rules(600)
    pair, ref = pairs(rules)
    payloads = _payloads(kind, rules, 64)
    target, rtarget = (pair, ref) if kind == "cpick" else (pair.hm, ref.hm)
    svc, rsvc = ClassifyService(mode="device"), RefService(mode="device")
    try:
        got = submit_all(svc, kind, target, payloads, loop=loop)
        want = submit_all(rsvc, kind, rtarget, payloads)
    finally:
        svc.close()
        rsvc.close()
    assert [a for a, _ in got] == [a for a, _ in want]
    assert {name for _, name in got} == {loop.name}
    assert svc.stats.device_queries == len(payloads)


@pytest.mark.parametrize("kind", ["hint", "cpick"])
def test_service_submit_after_loop_close_delivers_on_dispatcher(cpu, kind):
    """run_on_loop refuses a closed loop; the answer is then delivered on
    the dispatcher thread, not dropped."""
    lp = SelectorEventLoop("closed")
    lp.loop_thread()
    lp.close()
    rules = mk_rules(300)
    pair, ref = pairs(rules)
    payloads = _payloads(kind, rules, 8)
    target, rtarget = (pair, ref) if kind == "cpick" else (pair.hm, ref.hm)
    svc, rsvc = ClassifyService(mode="device"), RefService(mode="device")
    try:
        assert lp.run_on_loop(lambda: None) is False
        got = submit_all(svc, kind, target, payloads, loop=lp)
        want = submit_all(rsvc, kind, rtarget, payloads)
    finally:
        svc.close()
        rsvc.close()
    assert [a for a, _ in got] == [a for a, _ in want]
    assert {name for _, name in got} == {"classify-dispatch"}


# ------------------------------------------------- the slice as a whole

def test_chip_smoke_loop_phase_on_cpu_vs_reference(cpu):
    """chip_smoke.py's event-plane phase at a small size on the CPU: TLS
    hellos accepted on the port's loop over the native vtl, classified
    and picked by ClassifyService, answered on the loop thread; every
    answer also equal to the reference's HintIndex and Maglev pick."""
    if vtl.PROVIDER != "native":
        pytest.skip("the phase runs on the native FD provider only")
    rules = mk_rules(800)
    dev = torch.device("cpu")
    pair = M.FusedPair(E.HintMatcher(rules, device=dev),
                       M.MaglevMatcher(BACKENDS, m=251, device=dev))
    out, rows = CS.phase_loop(dev, pair, rules, bursts=2, burst=24,
                              concurrency=24)
    assert out["connections"] == len(rows) == 48
    assert out["batches"] >= 1 and out["b1_launches"] == 0  # plain tier
    assert out["accept_to_delivery_p99_us"] >= \
        out["accept_to_delivery_p50_us"] > 0
    assert out["provider"] == "native"
    assert out["libvtl"].startswith(os.path.join("vproxy_tpu_torch",
                                                 "_build") + os.sep)
    idx, tab = RefIndex(rules), RM.build_table(BACKENDS, 251)
    lo = parse_ip("127.0.0.1")
    for host, src, cport, v, p in rows:
        assert src == lo
        assert (v, p) == (idx.lookup(RefHint.of_host(host)),
                          RM.pick(tab, src, cport))
