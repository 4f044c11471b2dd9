"""Process entry — `python -m vproxy_tpu_torch`.

The port's copy of vproxy_tpu/main.py: the same arguments, env layer
and default controller ports. It serves on the CUDA device: without a
GPU it exits 1 with torchenv's message, unless the caller asks for the
host (VPROXY_TPU_TORCH_DEVICE=cpu: the matchers on the CPU;
VPROXY_TPU_MATCHER=host: no device matcher at all). Not carried over
yet: the jax.distributed bring-up (VPROXY_TPU_DIST_*), the cluster
plane (VPROXY_TPU_CLUSTER_PEERS is refused, ROADMAP Queue A item 8),
the matcher backends VPROXY_TPU_MATCHER=jax-sharded and jax-fp-sharded
(refused, item 8), and the deployable apps other than `simple`
(refused, item 10). VPROXY_TPU_MATCHER=jax-fp serves the port's
"torch-fp" backend, jax-dense its "torch-dense" backend.

Parity: app/Main.java: default controllers (resp on 16309, http on
18776, both on 127.0.0.1 — Main.java:319-337), load-last-config at boot,
hourly auto-save, signal-triggered graceful save+exit, stdio REPL.

Args (subset of the reference's op grammar, app/args/*):
  resp-controller <addr> <password>   start RESP controller there
  http-controller <addr>              start HTTP controller there
  allowSystemCommandInNonStdIOController (accepted, no-op)
  load <file>            load a config file instead of the default
  noLoadLast             do not load the last config
  noSave                 disable auto/exit saving
  noStdIOController      do not start the stdin REPL
  workers <n>            worker event loops (default: cpu count)

Env flags (the reference's -D system-property layer, Config.java):
  VPROXY_TPU_LOG=debug|info|warn|error   log level filter
  VPROXY_TPU_PROBE=ch1,ch2               targeted data-path probe channels
  VPROXY_TPU_FDTRACE=1                   trace every FD syscall (-Dvfdtrace)
  VPROXY_TPU_MATCHER=...                 classify backend override
  VPROXY_TPU_FP_MEMBER=gather|selgather|reduce
                                         fp-kernel member-eval lowering
  VPROXY_TPU_WORKERS=n                   default worker loop count
  VPROXY_TPU_HOME=dir                    config/persistence directory
  VPROXY_TPU_FD_PROVIDER=native|py       socket/pump backend
  VPROXY_TPU_NATIVE_TLS=0                force python TLS (MemoryBIO)
  VPROXY_TPU_SWITCH_FASTPATH=0           force object-path switch
  VPROXY_TPU_FASTPATH_MIN=n              burst floor for the fast path
  VPROXY_TPU_CLASSIFY=auto|device|host   dispatch-path policy
  VPROXY_TPU_CLASSIFY_BUDGET_US=n        lone-query latency budget
  VPROXY_TPU_TORCH_DEVICE=cuda|cpu       the matchers' device (cuda)

Cluster plane: VPROXY_TPU_CLUSTER_PEERS is refused (not ported yet);
  VPROXY_TPU_CLUSTER_SERVICE=name        DNS service sub-domain (cluster)

Failure-containment knobs (docs/robustness.md):
  VPROXY_TPU_CONNECT_RETRIES=n           backend connect retries (default 2)
  VPROXY_TPU_CONNECT_TIMEOUT_MS=ms       backend connect deadline (3000)
  VPROXY_TPU_RETRY_BUDGET=r              retries <= r * accepts (default .2)
  VPROXY_TPU_MAX_SESSIONS=n              per-LB overload shed threshold
  VPROXY_TPU_DRAIN_S=s                   SIGTERM/`drain` grace (default 15)
  VPROXY_TPU_EJECT_FAILURES=n            passive-eject streak (default 3)
  VPROXY_TPU_EJECT_BASE_S / _CAP_S       eject backoff base/cap (5 / 300)
  VPROXY_TPU_FAILPOINTS=spec             arm failpoints at boot
"""
from __future__ import annotations

import os
import signal
import sys
import threading

from .control import persist
from .control.app import Application
from .control.command import CmdError, Command
from .control.http_controller import HttpController
from .control.resp import RESPController

DEFAULT_RESP = ("127.0.0.1", 16309)
DEFAULT_HTTP = ("127.0.0.1", 18776)


def _addr(s: str):
    h, _, p = s.rpartition(":")
    return h or "127.0.0.1", int(p)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    # beforeStart parity (Main.java:64-107): the OOM survival reserve
    # comes first, covering the deployable apps below too
    from .utils.oom import install as install_oom
    install_oom()

    # a reference backend not ported yet is refused, never served by
    # another
    from .rules.engine import default_backend
    try:
        default_backend()
    except ValueError as e:
        print(f"vproxy_tpu_torch: {e}", file=sys.stderr)
        return 1
    # the serving device: the card, unless the caller asked for the host
    if os.environ.get("VPROXY_TPU_MATCHER") != "host":
        from .utils.torchenv import default_device
        try:
            default_device()
        except RuntimeError as e:
            print(f"vproxy_tpu_torch: {e}", file=sys.stderr)
            return 1
    if os.environ.get("VPROXY_TPU_CLUSTER_PEERS"):
        print("VPROXY_TPU_CLUSTER_PEERS: the cluster plane is not ported "
              "yet (ROADMAP Queue A item 8)", file=sys.stderr)
        return 1

    # deployable apps (reference -Deploy=...): first arg selects the app
    if argv and argv[0].lower() in ("helloworld", "daemon", "kcptun",
                                    "websocks"):
        print(f"{argv[0].lower()}: not ported yet (ROADMAP Queue A "
              "item 10)", file=sys.stderr)
        return 1
    if argv and argv[0].lower() == "simple":
        from .apps import simple
        return simple.run(argv[1:])
    opts = {"resp": DEFAULT_RESP, "resp_pass": None, "http": DEFAULT_HTTP,
            "load": None, "no_load": False, "no_save": False,
            "no_stdio": False, "workers": None, "inspect": None}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "resp-controller":
            opts["resp"] = _addr(argv[i + 1])
            opts["resp_pass"] = argv[i + 2]
            i += 3
        elif a == "http-controller":
            opts["http"] = _addr(argv[i + 1])
            i += 2
        elif a == "load":
            opts["load"] = argv[i + 1]
            i += 2
        elif a == "noLoadLast":
            opts["no_load"] = True
            i += 1
        elif a == "noSave":
            opts["no_save"] = True
            i += 1
        elif a == "noStdIOController":
            opts["no_stdio"] = True
            i += 1
        elif a == "workers":
            opts["workers"] = int(argv[i + 1])
            i += 2
        elif a == "globalInspection":
            opts["inspect"] = _addr(argv[i + 1])
            i += 2
        elif a in ("allowSystemCommandInNonStdIOController", "noStartupBindCheck"):
            i += 1
        elif a in ("version", "-version", "--version"):
            print("vproxy-tpu 0.1.0")
            return 0
        else:
            print(f"unknown argument {a!r}", file=sys.stderr)
            return 1

    app = Application.create(workers=opts["workers"])
    try:
        resp = RESPController(app, opts["resp"][0], opts["resp"][1],
                              password=opts["resp_pass"])
        resp.start()
        http = HttpController(app, opts["http"][0], opts["http"][1])
        http.start()
    except OSError as e:
        print(f"failed to start controllers: {e}", file=sys.stderr)
        app.close()
        return 1
    print(f"resp-controller on {opts['resp'][0]}:{resp.bind_port}")
    print(f"http-controller on {opts['http'][0]}:{http.bind_port}")

    if opts["inspect"] is not None:
        from .utils.metrics import launch_inspection_http
        try:
            gi_srv = launch_inspection_http(
                app.control_loop, opts["inspect"][0], opts["inspect"][1])
        except OSError as e:
            print(f"failed to start global-inspection: {e}",
                  file=sys.stderr)
            app.close()
            return 1
        print(f"global-inspection on {opts['inspect'][0]}:{gi_srv.port}")

    if opts["load"]:
        n = persist.load(app, opts["load"])
        print(f"loaded {n} commands from {opts['load']}")
    elif not opts["no_load"] and os.path.exists(persist.LAST_CONFIG):
        n = persist.load(app)
        print(f"loaded {n} commands from {persist.LAST_CONFIG}")

    stop = threading.Event()
    want_drain = threading.Event()  # SIGTERM/`drain`: graceful window

    # the handlers only set events: file I/O (or any lock) inside a
    # Python signal-handler frame can re-enter mid-bytecode — the save
    # now runs on the main thread after stop.wait(), post-drain
    def on_signal(signum, frame):
        if signum == signal.SIGTERM:
            want_drain.set()
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    if hasattr(signal, "SIGUSR2"):
        # the handler only sets an event (run_on_loop would take a
        # non-reentrant lock inside the signal frame); a dedicated
        # daemon thread does the actual save
        want_save = threading.Event()

        def usr2_saver() -> None:
            while True:
                want_save.wait()
                want_save.clear()
                if stop.is_set():
                    return
                try:
                    persist.save(app)
                except OSError as e:
                    print(f"save failed: {e}", file=sys.stderr)

        threading.Thread(target=usr2_saver, daemon=True,
                         name="usr2-save").start()
        signal.signal(signal.SIGUSR2, lambda s, f: want_save.set())

    # the `drain` operator command funnels to the same exit path
    app.on_drain_request.append(lambda: (want_drain.set(), stop.set()))

    if not opts["no_save"]:
        persist.start_auto_save(app)

    from .components.updater import ServerAddressUpdater
    updater = ServerAddressUpdater(lambda: app.server_groups.values())
    updater.start()

    if not opts["no_stdio"]:
        def repl() -> None:
            for line in sys.stdin:
                line = line.strip()
                if not line:
                    continue
                if line in ("exit", "quit", "System: exit"):
                    on_signal(None, None)
                    return
                try:
                    result = Command.execute(app, line)
                    if isinstance(result, list):
                        for j, item in enumerate(result):
                            print(f"{j + 1}) {item!r}")
                    else:
                        print(f"{result!r}")
                except CmdError as e:
                    print(f"error: {e}")
            on_signal(None, None)
        threading.Thread(target=repl, daemon=True, name="stdio").start()

    stop.wait()
    if want_drain.is_set():
        # graceful drain (SIGTERM / `drain`): listeners close, /healthz
        # flips to draining, pumps finish within VPROXY_TPU_DRAIN_S
        drain_s = float(os.environ.get("VPROXY_TPU_DRAIN_S", "15"))
        app.request_drain()  # no-op if the drain command already ran
        done = app.drain_wait(drain_s)
        print("drained cleanly" if done
              else f"drain window ({drain_s:.0f}s) closed; exiting",
              file=sys.stderr)
    if not opts["no_save"]:
        try:
            persist.save(app)
        except OSError as e:
            print(f"save failed: {e}", file=sys.stderr)
    updater.close()
    app.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
