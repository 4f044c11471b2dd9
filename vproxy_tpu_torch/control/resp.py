"""RESPController — redis-protocol control server (works with redis-cli).

Parity: app controller/RESPController.java (+ base redis/RESPParser.java):
accepts RESP arrays or inline commands, optional AUTH password, joins
tokens into one command line and runs it through the command engine on
the control loop; replies with simple-string/bulk/array/error frames.

The port's copy of vproxy_tpu/control/resp.py, same names and behaviour.
"""
from __future__ import annotations

from typing import Optional

from ..net.connection import Connection, Handler, ServerSock
from ..net.eventloop import SelectorEventLoop
from .app import Application
from .command import CmdError, Command


def enc_resp(result) -> bytes:
    if result is None:
        return b"+OK\r\n"
    if isinstance(result, str):
        if result == "OK":
            return b"+OK\r\n"
        data = result.encode()
        return b"$%d\r\n%s\r\n" % (len(data), data)
    if isinstance(result, list):
        out = b"*%d\r\n" % len(result)
        for item in result:
            data = str(item).encode()
            out += b"$%d\r\n%s\r\n" % (len(data), data)
        return out
    data = str(result).encode()
    return b"$%d\r\n%s\r\n" % (len(data), data)


def enc_err(msg: str) -> bytes:
    return b"-ERR %s\r\n" % msg.replace("\r", " ").replace("\n", " ").encode()


class _RespConn(Handler):
    def __init__(self, ctl: "RESPController", conn: Connection):
        self.ctl = ctl
        self.conn = conn
        self.buf = bytearray()
        self.authed = ctl.password is None
        conn.set_handler(self)

    # ------------------------------------------------------------ parsing

    def _try_parse(self) -> Optional[list[str]]:
        """One request: RESP array of bulk strings, or inline line."""
        if not self.buf:
            return None
        if self.buf[0:1] != b"*":
            nl = self.buf.find(b"\r\n")
            if nl < 0:
                nl = self.buf.find(b"\n")
                if nl < 0:
                    return None
                line = bytes(self.buf[:nl])
                del self.buf[:nl + 1]
            else:
                line = bytes(self.buf[:nl])
                del self.buf[:nl + 2]
            return line.decode("latin-1").split()
        # array of bulk strings
        pos = 0
        nl = self.buf.find(b"\r\n", pos)
        if nl < 0:
            return None
        raw_n = bytes(self.buf[1:nl])
        if not raw_n.isdigit():  # same strictness as the bulk lengths
            raise CmdError("bad RESP array header")
        n = int(raw_n)
        pos = nl + 2
        items = []
        for _ in range(n):
            if pos >= len(self.buf) or self.buf[pos:pos + 1] != b"$":
                if pos >= len(self.buf):
                    return None
                raise CmdError("expected bulk string")
            nl = self.buf.find(b"\r\n", pos)
            if nl < 0:
                return None
            raw_ln = bytes(self.buf[pos + 1:nl])
            if not raw_ln.isdigit():  # strict digits: no '+5', '1_6'
                raise CmdError("bad bulk string length")
            ln = int(raw_ln)
            start = nl + 2
            if len(self.buf) < start + ln + 2:
                return None
            items.append(bytes(self.buf[start:start + ln]).decode("latin-1"))
            pos = start + ln + 2
        del self.buf[:pos]
        return items

    # ------------------------------------------------------------- logic

    MAX_BUF = 1 << 20  # one request; a control command never nears this

    def on_data(self, conn: Connection, data: bytes) -> None:
        self.buf += data
        if len(self.buf) > self.MAX_BUF:
            # unauthenticated clients must not balloon controller memory
            # with a huge bulk length or an endless unterminated line
            conn.write(enc_err("request too large"))
            conn.close_draining()
            return
        while True:
            try:
                toks = self._try_parse()
            except CmdError as e:
                # protocol error: no resync possible mid-stream — reply,
                # half-close, and drain (a hard close while the peer is
                # still sending turns into a RST that eats the -ERR)
                conn.write(enc_err(str(e)))
                conn.close_draining()
                return
            if toks is None:
                return
            if not toks:
                continue
            self._dispatch(conn, toks)

    def _dispatch(self, conn: Connection, toks: list[str]) -> None:
        cmd0 = toks[0].lower()
        if cmd0 == "auth":
            if len(toks) != 2:
                conn.write(enc_err("wrong number of arguments for 'auth'"))
                return
            if self.ctl.password is not None and toks[1] == self.ctl.password:
                self.authed = True
                conn.write(b"+OK\r\n")
            else:
                conn.write(enc_err("invalid password"))
            return
        if cmd0 == "ping":
            conn.write(b"+PONG\r\n")
            return
        if cmd0 == "quit":
            conn.write(b"+OK\r\n")
            conn.close()
            return
        if not self.authed:
            conn.write(enc_err("NOAUTH Authentication required"))
            return
        line = " ".join(toks)
        try:
            result = Command.execute(self.ctl.app, line)
            conn.write(enc_resp(result))
        except CmdError as e:
            conn.write(enc_err(str(e)))
        except Exception as e:  # surface internal errors to the operator
            conn.write(enc_err(f"{type(e).__name__}: {e}"))


class RESPController:
    def __init__(self, app: Application, bind_ip: str, bind_port: int,
                 password: Optional[str] = None,
                 loop: Optional[SelectorEventLoop] = None):
        self.app = app
        self.password = password
        self.loop = loop or app.control_loop
        self.bind_ip, self.bind_port = bind_ip, bind_port
        self._srv: Optional[ServerSock] = None

    def start(self) -> None:
        def mk() -> None:
            self._srv = ServerSock(self.loop, self.bind_ip, self.bind_port,
                                   self._on_accept)
            self.bind_port = self._srv.port
        self.loop.call_sync(mk)

    def _on_accept(self, fd: int, ip: str, port: int) -> None:
        _RespConn(self, Connection(self.loop, fd, (ip, port)))

    def stop(self) -> None:
        if self._srv is not None:
            srv = self._srv
            self._srv = None
            self.loop.run_on_loop(srv.close)
