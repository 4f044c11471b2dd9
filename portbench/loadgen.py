"""The closed-loop load: clients on the program's own event loops.

A client stands for an accept waiting on its verdict. It submits one
query, and from that query's callback, on its event loop, the next one,
until the window closes. Client c of an entry's n clients sends that
entry's pool entries c, c + n, c + 2n, ... (mod the pool's size), so the
stream is fixed by the pool and the client count.

Everything a callback records lives on its loop's own `Tally` (one
thread writes it); the harness merges the tallies once the loops have
gone quiet.
"""
from __future__ import annotations

import time
from array import array

INF = float("inf")


class Window:
    """The measured window's bounds on time.monotonic(); both +inf until
    set-up ends, so set-up's queries are neither timed nor counted.
    t_sample: from when a traced run samples its queries' spans."""

    def __init__(self):
        self.t_start = INF
        self.t_end = INF
        self.t_sample = INF

    def open(self, seconds: float) -> None:
        t = time.monotonic()
        self.t_end = t + seconds
        self.t_start = t


class Tally:
    """One event loop's record."""

    def __init__(self):
        self.lat = array("d")      # seconds, queries submitted in the window
        self.done_in_window = 0    # answers delivered inside the window
        self.submitted = 0         # queries submitted inside the window
        self.idle = 0              # clients that stopped after the close
        self.errors = 0            # submits the program refused
        self.keys = []             # (entry, pool index) of each answer
        self.answers = []          # each answer, in the order they came
        self.tids = []             # trace ids bound around sampled submits


class Client:
    __slots__ = ("entry", "payloads", "loop", "tally", "win", "pos", "step",
                 "n", "t0", "idx", "sample", "waiting")

    def __init__(self, entry, payloads, loop, tally, win, rank, step, sample):
        self.entry = entry
        self.payloads = payloads
        self.loop = loop
        self.tally = tally
        self.win = win
        self.pos = rank
        self.step = step
        self.n = len(payloads)
        self.t0 = 0.0
        self.idx = 0
        self.sample = sample  # trace.maybe_sample in a traced run, else None
        self.waiting = False

    def send(self) -> None:
        """Submit the next query (on this client's loop)."""
        idx = self.pos % self.n
        self.pos += self.step
        self.idx = idx
        t0 = self.t0 = time.monotonic()
        tal = self.tally
        if t0 >= self.win.t_start:
            tal.submitted += 1
        self.waiting = True
        try:
            if self.sample is not None and t0 >= self.win.t_sample:
                self._send_traced(idx)
            else:
                self.entry.submit(self.payloads[idx], self.done, self.loop)
        except Exception:
            self.waiting = False
            tal.errors += 1
            tal.idle += 1

    def _send_traced(self, idx: int) -> None:
        from vproxy_tpu_torch.utils import trace
        tid = self.sample()
        if tid:
            self.tally.tids.append(tid)
        with trace.bind(tid):
            self.entry.submit(self.payloads[idx], self.done, self.loop)

    def done(self, answer) -> None:
        now = time.monotonic()
        self.waiting = False
        tal, win = self.tally, self.win
        if self.t0 >= win.t_start:
            tal.lat.append(now - self.t0)
        if win.t_start <= now <= win.t_end:
            tal.done_in_window += 1
        tal.keys.append((self.entry.name, self.idx))
        tal.answers.append(answer)
        if now < win.t_end:
            self.send()
        else:
            tal.idle += 1


class ClosedLoop:
    def __init__(self, entries: dict, payloads: dict, plan: list,
                 n_loops: int, win: Window, sample=None):
        """plan: the entry name of each client, in client order."""
        from vproxy_tpu_torch.net.eventloop import SelectorEventLoop
        self.win = win
        self.loops = [SelectorEventLoop(f"portbench-{i}")
                      for i in range(n_loops)]
        self.tallies = [Tally() for _ in self.loops]
        for lp in self.loops:
            lp.loop_thread()
        counts = {e: plan.count(e) for e in set(plan)}
        ranks = dict.fromkeys(counts, 0)
        self.clients = []
        for c, e in enumerate(plan):
            k = c % n_loops
            self.clients.append(Client(entries[e], payloads[e], self.loops[k],
                                       self.tallies[k], win, ranks[e],
                                       counts[e], sample))
            ranks[e] += 1

    def start(self) -> None:
        for cl in self.clients:
            cl.loop.run_on_loop(cl.send)

    def drain(self, timeout: float) -> float:
        """Wait until every client has stopped, at most `timeout` seconds
        past the window's close. -> the time it gave up or finished."""
        limit = self.win.t_end + timeout
        while time.monotonic() < limit:
            if sum(t.idle for t in self.tallies) >= len(self.clients):
                break
            time.sleep(0.01)
        return time.monotonic()

    def waiting(self) -> list:
        """Submit times of the queries still unanswered (after drain)."""
        return [c.t0 for c in self.clients if c.waiting]

    def close(self) -> None:
        for lp in self.loops:
            lp.close()
