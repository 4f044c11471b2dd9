"""vlint clean fixture: the same idioms as the bad fixtures, done
right — every pass must report ZERO findings here (the
no-false-positive contract)."""
import queue

jobs = queue.Queue()


class GatedTable:
    def __init__(self):
        self.version = 0
        self._e = {}

    def _bump(self):
        self.version += 1

    def record(self, k, v):
        self._e[k] = v
        self._bump()

    def _drop(self, k):
        self._e.pop(k, None)  # gated by every caller

    def expire(self, keys):
        for k in keys:
            self._drop(k)
        self._bump()


class CleanPublisher:
    def __init__(self):
        self._pub = (None, [])

    def _recompile(self):
        self._pub = (object(), [1])


class CleanComponent:
    def __init__(self, loop):
        self.loop = loop

    def start(self):
        self.loop.period(1000, self._tick)
        self.loop.delay(10, lambda: jobs.get(False))

    def _tick(self):
        try:
            jobs.get(timeout=0.01)
        except queue.Empty:
            pass


def count(gi):
    gi.get_counter("vproxy_fixture_registered_total").incr()
