"""vlint loop-affinity fixture: callables registered on an event loop
with blocking calls inside — directly, via a nested helper, and via a
lambda — plus non-blocking registrations that must NOT be flagged."""
import queue
import subprocess
import time

work_queue = queue.Queue()


class Component:
    def __init__(self, loop):
        self.loop = loop

    def start(self):
        self.loop.period(1000, self._tick)          # BUG: sleeps
        self.loop.delay(10, lambda: time.sleep(1))  # BUG: lambda sleeps
        self.loop.run_on_loop(self._drain)          # BUG: unbounded get
        self.loop.next_tick(self._rebuild)          # BUG: via helper
        self.loop.delay(20, self._forever)          # BUG: timeout=None
        self.loop.delay(50, self._fine)             # clean
        self.loop.delay(60, self._spawner)          # clean: worker fn

    def _tick(self):
        time.sleep(0.5)

    def _drain(self):
        return work_queue.get()

    def _rebuild(self):
        self._compile()

    def _compile(self):
        subprocess.run(["true"])

    def _forever(self):
        # timeout=None is NOT a bound — it blocks forever
        work_queue.get(timeout=None)

    def _fine(self):
        work_queue.get(timeout=0.1)
        work_queue.get(False)

    def _spawner(self):
        # a sleeping fn DEFINED here but never called on the loop
        # (handed to a worker thread) must not be attributed to the
        # callback — the nested-def subtree is a separate callable
        def worker():
            time.sleep(5)
            subprocess.run(["true"])
        return worker
