"""The port's SelectorEventLoop.run_batch_on_loop: a list of tasks
handed to a loop with one lock and one wakeup, each task then run alone
through the loop's callback timing, under run_on_loop's contract.

Every wait is bounded.
"""
import threading
import time

import pytest

from vproxy_tpu_torch.net import eventloop as EL
from vproxy_tpu_torch.net.eventloop import SelectorEventLoop


@pytest.fixture
def loop():
    lp = SelectorEventLoop("batch-test")
    lp.loop_thread()
    yield lp
    lp.close()


class _CountingLib:
    """vtl.LIB with its wakeups counted per native loop."""

    def __init__(self, lib):
        self._lib = lib
        self.wakeups = {}

    def vtl_wakeup(self, lp):
        self.wakeups[lp] = self.wakeups.get(lp, 0) + 1
        return self._lib.vtl_wakeup(lp)

    def __getattr__(self, name):
        return getattr(self._lib, name)


def _block(lp):
    """Park `lp`'s thread in a task; -> the event that releases it."""
    entered, release = threading.Event(), threading.Event()

    def park():
        entered.set()
        release.wait(10)
    assert lp.run_on_loop(park)
    assert entered.wait(5)
    return release


def test_runs_every_task_once_in_order_with_one_wakeup(loop, monkeypatch):
    lib = _CountingLib(EL.vtl.LIB)
    monkeypatch.setattr(EL.vtl, "LIB", lib)
    release = _block(loop)
    ran, done = [], threading.Event()
    tasks = [lambda i=i: ran.append(i) for i in range(500)]
    tasks.append(done.set)
    n0 = lib.wakeups.get(loop._lp, 0)
    assert loop.run_batch_on_loop(tasks) is True
    assert lib.wakeups.get(loop._lp, 0) - n0 == 1
    assert ran == []  # queued behind the parked task
    release.set()
    assert done.wait(5)
    assert ran == list(range(500))


def test_a_raising_task_does_not_stop_the_rest(loop, capsys):
    ran, done = [], threading.Event()

    def boom():
        raise ValueError("task failed")
    tasks = [lambda: ran.append(0), boom, lambda: ran.append(2), boom,
             lambda: ran.append(4), done.set]
    assert loop.run_batch_on_loop(tasks)
    assert done.wait(5)
    assert ran == [0, 2, 4]
    assert "task failed" in capsys.readouterr().err


def test_each_task_is_timed_alone(loop):
    """1,000 tasks of ~0.2 ms: together far past the loop's 1 ms stall
    floor, each alone under it, so the stall evidence the overload guard
    diffs grows by single tasks' overshoot (a preempted task's), far
    from the whole batch's run that one timed task would add, and the
    longest callback is one task, not the batch."""
    release = _block(loop)
    done = threading.Event()
    base = []

    def baseline():
        # on the loop thread, once the parked task's own run is counted
        base.append(loop.stall_total_s)
        loop.take_health("cb")
        base.append(time.monotonic())
    tasks = [baseline] + [_spin_200us for _ in range(1000)]
    tasks.append(done.set)
    assert loop.run_batch_on_loop(tasks)
    release.set()
    assert done.wait(30)
    s0, t0 = base
    took = time.monotonic() - t0
    assert took >= 0.2
    assert loop.stall_total_s - s0 < took / 4
    assert loop.take_health("cb") < 0.05


def _spin_200us():
    t = time.perf_counter() + 0.0002
    while time.perf_counter() < t:
        pass


def test_a_closed_loop_refuses_and_runs_nothing():
    lp = SelectorEventLoop("batch-closed")
    lp.loop_thread()
    lp.close()
    ran = []
    assert lp.run_batch_on_loop([lambda: ran.append(1)] * 3) is False
    assert lp.run_on_loop(lambda: ran.append(2)) is False
    time.sleep(0.05)
    assert ran == []


def test_on_the_loop_thread_it_goes_to_next_tick(loop):
    seen, done = {}, threading.Event()
    ran = []

    def task():
        xq, tq = len(loop._xq), len(loop._tick_q)
        assert loop.run_batch_on_loop([lambda: ran.append("a"),
                                       lambda: ran.append("b"),
                                       done.set])
        seen["xq"] = len(loop._xq) - xq
        seen["tick"] = len(loop._tick_q) - tq
        seen["ran"] = list(ran)
    assert loop.run_on_loop(task)
    assert done.wait(5)
    assert seen == {"xq": 0, "tick": 3, "ran": []}
    assert ran == ["a", "b"]


def test_tasks_that_raced_close_still_run():
    """True means every task will run: a batch queued while the loop's
    thread is parked, then closed under it, has run once close()
    returns."""
    lp = SelectorEventLoop("batch-race")
    lp.loop_thread()
    release = _block(lp)
    ran = []
    assert lp.run_batch_on_loop([lambda i=i: ran.append(i)
                                 for i in range(5)])
    threading.Timer(0.2, release.set).start()
    lp.close()
    assert ran == list(range(5))
    assert lp.run_batch_on_loop([lambda: ran.append(9)]) is False
    assert ran == list(range(5))
