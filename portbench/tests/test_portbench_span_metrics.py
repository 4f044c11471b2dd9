"""The readers of the dispatcher's batch-cycle spans (submit, encode,
flow_slots, upload, deliver, callback_wait, dispatcher_idle, cpu_ns):
each reads a known value from a synthetic span list, None from a run
with no spans, and None (without raising) from the spans of a program
that records only queue_wait, dispatch, launch and d2h_sync. Each
`.cidr` reader reads what its plain reader reads."""
from __future__ import annotations

import pytest

from portbench import spec


def _sp(span, t_ns, dur_ns, **f):
    return {"trace": 1, "plane": "engine", "span": span, "t_ns": t_ns,
            "dur_ns": dur_ns, **f}


# two batches of the dispatcher (ns): a wait, then dispatch (encode,
# flow_slots, upload inside), the pull, the delivery; a second wait
SPANS = [
    _sp("submit", 0, 4_000, cpu_ns=3_000, kind="cpick"),
    _sp("submit", 10, 8_000, cpu_ns=5_000, kind="cpick"),
    _sp("queue_wait", 0, 1_000_000, kind="cpick"),
    _sp("dispatcher_idle", 1_000_000, 1_000_000, idle_ns=1_000_000,
        waits=1, since_ns=1_000_000),
    _sp("dispatch", 2_000_000, 3_000_000, cpu_ns=1_500_000, kind="cpick",
        batch=1000),
    _sp("encode", 2_000_000, 2_000_000, cpu_ns=1_900_000, batch=1000),
    _sp("flow_slots", 4_000_000, 500_000, cpu_ns=500_000, batch=1000),
    _sp("upload", 4_500_000, 300_000, cpu_ns=300_000, copies=14,
        bytes=7232),
    _sp("launch", 4_800_000, 0, kind="cpick", fused=True),
    _sp("d2h_sync", 5_000_000, 200_000, cpu_ns=100_000, batch=1000),
    _sp("deliver", 5_200_000, 4_000_000, cpu_ns=1_000_000, kind="cpick",
        batch=2000),
    _sp("dispatcher_idle", 9_200_000, 800_000, idle_ns=800_000, waits=1,
        since_ns=9_200_000),
    _sp("callback_wait", 6_000_000, 2_000_000, kind="cpick"),
    _sp("callback_wait", 6_100_000, 4_000_000, kind="cpick"),
    _sp("callback_wait", 6_200_000, 9_000_000, kind="cpick"),
    _sp("callback", 8_000_000, 5_000, cpu_ns=4_000, kind="cpick"),
]

WANT = {
    "submit_us": 6.0,                        # (4 + 8) / 2 us
    "encode_us_per_query": 2.0,              # 2 ms / 1000
    "flow_slots_us_per_query": 0.5,          # 0.5 ms / 1000
    "upload_us_per_batch": 300.0,
    "deliver_us_per_query": 2.0,             # 4 ms / 2000
    "callback_wait_p50_ms": 4.0,             # median of 2, 4, 9 ms
    # idle 1.8 ms of the thread's 1 .. 10 ms (queue_wait, submit and the
    # callbacks lie on the loops): 100 x (1 - 1.8 / 9)
    "dispatcher_busy_share": 80.0,
    # cpu 2.5 ms of 7 ms over dispatch and deliver
    "dispatcher_offcpu_share": 100.0 * (1 - 2.5 / 7.0),
}

# what a program that traces only queue_wait, dispatch, launch and
# d2h_sync records: none of the new readers has anything to read
OLD = [{k: v for k, v in s.items() if k != "cpu_ns"} for s in SPANS
       if s["span"] in ("queue_wait", "dispatch", "launch", "d2h_sync")]


def _ctx(spans):
    return {"spans": [dict(s) for s in spans]}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_known_value(name):
    got = spec.metric_reader(name)(_ctx(SPANS))
    assert got == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_none_without_spans(name):
    assert spec.metric_reader(name)(_ctx([])) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_none_on_a_program_without_the_spans(name):
    assert spec.metric_reader(name)(_ctx(OLD)) is None


@pytest.mark.parametrize("name",
                         sorted(set(WANT) - {"flow_slots_us_per_query"}))
def test_cidr_reader_is_the_plain_reader(name):
    cidr = spec.metric_reader(name + ".cidr")
    assert cidr(_ctx(SPANS)) == spec.metric_reader(name)(_ctx(SPANS))
    assert cidr(_ctx([])) is None


def test_each_reader_is_listed_once_per_cell():
    bench = spec.benchmark()
    names = {m["name"]: m for m in bench["per_layer"]}
    for name in WANT:
        for n, cell, moves in ((name, "hint100k.cpick-c4096",
                                "lookups_per_s"),
                               (name + ".cidr", "sg5k-rt50k.cidr-dual-c4096",
                                "device_peak_mb")):
            if n == "flow_slots_us_per_query.cidr":
                assert n not in names  # the cidr cell picks no backend
                continue
            m = names[n]
            assert m["workloads"] == [cell] and m["moves"] == moves
            assert m["source"] == "program_span"


def test_busy_share_counts_the_waits_of_unsampled_batches():
    """Small batches with no sampled query: their waits ride the next
    sampled wake's dispatcher_idle span (`idle_ns`, from `since_ns`),
    and the share counts them over the time from the first of them."""
    spans = [
        # five waits of 1.2 ms from 0 (four woke for unsampled batches);
        # this span is the last of them
        _sp("dispatcher_idle", 9_000_000, 1_200_000, idle_ns=6_000_000,
            waits=5, since_ns=0),
        _sp("dispatch", 10_200_000, 1_000_000, cpu_ns=900_000,
            kind="cpick", batch=8),
        _sp("d2h_sync", 11_200_000, 100_000, cpu_ns=100_000, batch=8),
        _sp("deliver", 11_300_000, 700_000, cpu_ns=600_000, kind="cpick",
            batch=8),
    ]
    for name in ("dispatcher_busy_share", "dispatcher_busy_share.cidr"):
        got = spec.metric_reader(name)(_ctx(spans))
        assert got == pytest.approx(100.0 * (1 - 6.0 / 12.0))
