"""Deployments: one module per configuration `kind`, found by that name.

A module exposes `build(cfg) -> Deployment`, its tables drawn from the
configuration's own `table_seed`. A Deployment holds the
plain data it was built from (portbench/gen.py), the program's objects
built from it, and an `Entry` per entry point of the program that a
traffic mix may drive. Everything the program is asked goes through an
entry; everything the reference is asked goes through `Deployment.
reference()`, which reads only the plain data.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class Entry:
    """One entry point of the program.

    submit(payload, done, loop): queue one query; done(answer) fires on
    `loop` with the answer in plain form (an int, a tuple or a bool).
    payload(q): the program's query object for plain query q.
    matcher: the object the service batches on (its stats key, its
    dispatch for warming the batch shapes).
    warm(payloads, cap): one device batch of these payloads padded to
    `cap` rows, pulled to the host (set-up's warming of a batch shape).
    """
    name: str
    submit: Callable
    payload: Callable
    matcher: object
    warm: Optional[Callable]


class Deployment:
    entries: dict
    plain: dict  # the plain data, by name

    def pool(self, entry: str, traffic: dict) -> list:
        """The plain queries a mix sends to `entry`, drawn from the mix's
        own `pool_seed`: every run's pool is the same multiset, and the
        run's seed only orders it."""
        raise NotImplementedError

    def reference(self):
        """-> answer(entry, q, control=False): the plain reference's
        answer for plain query q; control=True breaks one guarantee."""
        raise NotImplementedError

    def work(self, entry: str, q) -> tuple:
        """(bytes, int ops) any implementation needs for plain query q
        on its entry's kernel: the query read once, its answer written
        once, and the per-byte hashing and comparing it cannot skip."""
        raise NotImplementedError
