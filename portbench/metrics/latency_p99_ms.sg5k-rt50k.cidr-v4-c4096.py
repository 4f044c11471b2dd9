"""Nearest-rank p99 of submit -> callback over every query of the traced
run's window, in ms: in sg5k-rt50k.cidr-v4-c4096 the runs' p99 spreads too widely for an
end-to-end bound (PERF.md §2)."""
from portbench.latency import p99_ms as read  # noqa: F401
