"""device_idle_share (metrics/device_idle_share.py) in the cidr cells,
whose runs spread too widely for lookups/s to be held end to end: there
it names device_peak_mb, the end-to-end metric those cells report
(PERF.md §2)."""
from portbench.spec import metric_reader

read = metric_reader("device_idle_share")
