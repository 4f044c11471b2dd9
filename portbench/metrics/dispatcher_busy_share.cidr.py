"""dispatcher_busy_share (metrics/dispatcher_busy_share.py) in the cidr cells, where it names
device_peak_mb, the end-to-end metric those cells report (PERF.md §2),
as the other .cidr readers do."""
from portbench.spec import metric_reader

read = metric_reader("dispatcher_busy_share")
