"""deliver_handoffs_per_batch (metrics/deliver_handoffs_per_batch.py) in
the cidr cells, where it names device_peak_mb, the end-to-end metric
those cells report (PERF.md §2), as the other .cidr readers do."""
from portbench.spec import metric_reader

read = metric_reader("deliver_handoffs_per_batch")
