"""Guardian — the sketch-driven admission & policing plane.

The analytics plane gives every plane a NAME for its heavy hitters (10s
Space-Saving windows); the workload capture can replay a recorded crowd
at 2x. This package is what
finally ACTS on both: operator-declared policies compile the top-K
tables into O(1) enforcement state — per-key token buckets consulted at
accept time in the C lanes (POLICE_REC ABI), mirrored on the python
accept path, biased into the AIMD overload shed order (weighted-fair,
deficit-round-robin over tenant weights), and answered as REFUSED for
quarantined qnames in the DNS server.

Call sites import the engine module (`from ..policing import engine as
policing`) — the module-level default engine serves the hot paths; the
class exists so tests can run N independent nodes in one process.

The port's copy of vproxy_tpu/policing/__init__.py, same names and behaviour.
"""
from . import engine  # noqa: F401
