"""portbench: the benchmark of the vproxy_tpu_torch port (see README.md)."""
