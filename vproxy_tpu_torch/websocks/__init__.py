"""The port's copy of vproxy_tpu/websocks/__init__.py, same names and behaviour."""
