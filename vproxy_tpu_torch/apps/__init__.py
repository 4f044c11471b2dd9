"""Deployable apps (reference vproxyx/*): Simple one-liner LB,
HelloWorld smoke test, Daemon supervisor, KcpTun tunnel, and the
WebSocks server and agent.

The port's copies of vproxy_tpu/apps/, each dispatched by main.py as
`python -m vproxy_tpu_torch <app> ...`."""
