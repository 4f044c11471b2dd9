"""Deployable apps (reference vproxyx/*).

The port carries Simple mode (apps/simple.py, the one-liner LB). The
reference's HelloWorld, Daemon, KcpTun and WebSocks apps come with
ROADMAP Queue A item 10; main.py refuses them until then."""
