"""`python -m vproxy_tpu_torch`: the port's process entry (main.py).

The port's copy of vproxy_tpu/__main__.py, behind a __main__ guard so
that importing the module runs nothing."""
import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main())
