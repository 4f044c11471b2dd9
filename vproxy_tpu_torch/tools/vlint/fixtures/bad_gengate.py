"""vlint generation-gate fixture: FlowTable mirrors the guarded-store
idiom (a _bump gate over a compiled-state source of truth) with one
mutation path that skips the gate — the exact bug class the pass
exists for. tests/test_vlint.py runs the pass with a Guard spec
pointing here and asserts exactly the ungated path is flagged."""


class FlowTable:
    def __init__(self):
        self.version = 0
        self.on_change = None
        self._e = {}

    def _bump(self):
        self.version += 1
        if self.on_change is not None:
            self.on_change()

    def record(self, k, v):
        self._e[k] = v
        self._bump()

    def remove(self, k):
        self._e.pop(k, None)
        self._bump()

    def remove_silently(self, k):
        # BUG (seeded): mutation with no gate on any path
        del self._e[k]

    def _drop(self, k):
        # helper with no in-body gate: legal — every caller gates
        self._e.pop(k, None)

    def expire(self, keys):
        for k in keys:
            self._drop(k)
        self._bump()


class Publisher:
    def __init__(self):
        self._pub = (None, [])

    def _recompile(self):
        self._pub = (object(), [1])

    def hot_patch(self):
        # BUG (seeded): pub-tuple assignment outside the installer
        self._pub = (None, [2])
