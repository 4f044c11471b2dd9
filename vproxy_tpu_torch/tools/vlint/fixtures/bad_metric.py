"""vlint registry fixture: an increment site referencing a family no
registry ever eagerly creates — invisible on /metrics until the first
event fires (exactly when drop dashboards need the zero)."""


def count_drop(gi):
    gi.get_counter("vproxy_fixture_never_registered_total").incr()


def count_ok(gi):
    gi.get_counter("vproxy_fixture_registered_total").incr()
