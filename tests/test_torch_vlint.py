"""vlint over the port: tests/test_vlint.py's 11 cases against the
port's analyzer (vproxy_tpu_torch/tools/vlint) on the port's tree and
the port's fixtures, plus the fixtures flagged exactly as the
reference's analyzer flags its own, and the registry probe loading no
torch.

Two contracts live here:

* the TREE GATE: running all four passes over the port yields zero
  non-baselined findings (and no stale baseline entries), inside a 10s
  runtime budget;
* the ANALYZER's own correctness: each pass catches its seeded fixture
  violation (vproxy_tpu_torch/tools/vlint/fixtures/) and reports
  nothing on the clean fixture.
"""
import os
import subprocess
import sys
import time

import pytest

from vproxy_tpu_torch.tools import vlint
from vproxy_tpu_torch.tools.vlint import gengate, loopcheck, registry, structs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX_REL = os.path.join("vproxy_tpu_torch", "tools", "vlint", "fixtures")
FIX = os.path.join(ROOT, FIX_REL)


# ------------------------------------------------------------ tree gate

def test_tree_is_clean_and_fast():
    t0 = time.monotonic()
    rep = vlint.run_all(ROOT)
    elapsed = time.monotonic() - t0
    assert not rep.open_findings, \
        "vlint found non-baselined findings:\n" + "\n".join(
            f.format() for f in rep.open_findings)
    assert not rep.stale_baseline, \
        f"stale baseline entries (prune them): {rep.stale_baseline}"
    assert elapsed < 10.0, f"vlint blew the tier-1 budget: {elapsed:.1f}s"


def test_run_all_parses_each_file_once_with_the_findings_of_fresh_parses(
        monkeypatch):
    """run_all's passes share one Trees cache: every file is parsed at
    most once a run, and the findings are those of the four passes
    called on their own, each parsing every file it reads afresh (the
    package's files four times or more)."""
    import ast
    import collections
    parses = collections.Counter()
    real = ast.parse

    def counting(source, filename="<unknown>", *a, **kw):
        parses[filename] += 1
        return real(source, filename, *a, **kw)

    monkeypatch.setattr(ast, "parse", counting)

    def keys(findings):
        return sorted((f.pass_name, f.key, f.path, f.line, f.message)
                      for f in findings)

    cached = vlint.run_all(ROOT)
    once = dict(parses)
    parses.clear()
    fresh = (structs.check_abi(ROOT) + gengate.check_gengate(ROOT)
             + registry.check_registry(ROOT) + loopcheck.check_loops(ROOT))
    assert keys(cached.findings) == keys(fresh) and fresh
    assert not cached.stale_baseline
    assert set(once) == set(parses)
    assert max(once.values()) == 1, [p for p, n in once.items() if n > 1]
    assert parses[os.path.join(ROOT, "vproxy_tpu_torch", "net",
                               "vtl.py")] >= 4


def test_abi_pass_covers_every_shared_record_field_by_field():
    model = structs.shared_model(ROOT)
    assert set(model) == set(structs.SHARED_RECORDS)
    for py_name, (py, c) in model.items():
        assert len(py.fields) == len(c.fields) > 0, py_name
        for pf, cf in zip(py.fields, c.fields):
            assert (pf.name, pf.offset, pf.size, pf.kind) == \
                (cf.name, cf.offset, cf.size, cf.kind), \
                f"{py_name}.{pf.name} drifted from C {c.name}.{cf.name}"
        assert py.size == c.size


# ------------------------------------------------------- pass 1 fixture

def test_abi_fixture_flags_compensating_field_drift():
    cpp = os.path.join(FIX, "bad_abi.cpp")
    pyf = os.path.join(FIX, "bad_abi_vtl.py")
    bad = structs.check_abi(ROOT, records={"BAD_REC": "BadRec"},
                            cpp_path=cpp, py_path=pyf)
    keys = {f.key for f in bad}
    # total sizes AGREE (14B both sides) — only the field-level pass
    # can see the drift; it must flag the renamed u16 and the
    # u32-vs-bytes swap, and must NOT report a total-size mismatch
    assert "abi:BAD_REC:flags" in keys
    assert "abi:BAD_REC:tag" in keys
    assert "abi:BAD_REC:size" not in keys
    clean = structs.check_abi(ROOT, records={"CLEAN_REC": "CleanRec"},
                              cpp_path=cpp, py_path=pyf)
    assert clean == []


# ------------------------------------------------------- pass 2 fixture

def _fixture_guards():
    rel = os.path.join(FIX_REL, "bad_gengate.py")
    return [
        gengate.Guard(rel, "FlowTable", attrs=frozenset({"_e"}),
                      gates=frozenset({"_bump"})),
        gengate.Guard(rel, "Publisher", attrs=frozenset({"_pub"}),
                      only_in=frozenset({"__init__", "_recompile"})),
    ]


def test_gengate_fixture_flags_exactly_the_ungated_paths():
    found = gengate.check_gengate(ROOT, guards=_fixture_guards())
    keys = {f.key for f in found}
    assert "gengate:FlowTable.remove_silently:_e" in keys
    assert "gengate:Publisher.hot_patch:_pub" in keys
    # gated paths — including the caller-gated helper and the
    # installer method itself — must not be flagged
    for ok in ("record", "remove", "expire", "_drop", "_bump"):
        assert not any(f".{ok}:" in k for k in keys), keys
    assert not any("._recompile:" in k for k in keys), keys
    assert len(found) == 2, [f.format() for f in found]


# ------------------------------------------------------- pass 3 fixture

def test_metric_fixture_flags_unregistered_family():
    found = registry.check_metrics(
        ROOT, files=[os.path.join(FIX, "bad_metric.py")],
        eager_override={"vproxy_fixture_registered_total"})
    assert [f.key for f in found] == \
        ["metric-unregistered:vproxy_fixture_never_registered_total"]


def test_failpoint_catalog_is_bidirectionally_closed():
    # every SITES entry has a hit() site and every hit() names a site —
    # the orphaned-site / dead-injection classes are empty on the tree
    found = registry.check_failpoints(ROOT)
    open_keys = [f.key for f in found
                 if not f.key.startswith("failpoint-unknown-arm:"
                                         "definitely.not.a.site")]
    assert open_keys == [], open_keys


# ------------------------------------------------------- pass 4 fixture

def test_loop_fixture_flags_blocking_callbacks():
    found = loopcheck.check_loops(
        ROOT, files=[os.path.join(FIX, "bad_loop.py")])
    keys = {f.key for f in found}
    assert any(":_tick:" in k and "time.sleep" in k for k in keys), keys
    assert any(":<lambda>:" in k and "time.sleep" in k
               for k in keys), keys
    assert any(":_drain:" in k and "get" in k for k in keys), keys
    assert any(":_rebuild:" in k and "subprocess.run" in k
               for k in keys), keys
    # timeout=None blocks forever — it is NOT a bound
    assert any(":_forever:" in k and "get" in k for k in keys), keys
    assert not any(":_fine:" in k for k in keys), keys
    # a sleeping fn DEFINED in the callback but only handed to a
    # worker thread must not be attributed to the callback
    assert not any(":_spawner:" in k for k in keys), keys


# ----------------------------------------------------- clean fixture

def test_clean_fixture_has_zero_findings_in_every_pass():
    clean = os.path.join(FIX, "clean.py")
    rel = os.path.join(FIX_REL, "clean.py")
    assert gengate.check_gengate(ROOT, guards=[
        gengate.Guard(rel, "GatedTable", attrs=frozenset({"_e"}),
                      gates=frozenset({"_bump"})),
        gengate.Guard(rel, "CleanPublisher", attrs=frozenset({"_pub"}),
                      only_in=frozenset({"__init__", "_recompile"})),
    ]) == []
    assert registry.check_metrics(
        ROOT, files=[clean],
        eager_override={"vproxy_fixture_registered_total"}) == []
    assert loopcheck.check_loops(ROOT, files=[clean]) == []


# ------------------------------------------------- baseline mechanics

def test_baseline_marks_and_reports_stale(tmp_path):
    bl = tmp_path / "baseline.toml"
    bl.write_text(
        '[[finding]]\npass = "abi"\nkey = "abi:X:f"\n'
        'reason = "known"\n'
        '[[finding]]\npass = "abi"\nkey = "abi:GONE:f"\n'
        'reason = "fixed long ago"\n')
    entries = vlint.parse_baseline(str(bl))
    assert len(entries) == 2
    f = vlint.Finding("abi", "abi:X:f", "p", 1, "m")
    stale = vlint.apply_baseline([f], entries)
    assert f.baselined and f.baseline_reason == "known"
    assert stale == ["abi:GONE:f"]


def test_baseline_rejects_malformed_entries(tmp_path):
    bl = tmp_path / "baseline.toml"
    bl.write_text('[[finding]]\nkey = "k"\n')  # no reason
    with pytest.raises(ValueError):
        vlint.parse_baseline(str(bl))
    bl.write_text("[[finding]]\nkey = unquoted\n")
    with pytest.raises(ValueError):
        vlint.parse_baseline(str(bl))


def test_snapshot_row_shape():
    rep = vlint.run_all(ROOT)
    snap = vlint.snapshot(rep)
    assert set(snap) == {"findings_by_pass", "findings_total",
                         "baselined", "open", "stale_baseline",
                         "elapsed_s"}
    assert snap["open"] == 0


# ------------------------------------------------ the port's own checks

def test_cli_exits_clean_on_the_port_tree():
    r = subprocess.run([sys.executable, "-m", "vproxy_tpu_torch.tools.vlint"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "0 open" in r.stdout and "0 stale baseline" in r.stdout


def test_registry_probe_imports_the_port_and_no_torch():
    """The eager-registry probe imports the port's metrics modules in a
    fresh interpreter: they load no torch (no CUDA state a card would
    have to hold) and none of the reference."""
    code = (registry._EAGER_PROBE % (registry.REGISTRY_MODULES,)) + (
        "\nbad = [m for m in sys.modules if m == 'torch' or "
        "m.startswith(('torch.', 'jax')) or m.split('.')[0] == "
        "'vproxy_tpu']\nassert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=60,
                       env={**os.environ, "VPROXY_TPU_FD_PROVIDER": "py"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "vproxy_engine_generation" in r.stdout.split()


def test_fixtures_flag_as_the_reference_flags_its_own():
    """Every pass gives the same finding keys on the port's fixtures as
    the reference's analyzer on its fixtures (loop keys carry the
    fixture's root-relative path)."""
    from tools.vlint import gengate as rgen
    from tools.vlint import loopcheck as rloop
    from tools.vlint import registry as rreg
    from tools.vlint import structs as rstructs
    ref_fix = os.path.join(ROOT, "tools", "vlint", "fixtures")

    def keys(found, strip=""):
        return sorted(f.key.replace(strip, "") for f in found)

    for rec in ({"BAD_REC": "BadRec"}, {"CLEAN_REC": "CleanRec"}):
        assert keys(structs.check_abi(
            ROOT, records=rec, cpp_path=os.path.join(FIX, "bad_abi.cpp"),
            py_path=os.path.join(FIX, "bad_abi_vtl.py"))) == keys(
            rstructs.check_abi(ROOT, records=rec,
                               cpp_path=os.path.join(ref_fix, "bad_abi.cpp"),
                               py_path=os.path.join(ref_fix,
                                                    "bad_abi_vtl.py")))
    specs = {"bad_gengate.py": (("FlowTable", "_e", "_bump", None),
                                ("Publisher", "_pub", None, True)),
             "clean.py": (("GatedTable", "_e", "_bump", None),
                          ("CleanPublisher", "_pub", None, True))}
    for name, spec in specs.items():
        def guards(mod_, rel):
            return [mod_.Guard(
                rel, cls, attrs=frozenset({attr}),
                gates=frozenset({gate}) if gate else frozenset(),
                only_in=frozenset({"__init__", "_recompile"})
                if only else None) for cls, attr, gate, only in spec]
        ours = gengate.check_gengate(
            ROOT, guards=guards(gengate, os.path.join(FIX_REL, name)))
        ref = rgen.check_gengate(ROOT, guards=guards(
            rgen, os.path.join("tools", "vlint", "fixtures", name)))
        assert keys(ours) == keys(ref) and (ours or name == "clean.py")
    for name in ("bad_metric.py", "clean.py"):
        eager = {"vproxy_fixture_registered_total"}
        assert keys(registry.check_metrics(
            ROOT, files=[os.path.join(FIX, name)], eager_override=eager)) \
            == keys(rreg.check_metrics(
                ROOT, files=[os.path.join(ref_fix, name)],
                eager_override=eager))
    for name in ("bad_loop.py", "clean.py"):
        ours = keys(loopcheck.check_loops(
            ROOT, files=[os.path.join(FIX, name)]), FIX_REL)
        ref = keys(rloop.check_loops(
            ROOT, files=[os.path.join(ref_fix, name)]),
            os.path.join("tools", "vlint", "fixtures"))
        assert ours == ref and (ours or name == "clean.py")
