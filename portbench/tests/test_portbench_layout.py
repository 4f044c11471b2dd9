"""BENCHMARK.json and the files it names: every configuration, traffic
mix and per-layer metric is one file, found by its name; no module under
portbench/ imports JAX or the JAX package; the reference imports nothing
of the program. Imports are compared by whole top-level names, since
vproxy_tpu_torch begins with vproxy_tpu."""
from __future__ import annotations

import ast
import json
import os
import re

import pytest

from portbench import spec

PB = spec.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BANNED = {"jax", "jaxlib", "flax", "vproxy_tpu"}


def _modules():
    for d, _dirs, files in os.walk(PB):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path: str) -> set:
    """Top-level names of every module the file imports (any depth)."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for path in _modules():
        assert not _imports(path) & BANNED, path


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(PB, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            got = _imports(os.path.join(ref, f))
            assert "vproxy_tpu_torch" not in got and not got & BANNED, f


def test_top_level_names_compare_whole():
    assert "vproxy_tpu_torch".split(".")[0] not in BANNED


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_every_config_and_kind_is_found_by_name(bench):
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"])
        assert cfg["name"] == c["name"]
        assert c["file"].startswith("portbench/configs/")
        assert callable(spec.deploy_module(cfg["kind"]).build)
        assert set(cfg["reduced"]) == set(c["reduced"])


def test_every_mix_is_found_by_name(bench):
    for w in bench["workloads"]:
        mix = spec.traffic(w["traffic"])
        assert mix["name"] == w["traffic"]
        dep = spec.deploy_module(spec.config(bench, w["config"])["kind"])
        assert mix["entries"]
        assert dep is not None


def test_every_per_layer_metric_is_found_by_name(bench):
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:  # each of its cells reports what it moves
            assert m["moves"] in {x["name"] for x in spec.metrics_for(
                bench, w, "end_to_end")}, (m["name"], w)
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])
        assert len(spec.metrics_for(bench, w["name"], "end_to_end")) >= 2
    assert len(json.dumps(bench)) < 64 << 10
