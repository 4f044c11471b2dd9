"""Finding a cell's parts by name.

BENCHMARK.json, at the root of the checkout, names each cell's
configuration and traffic mix; a configuration's file names its `kind`.
Each part is a file of its own, found by that name:

* configuration:   the `file` of its BENCHMARK.json entry (JSON);
* deployment kind: portbench/deploy/<kind>.py, `build(cfg, seed)`;
* traffic mix:     portbench/traffic/<traffic>.json;
* per-layer metric: portbench/metrics/<metric name>.py, `read(ctx)`.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", name + ".json"))


def deploy_module(kind: str):
    return importlib.import_module(f"portbench.deploy.{kind}")


def metric_reader(name: str):
    """The `read(ctx)` of portbench/metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    sp = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def metrics_for(spec: dict, workload: str, kind: str) -> list:
    """The metric entries a cell reports: kind "end_to_end" or
    "per_layer", each where its `workloads` (if any) lists the cell."""
    return [m for m in spec[kind]
            if "workloads" not in m or workload in m["workloads"]]
