"""A whole run on the CPU, the card's look skipped, at a size a test can
hold: sound, it reads correct; with the control in the program's place,
or with the timed path broken underneath (an answer altered where the
batch's result is pulled; half of every batch never answered), it reads
not correct. Each cell's own configuration, cut in rules and clients."""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2 ** 31 + 4242


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "cpu")


def _run(name: str, control: bool = False) -> dict:
    sp = spec.benchmark()
    cell = spec.cell(sp, name)
    cfg = spec.config(sp, cell["config"])
    mix = spec.traffic(cell["traffic"])
    if cfg["kind"] == "hint_maglev":
        cfg.update(rules=2000, backends=32, maglev_m=4099)
    else:
        cfg.update(routes=2000, acl_rules=200)
    mix.update(clients=min(mix["clients"], 128), pool=2048, warmup_s=0.3,
               check_sample=256)
    return run.run_cell(cell, cfg, mix, SEED, 1.0, False,
                        spec.metrics_for(sp, name, "end_to_end"),
                        control=control)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    res = _run(name, control=True)
    assert not res["correct"]
    assert res["checks"]["mismatches"]["value"] > 0


def _altered(arr):
    """An answer altered where it is produced: the first row of every
    batch's result moved by one (pick, verdict or first match)."""
    from vproxy_tpu_torch.utils.torchenv import to_host
    out = np.array(to_host(arr), copy=True)
    out[0] = out[0] + 1
    return out


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_not_correct(name, monkeypatch):
    from vproxy_tpu_torch.rules import service
    monkeypatch.setattr(service, "_pull", _altered)
    res = _run(name)
    assert not res["correct"]
    assert res["checks"]["mismatches"]["value"] + \
        res["checks"]["inconsistent"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_half_of_each_batch_left_out_is_not_correct(name, monkeypatch):
    from vproxy_tpu_torch.rules.service import ClassifyService
    deliver = ClassifyService._deliver

    def half(self, reqs, idxs, payload=None, kind="hint"):
        k = (len(reqs) + 1) // 2
        deliver(self, reqs[:k], list(idxs)[:k], payload, kind)
    monkeypatch.setattr(ClassifyService, "_deliver", half)
    res = _run(name)
    assert not res["correct"] and res["failed"] > 0
    assert res["checks"]["unanswered"]["value"] > 0


def test_no_card_no_result(tmp_path):
    """run.py on a machine with no card: a non-zero exit, no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, os.path.join(spec.HERE, "run.py"),
                        "--workload", CELLS[0], "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=spec.ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    """One short run of the first cell on the card: correct, on a gpu."""
    r = subprocess.run([sys.executable, os.path.join(spec.HERE, "run.py"),
                        "--workload", CELLS[0], "--seed", str(SEED),
                        "--seconds", "2", "--trace", "0"], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    import json
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
