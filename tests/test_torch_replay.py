"""The port's record-replay engine (vproxy_tpu_torch/tools/replay.py)
against the reference's (tools/replay.py).

* One model JSON, written by the reference's WorkloadModel from a
  capture: the port's build_schedule / schedule_hash give the
  reference's schedule and hash in-process, for several seeds and
  arrival caps, and across processes: `python -m
  vproxy_tpu_torch.tools.replay --hash-only` prints what `tools/
  replay.py --hash-only` prints for the same model and arguments.
* tests/test_workload.py's replay cases on the port: the seeded-Zipf
  fidelity round trip through a port LB and the capacity_row math.
"""
import os
import subprocess
import sys
import time

import pytest

from test_torch_tcplb import _torch_cpu  # noqa: F401
from tools import replay as ref_replay
from vproxy_tpu.utils import workload as ref_workload
from vproxy_tpu_torch.tools import replay
from vproxy_tpu_torch.utils import sketch, workload
from vproxy_tpu_torch.utils.workload import WorkloadModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_windows():
    sketch.reset()
    workload.reset()
    ref_workload.reset()
    yield
    sketch.reset()
    workload.reset()
    ref_workload.reset()


@pytest.fixture
def ref_model_json():
    """A model the reference's WorkloadModel fits from a capture of 30
    accept arrivals, as JSON, with a connection-size distribution and a
    client popularity head put in (a capture through a real LB fills
    them), so every sampling site of the schedule draws."""
    import json
    ref_workload.capture_start()
    for _ in range(30):
        ref_workload.note_arrival("accept")
        time.sleep(0.001)
    ref_workload.capture_stop()
    data = json.loads(ref_workload.WorkloadModel.fit(seed=5).to_json())
    buckets = [0] * 28
    buckets[9], buckets[12], buckets[15] = 40, 25, 5
    data["conn"]["bytes"] = {"count": 70, "sum": 70 * 3000.0,
                             "buckets": buckets}
    data["popularity"]["clients"] = {
        "alpha": 1.2,
        "top": [["127.0.1.10", 50, 0], ["203.0.113.7", 30, 1],
                ["127.0.1.11", 12, 0], ["client-x", 4, 0]]}
    return ref_workload.WorkloadModel(data).to_json()


@pytest.mark.parametrize("seed,max_arrivals", [(5, 60), (8, 60), (5, 400),
                                               (0, 1)])
def test_schedule_and_hash_equal_the_reference(ref_model_json, seed,
                                               max_arrivals):
    ref_m = ref_workload.WorkloadModel.from_json(ref_model_json)
    port_m = WorkloadModel.from_json(ref_model_json)
    want = ref_replay.build_schedule(ref_m, seed, max_arrivals=max_arrivals)
    got = replay.build_schedule(port_m, seed, max_arrivals=max_arrivals)
    assert got == want
    assert replay.schedule_hash(got) == ref_replay.schedule_hash(want)
    assert len(replay.schedule_hash(got)) == 64


def test_hash_only_clis_agree_across_processes(ref_model_json, tmp_path):
    path = tmp_path / "model.json"
    path.write_text(ref_model_json)
    args = ["--model", str(path), "--seed", "5", "--max-arrivals", "60",
            "--hash-only"]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    ref = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "replay.py"), *args],
        capture_output=True, text=True, timeout=120, env=env)
    port = subprocess.run(
        [sys.executable, "-m", "vproxy_tpu_torch.tools.replay", *args],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert ref.returncode == 0, ref.stderr
    assert port.returncode == 0, port.stderr
    local = replay.schedule_hash(replay.build_schedule(
        WorkloadModel.from_json(ref_model_json), 5, max_arrivals=60))
    assert port.stdout.strip() == ref.stdout.strip() == local


def test_replay_fidelity_seeded_zipf():
    """tests/test_workload.py's case on the port: capture a seeded Zipf
    client mix through a real port LB, replay it at 1x, re-capture, and
    hold the twin to top-K identity + rate shape (the tier-1 band
    absorbs CI scheduler noise, as the reference's does)."""
    w = replay.ReplayWorld(alias="wl-fid-src")
    try:
        workload.capture_start()
        mix = replay.drive_zipf_mix(w.lb.bind_port, seed=11, n=120,
                                    clients=6, pace_s=0.015)
        workload.capture_stop()
        model = WorkloadModel.fit(seed=11)
    finally:
        w.close()
    assert mix["fail"] == 0
    assert model.plane_rate("accept") > 0
    assert model.data["popularity"]["clients"]["top"], "sketch saw no mix"
    rep = replay.run_replay(model, seed=11, speed=1.0, max_arrivals=100,
                            fidelity_gate=True, rate_band=(0.75, 1.3))
    assert rep["results"]["fail"] == 0
    assert rep["seed"] == 11 and len(rep["schedule_hash"]) == 64
    fid = rep["fidelity"]
    assert fid["gates"]["topk_identity"]["pass"], fid
    assert fid["gates"]["rate_ratio_lo"]["pass"], fid
    assert fid["gates"]["rate_ratio_hi"]["pass"], fid
    assert rep["pass"], rep["slo"]
    # the report's hash is the schedule actually replayed, and the
    # reference hashes the same model and seed the same
    assert rep["schedule_hash"] == replay.schedule_hash(
        replay.build_schedule(model, 11, max_arrivals=100))
    assert rep["schedule_hash"] == ref_replay.schedule_hash(
        ref_replay.build_schedule(ref_workload.WorkloadModel.from_json(
            model.to_json()), 11, max_arrivals=100))


def test_capacity_row_math():
    workload.capture_start()
    for _ in range(10):
        workload.note_arrival("accept")
    time.sleep(0.01)
    workload.capture_stop()
    m = WorkloadModel.fit()
    row = replay.capacity_row(m, node_capacity_rps=1000.0,
                              users=10_000, peak_factor=2.0)
    assert row["node_capacity_rps"] == 1000.0
    assert row["nodes_needed"] >= 0
    assert row["peak_demand_rps"] == pytest.approx(
        10_000 * row["per_user_rps"] * 2.0, rel=1e-6)
    # zero capacity never divides
    assert replay.capacity_row(m, 0.0)["nodes_needed"] == 0
    # the same row as the reference's for the same model
    ref_m = ref_workload.WorkloadModel.from_json(m.to_json())
    assert row == ref_replay.capacity_row(ref_m, node_capacity_rps=1000.0,
                                          users=10_000, peak_factor=2.0)


def test_replay_without_gpu_raises_unless_cpu_asked(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.delenv("VPROXY_TPU_TORCH_DEVICE", raising=False)
    m = WorkloadModel.fit()
    with pytest.raises(RuntimeError, match="CUDA"):
        replay.run_replay(m, max_arrivals=1)
