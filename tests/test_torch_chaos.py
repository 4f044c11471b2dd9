"""The port's chaos driver (vproxy_tpu_torch/tools/chaos.py).

* Phase 4 (device drop) on the CPU, fast, against the reference's phase
  4 (tools/chaos.py): both fail the faulted batch over to the host
  oracle and deliver [-1, 0], with a failover counted.
* Phase 4's card contract, without a GPU: the port's matcher on a
  non-CPU device (VPROXY_TPU_TORCH_DEVICE=meta, the kernel build
  replaced by the identity) takes rules/service.py's _card_error path:
  a KernelError closes the phase's own service, every held callback
  gets -1, no failover, a later submit raises.
* tests/test_chaos.py's two scenarios, `chaos` and `slow` as the
  reference's are, with its floor: the LB script, and the cluster
  kill-and-rejoin (whose step loops carry a Maglev plane, every query a
  submit_pick held to the oracle and the host Maglev pick).
"""
import pytest

from test_torch_tcplb import _torch_cpu  # noqa: F401
from vproxy_tpu_torch.ops import fused_cuda as FC
from vproxy_tpu_torch.rules.service import ClassifyService
from vproxy_tpu_torch.tools import chaos
from vproxy_tpu_torch.utils import failpoint


@pytest.fixture(autouse=True)
def _clean():
    failpoint.clear()
    yield
    failpoint.clear()


def test_phase4_cpu_fails_over_like_the_reference():
    from tools import chaos as ref_chaos
    ref = ref_chaos._classify_device_drop()
    out = chaos._classify_device_drop()
    assert ref["delivered"] and out["delivered"], (ref, out)
    assert ref["failovers"] >= 1 and out["failovers"] >= 1, (ref, out)
    assert out["answers"] == ref["answers"] == [-1, 0]
    assert out["on_card"] is False


def test_phase4_card_contract_is_a_kernel_error(monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "meta")
    monkeypatch.setattr(FC, "prepare_table", lambda t: t)
    before = ClassifyService.get()
    out = chaos._classify_device_drop()
    assert out["on_card"] and out["delivered"], out
    assert out["error"] == "KernelError" and out["failovers"] == 0, out
    # each of the two queries was either held and answered -1, or
    # submitted after the fault closed the service and refused
    assert out["answers"] and set(out["answers"]) == {-1}, out
    assert len(out["answers"]) + len(out["refused"]) == 2, out
    assert set(out["refused"]) <= {"KernelError"}, out
    assert out["later_submit_raised"] == "KernelError", out
    # the phase's service was its own: the process-wide one serves on
    assert ClassifyService.get() is before and before.error is None


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_scenario_floor():
    report = chaos.run(clients=4, requests=120, payload_len=4096,
                       eject_base_s=0.5, drain_s=10.0)

    # >= 99% of sessions complete with correct byte counts (retry failover)
    assert report["success_rate"] >= 0.99, report
    assert report["warmup"]["fail"] == 0, report["warmup"]

    # the refused backend was passively ejected within the failure
    # threshold — far inside the 60s hc interval, so not the checker
    assert report["ejected"], report
    assert report["eject_latency_s"] is not None \
        and report["eject_latency_s"] < 5.0, report

    # disarm -> backoff re-admission, and it serves again
    assert report["readmitted"], report
    assert report["victim_served_after_readmit"], report

    # device drop degraded to the host oracle and still delivered
    assert report["classify"]["delivered"], report["classify"]
    assert report["classify"]["failovers"] >= 1, report["classify"]
    assert report["classify"]["answers"] == [-1, 0], report["classify"]

    # drain mid-traffic: new accepts shed, in-flight finish, clean exit
    # within the drain window
    assert report["drain_sheds_new_accepts"], report
    assert report["drain_inflight_alive"], report
    assert report["drain_clean"], report
    assert report["drain_elapsed_s"] < 10.0, report


@pytest.mark.chaos
@pytest.mark.slow
def test_cluster_chaos_kill_and_rejoin():
    report = chaos.run_cluster()

    # phase 1: fleet converged, rules replicated, checksums equal
    assert report["converged"], report
    assert report["replicated"], report
    assert report["checksums_equal"], report

    # phase 2: the kill drove the SURVIVORS through the barrier-timeout
    # degrade — and not one of their queries failed the floor
    assert report["survivor_success_rate"] >= 0.99, report
    assert all(report["survivors_degraded"]), report
    assert all(n >= 1 for n in report["survivor_barrier_stalls"]), report

    # phase 3: node 2 is back, caught up to the CURRENT generation, and
    # the next generation re-joined every host to step dispatch
    assert report["rejoin_member"], report
    assert report["rejoin_caught_up"], report
    assert report["fleet_at_generation"], report
    assert report["survivors_rejoined"], report
    assert report["checksums_equal_after_rejoin"], report
