"""The port's native load tool: vproxy_tpu_torch/native/hostbench.cpp
(the reference's vproxy_tpu/native/hostbench.cpp line for line; only
`//` comment text differs) and vproxy_tpu_torch/tools/hostbench.py,
which builds it into the package's _build/ (content-keyed, under a
lock, never into vproxy_tpu/native/) and drives it: a server, a client,
and a client run through a port TcpLB on the CPU."""
import os
import shutil

import pytest

from test_torch_tcplb import _torch_cpu  # noqa: F401
from vproxy_tpu_torch.tools import hostbench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_CPP = os.path.join(ROOT, "vproxy_tpu", "native", "hostbench.cpp")

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build hostbench")


def test_port_hostbench_cpp_is_the_reference_code():
    with open(hostbench.SOURCE) as a, open(REF_CPP) as b:
        ours, ref = a.read().splitlines(), b.read().splitlines()
    assert len(ours) == len(ref)
    for i, (x, y) in enumerate(zip(ours, ref), 1):
        assert x.split("//")[0] == y.split("//")[0], i


@needs_gxx
def test_build_is_content_keyed_into_the_port_build_dir(tmp_path):
    src = tmp_path / "hostbench.cpp"
    shutil.copy(hostbench.SOURCE, src)
    build = str(tmp_path / "_build")
    b1 = hostbench.build_tool(str(src), build)
    t1 = os.path.getmtime(b1)
    assert hostbench.build_tool(str(src), build) == b1
    assert os.path.getmtime(b1) == t1  # reused, not rebuilt
    with open(src, "a") as f:
        f.write("\n// an edit\n")
    b2 = hostbench.build_tool(str(src), build)
    assert b2 != b1 and os.path.dirname(b2) == build
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]
    # the default build: the port's source into the port's _build/
    b = hostbench.build_tool()
    assert os.path.dirname(b) == hostbench.BUILD_DIR
    assert hostbench.BUILD_DIR == os.path.join(ROOT, "vproxy_tpu_torch",
                                               "_build")
    assert os.access(b, os.X_OK)


@needs_gxx
def test_client_through_a_port_tcplb_serves_without_errors():
    res = hostbench.serve_through_lb(secs=1.0, conns=8, pipeline=4)
    assert res["errors"] == 0, res
    assert res["reqs"] > 0 and res["rps"] > 0, res
    assert res["device"] == "cpu"
    # one classify per accepted connection (http-splice: the first
    # head), through ClassifyService
    assert res["classify_queries"] >= res["conns"], res


@needs_gxx
def test_server_and_client_direct():
    p, port = hostbench.start_server()
    try:
        res = hostbench.run_client(port, 4, 0.5, 2)
    finally:
        p.kill()
        p.wait(10)
    assert res["errors"] == 0 and res["reqs"] > 0, res


def test_cli_without_gpu_raises_unless_cpu_asked(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.delenv("VPROXY_TPU_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        hostbench.main(["--secs", "0.1"])
