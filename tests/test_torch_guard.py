"""Torch port guards: it stands alone, and it never runs on the CPU unasked.

* No module of vproxy_tpu_torch/ and not chip_smoke.py imports jax or
  vproxy_tpu (an AST scan, one case per file), and importing the whole
  package in a fresh interpreter leaves both out of sys.modules.
* default_device() is CUDA; without a GPU it raises unless the caller
  asked for the CPU (device="cpu" or VPROXY_TPU_TORCH_DEVICE=cpu).
* chip_smoke.py exits non-zero, printing no result, without a GPU.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

from vproxy_tpu_torch.utils import torchenv

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "vproxy_tpu_torch")


def port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if not d.startswith(("_", "."))]
        out += [os.path.join(dirpath, f) for f in filenames
                if f.endswith(".py")]
    return sorted(os.path.relpath(p, ROOT) for p in out)


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("rel", port_files())
def test_no_jax_or_reference_import(rel):
    roots = imported_roots(os.path.join(ROOT, rel))
    assert not roots & {"jax", "jaxlib", "vproxy_tpu"}, (rel, roots)


def test_package_import_leaves_jax_out():
    mods = sorted({os.path.splitext(r)[0].replace(os.sep, ".")
                   for r in port_files() if r.startswith("vproxy_tpu_torch")})
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'vproxy_tpu.')) or "
            "m == 'vproxy_tpu']\n"
            "assert not bad, bad\nprint(len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_default_device_is_cuda_and_never_silently_cpu(monkeypatch):
    monkeypatch.delenv("VPROXY_TPU_TORCH_DEVICE", raising=False)
    if torch.cuda.is_available():
        assert torchenv.default_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        torchenv.default_device()
    with pytest.raises(RuntimeError):
        torchenv.default_device("cuda")
    assert torchenv.default_device("cpu").type == "cpu"
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "cpu")
    assert torchenv.default_device().type == "cpu"


def test_matcher_without_gpu_raises_unless_cpu_asked(monkeypatch):
    from vproxy_tpu_torch.rules.engine import HintMatcher
    from vproxy_tpu_torch.rules.ir import HintRule
    monkeypatch.delenv("VPROXY_TPU_TORCH_DEVICE", raising=False)
    rules = [HintRule(host="a.example.com")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            HintMatcher(rules)
    assert HintMatcher(rules, device="cpu").device.type == "cpu"
    assert HintMatcher(rules, backend="host").device is None


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
