"""vproxy_tpu_torch — the classify engine on PyTorch and CUDA.

The same batched classify+pick serving path as `vproxy_tpu`, held to
it bit for bit: identical compiled table arrays from the same rules,
identical (verdict, pick) for every query. Plain tensor code is
PyTorch; the fused classify+pick kernel is hand-written CUDA
(csrc/fused_classify_pick.cu, bound in ops/fused_cuda.py).

Entry points run on the GPU unless the caller asks for the CPU
(`device="cpu"` or VPROXY_TPU_TORCH_DEVICE=cpu; utils/torchenv.py).
"""
