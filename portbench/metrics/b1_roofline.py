"""B1 (csrc/fused_classify_pick.cu, the PICK instances: verdict and
Maglev pick) as a % of its roofline, over the cpick batches."""
from portbench.roofline import share

# demangled (fused_kernel<true, 16, true>) or mangled (...Lb1EE) names
B1 = r"fused_kernel<\w+, ?\d+, ?true>|fused_kernel.*Lb1EEv"


def read(ctx):
    return share(ctx, B1, "cpick")
