"""B3 (csrc/fused_classify_pick.cu, the verdict-only instances) as a %
of its roofline, over the hint batches."""
from portbench.roofline import share

B3 = r"fused_kernel<\w+, ?\d+, ?false>|fused_kernel.*Lb0EEv"


def read(ctx):
    return share(ctx, B3, "hint")
