"""B4 (csrc/cidr_first.cu) as a % of its roofline, over the cidr batches
(ACL and route lookups together)."""
from portbench.roofline import share


def read(ctx):
    return share(ctx, r"cidr_first_kernel", "cidr")
