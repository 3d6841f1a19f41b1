"""The fused-span kernel's share of its roofline in the slice, in %."""
from perfbench import measures


def read(run):
    return measures.conv_roofline(run)
