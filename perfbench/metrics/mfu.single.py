"""The whole request's share of the 165 TFLOP/s peak over the traced slice, in %."""
from perfbench import measures


def read(run):
    return measures.mfu_wall(run)
