"""The engine's images' share of the 165 TFLOP/s peak over the device's busy time in the slice, in %."""
from perfbench import measures


def read(run):
    return measures.mfu_busy(run)
