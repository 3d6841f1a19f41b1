"""The share of the slice with no kernel or copy on the device, in %."""
from perfbench import measures


def read(run):
    return measures.device_idle(run)
