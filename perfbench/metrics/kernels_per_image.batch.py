"""Compute kernels launched in the slice per image answered in it."""
from perfbench import measures


def read(run):
    return measures.kernels_per_image(run)
