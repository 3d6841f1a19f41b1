"""Images whose outputs reached the host in the window, per second."""
from perfbench import measures


def read(run):
    return measures.images_per_s(run)
