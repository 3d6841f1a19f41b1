"""Images delivered over the lanes of the rounds the engine ran in the window, in %."""
from perfbench import measures


def read(run):
    return measures.engine_occupancy(run)
