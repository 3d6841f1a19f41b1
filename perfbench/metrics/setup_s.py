"""Process start to the first timed request, in s."""
from perfbench import measures


def read(run):
    return measures.setup(run)
