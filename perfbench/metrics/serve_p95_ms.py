"""95th percentile of the open loop's latency, from when each request was due to its outputs on the host, in ms; a refused or unanswered request counts as infinitely late."""
from perfbench import measures


def read(run):
    return measures.p95_ms(run)
