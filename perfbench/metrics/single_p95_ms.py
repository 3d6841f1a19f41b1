"""95th percentile of the one-image requests' latency, from submit to outputs on the host, in ms; an unanswered request counts as infinitely late."""
from perfbench import measures


def read(run):
    return measures.p95_ms(run)
