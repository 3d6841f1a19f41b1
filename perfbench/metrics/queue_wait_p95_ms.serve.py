"""The 95th percentile of a request's wait in the engine's queue, from
its admission to its last image packed, in ms (program spans)."""
from perfbench import spans


def read(run):
    return spans.queue_wait_p95_ms(spans.records())
