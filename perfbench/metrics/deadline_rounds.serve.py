"""The share of the engine's rounds sent at the max_wait_ms deadline, in %
(program spans)."""
from perfbench import spans


def read(run):
    return spans.deadline_rounds(spans.records())
