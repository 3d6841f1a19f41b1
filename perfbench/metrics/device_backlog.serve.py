"""The mean number of the engine's earlier rounds the device had not
finished when it sent a round (program spans)."""
from perfbench import spans


def read(run):
    return spans.device_backlog(spans.records())
