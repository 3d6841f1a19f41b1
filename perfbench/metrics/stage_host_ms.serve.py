"""The mean host time of the engine's stage of a round (the pinned pack
and the copy's issue), in ms (program spans)."""
from perfbench import spans


def read(run):
    return spans.mean_ms(spans.records(), "occam.engine.stage")
