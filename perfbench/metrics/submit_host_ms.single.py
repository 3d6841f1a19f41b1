"""The mean host time of a Session.submit (the image's copy to the device
and the round it issues), in ms (program spans)."""
from perfbench import spans


def read(run):
    return spans.mean_ms(spans.records(), "occam.session.submit")
