"""The weights the fused-span kernel's CTAs stage into shared memory per
image of a round, in MB: the mean over the run's rounds (program spans).
The program counts them on the host from each span's launch geometry
(``kernel.launch_counts``, a model of the copies ``load_b`` issues), not
on the device."""
from perfbench import round_counts, spans


def read(run):
    return round_counts.mean_mb(spans.records(), "weight_bytes")
