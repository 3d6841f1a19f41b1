"""What the span engine's spans read from and write to device memory per
image of a round (inputs, outputs, spills, crossing residual sources), in
MB, as the deployment's per-image transfer profile counts it: the mean
over the run's rounds (program spans)."""
from perfbench import round_counts, spans


def read(run):
    return round_counts.mean_mb(spans.records(), "boundary_bytes")
