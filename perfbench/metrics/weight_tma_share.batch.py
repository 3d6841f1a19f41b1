"""The share of the weights the fused-span kernel's CTAs stage into shared
memory that arrives by TMA tensor copies, in %: the mean over the run's
rounds (program spans) of ``weight_tma_bytes / weight_bytes``, both counted
by the program on the host from each span's launch geometry
(``kernel.launch_counts``). None where no round carries
``weight_tma_bytes``, as with a program that stages no weights by TMA."""
from perfbench import round_counts, spans


def read(run):
    shares = [r.attrs["weight_tma_bytes"] / r.attrs["weight_bytes"] * 100
              for r in spans.records() if r.name == round_counts.ROUND
              and r.attrs.get("weight_tma_bytes") is not None
              and r.attrs.get("weight_bytes")]
    return sum(shares) / len(shares) if shares else None
