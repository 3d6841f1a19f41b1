"""The benchmark twins of the repository's ``benchmarks/``: the paper's
tables and figures, reproduced from the port's planning core, and the
executable measurements (span engine, STAP pipeline, serving session,
async engine, autoplan, quantized spans, calibration) run on the GPU
unless ``device="cpu"`` (``--device cpu``) is given.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu]

Measured documents go to ``results/BENCH_torch_<name>.json``, each with
a ``device`` block naming the card and its power limit (or ``"cpu"``).
``benchmarks/hlo_analysis.py`` has no twin: it walks XLA's HLO text, and
the port has no HLO."""
