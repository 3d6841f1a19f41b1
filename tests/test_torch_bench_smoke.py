"""Slow-tier regression gate, the twin of ``tests/test_bench_smoke.py``:
the port's smoke pass (``repro_torch.benchmarks.smoke``) runs every
benchmark family's smallest config in-process on the CPU, and each one
builds, runs and produces sane numbers."""
import pytest
import torch

from repro_torch.benchmarks import smoke


@pytest.mark.slow
def test_bench_smoke_runs_every_family(capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = smoke.main(["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    printed = capsys.readouterr().out
    assert "bench-smoke OK" in printed
    for family in ("span_engine", "stap_pipeline", "serve_session",
                   "async_engine", "autoplan", "calibrate", "quant"):
        assert family in printed and family in out
    assert out["stap_pipeline"] >= 2 and out["serve_session"] == 4
    assert out["async_engine"] >= 5 and out["quant"] < 0.25
