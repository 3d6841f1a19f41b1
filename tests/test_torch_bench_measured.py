"""The measured benchmark twins on the CPU at tiny sizes: each one's
document carries the reference's keys (the Pallas names renamed to the
port's) and a ``device`` block of ``"cpu"``, its own checks hold (one
build per session and engine, model == machine, outputs equal to the
oracle's), and quant's and calibrate's documents pass both packages'
schema gates. Times from a CPU run are not the card's and are checked
only for sign."""
import json
from pathlib import Path

import pytest
import torch

from benchmarks import occam_calibrate as j_calibrate
from benchmarks import occam_quant as j_quant
from repro_torch.benchmarks import (common, occam_async, occam_calibrate,
                                    occam_quant, occam_serve, occam_stap)

ROOT = Path(__file__).resolve().parents[1]
RENAMED = {"stage_body_ms_pallas": "stage_body_ms_cuda_kernel",
           "stage_body_pallas_over_scan": "stage_body_cuda_kernel_over_scan"}


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """One intra-op thread: the CPU runs the kernel's plain version as
    many tiny operations, which torch's default thread pool slows many
    times over on a host that parallel test workers load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_keys(name):
    doc = json.loads((ROOT / "results" / f"BENCH_{name}.json").read_text())
    return {RENAMED.get(k, k) for k in doc}


def test_stap_document_on_the_cpu():
    row = occam_stap.stap_measurement(device="cpu", batch=2, reps=1)
    assert _reference_keys("stap") <= set(row)
    assert row["device"] == "cpu" and row["boundaries"] == [2, 7]
    assert row["stage_engines"] == ["pallas"] * 3
    assert row["audit"]["ok"]
    assert 1 <= row["measurement_attempts"] <= 3
    assert len(row["attempt_max_deviations"]) == row["measurement_attempts"]
    assert row["pipeline_thr_measured_over_predicted"] > 0
    assert row["replicas_stap"] == [1, 2, 1] and row["chips_stap"] == 4
    for key in ("max_abs_err_pipeline", "max_abs_err_stap",
                "max_abs_err_single_device"):
        assert row[key] <= 1e-5 * row["max_abs_oracle"]


def test_serve_document_on_the_cpu():
    row = occam_serve.serve_measurement(rounds_timed=2, reps=1,
                                        device="cpu")
    assert _reference_keys("serve") <= set(row)
    assert row["device"] == "cpu"
    assert row["session_compile_count"] == 1
    assert row["matches_prediction"] and row["audit"]["ok"]
    assert row["serve_thr_measured_over_predicted"] > 0


def test_async_document_on_the_cpu():
    row = occam_async.async_measurement(
        rounds_timed=2, reps=1, prefill=1, poisson_fracs=(0.5,),
        poisson_requests=2, device="cpu")
    assert _reference_keys("async") <= set(row)
    assert row["device"] == "cpu"
    assert row["engine_compile_count"] == 1
    assert [p["engine_compile_count"] for p in row["poisson"]] == [1]
    assert row["matches_prediction"] and row["audit"]["ok"]
    assert row["async_thr_measured_over_predicted"] > 0


def test_quant_document_passes_both_gates():
    doc = occam_quant.quant_measurement(device="cpu")
    occam_quant.validate_doc(doc)
    j_quant.validate_doc(doc)
    assert _reference_keys("quant") <= set(doc)
    assert doc["device"] == "cpu"
    assert doc["zoo"] == j_quant.zoo_rows()
    assert doc["bytes_reduction_int8"] == 4.914


def test_calibrate_document_passes_both_gates():
    doc = occam_calibrate.calibrate_measurement(rounds_timed=2,
                                                device="cpu")
    occam_calibrate.validate_doc(doc)
    j_calibrate.validate_doc(doc)
    assert _reference_keys("calibrate") <= set(doc)
    assert doc["device"] == "cpu"
    assert doc["session_compile_count"] == 1
    assert doc["calibrated_over_measured"] > 0


@pytest.mark.parametrize("fn", [
    lambda: common.resolve_device(None),
    lambda: occam_stap.stap_measurement(),
    lambda: occam_quant.execution_row()])
def test_no_gpu_and_no_device_raises_naming_cpu(fn, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn()
