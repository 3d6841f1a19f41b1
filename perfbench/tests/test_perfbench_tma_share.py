"""The reader of ``weight_tma_share.batch``, the share of the fused span's
staged weight bytes that arrive by TMA, on synthetic round records, and
its entry in ``BENCHMARK.json``."""
import types

import pytest

from perfbench import spans, spec


def _rec(name="occam.session.round", **attrs):
    return types.SimpleNamespace(name=name, start_ns=0, end_ns=1,
                                 attrs=attrs)


def test_tma_share_is_the_mean_share_over_rounds(monkeypatch):
    """Every round whose weights all arrive by TMA reads 100%; a round
    staging half by TMA and one staging all average to 75%; other spans
    and rounds without the attribute are left out."""
    read = spec.reader("weight_tma_share.batch")
    full = [_rec(weight_bytes=3_000_000, weight_tma_bytes=3_000_000),
            _rec(lanes=8), _rec(weight_bytes=5_000, weight_tma_bytes=5_000),
            _rec("occam.session.submit", weight_bytes=1,
                 weight_tma_bytes=0)]
    monkeypatch.setattr(spans, "records", lambda: full)
    assert read(None) == pytest.approx(100.0)
    half = [_rec(weight_bytes=4_000, weight_tma_bytes=2_000),
            _rec(weight_bytes=4_000, weight_tma_bytes=4_000)]
    monkeypatch.setattr(spans, "records", lambda: half)
    assert read(None) == pytest.approx(75.0)


@pytest.mark.parametrize("recs", [
    [], [_rec(lanes=8)], [_rec(weight_bytes=3_000_000)],
    [_rec(weight_bytes=3_000_000, weight_tma_bytes=None)],
    [_rec("occam.session.submit", weight_bytes=1, weight_tma_bytes=1)]])
def test_tma_share_is_none_without_the_attribute(monkeypatch, recs):
    """A program whose rounds carry no TMA bytes, as one that stages none
    by TMA, gives no reading, and the reader does not raise."""
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert spec.reader("weight_tma_share.batch")(None) is None


def test_tma_share_entry_names_the_three_batch_cells():
    entry = {m["name"]: m for m in spec.load()["per_layer"]}[
        "weight_tma_share.batch"]
    assert entry["layer"] == "fused-span kernel (kernels/fused_span)"
    assert (entry["source"], entry["moves"], entry["unit"]) == (
        "program_span", "images_per_s", "%")
    assert entry["workloads"] == ["resnet18-batch8", "alexnet-batch8",
                                  "vggnet-batch8"]
