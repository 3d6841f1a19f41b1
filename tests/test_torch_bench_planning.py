"""The planning halves of the benchmark twins against the reference's
``benchmarks/``: autoplan's per-net documents, quant's zoo rows and
calibrate's sum-of-replicas rows are pure planning, so they equal the
reference's exactly (apart from host-clock seconds); the document
schemas (``REQUIRED_KEYS``, ``validate_doc``) are the reference's."""
import copy

import pytest

from benchmarks import occam_autoplan as j_autoplan
from benchmarks import occam_calibrate as j_calibrate
from benchmarks import occam_quant as j_quant
from repro_torch.benchmarks import (occam_autoplan, occam_calibrate,
                                    occam_quant)

CLOCKED = ("autoplan_seconds", "sweep_seconds", "naive_seconds",
           "sweep_speedup")


def _unclocked(row):
    return {k: v for k, v in row.items() if k not in CLOCKED}


@pytest.mark.parametrize("net", occam_autoplan.SWEEP_NETS)
def test_autoplan_net_document_equals_reference(net):
    assert occam_autoplan.SWEEP_NETS == j_autoplan.SWEEP_NETS
    row = occam_autoplan.measure_net(net)
    want = j_autoplan.measure_net(net)
    assert set(row) == set(want)
    assert _unclocked(row) == _unclocked(want)
    assert row["matches_exhaustive"] and row["audit"]["ok"]


def test_autoplan_document_frame_equals_reference(tmp_path):
    """The document around the per-net rows, on one net: fleet, audit
    roll-up and the exhaustive-match flag; the harness entry writes it."""
    doc = occam_autoplan.autoplan_measurement(nets=("alexnet",))
    want = j_autoplan.autoplan_measurement(nets=("alexnet",))
    assert set(doc) == set(want)
    for key in ("audit", "fleet", "all_match_exhaustive"):
        assert doc[key] == want[key]
    assert [_unclocked(r) for r in doc["nets"]] == \
        [_unclocked(r) for r in want["nets"]]


def test_quant_zoo_rows_equal_reference():
    assert (occam_quant.ZOO_NETS, occam_quant.ZOO_CAPACITY,
            occam_quant.POLICIES) == (j_quant.ZOO_NETS,
                                      j_quant.ZOO_CAPACITY,
                                      j_quant.POLICIES)
    assert occam_quant.zoo_rows() == j_quant.zoo_rows()


def test_calibrate_zoo_chips_saved_equal_reference():
    assert occam_calibrate.zoo_chips_saved() == j_calibrate.zoo_chips_saved()


def _quant_doc():
    row = {"net": "alexnet", "policy": "int8", "n_spans": 2,
           "boundaries": [5], "offchip_bytes_per_image": 1.0,
           "boundary_bytes_per_image": 1.0}
    return {"audit": {"ok": True}, "zoo_capacity_elems": 400_000,
            "policies": ["fp32", "int8"], "zoo": [row],
            "execution": {"net": "vgg_mini", "matches_prediction_bytes": True,
                          "payload_bytes_per_elem": 1.0,
                          "link_bytes_ratio_int8": 0.25,
                          "max_abs_err_int8": 0.1, "tolerance": 0.25},
            "bytes_reduction_int8": 4.0, "span_growth_nets": ["alexnet"]}


def _calibrate_doc():
    doc = {k: 1 for k in j_calibrate.REQUIRED_KEYS}
    doc.update(net="vgg_mini", fleet={"chips": 6, "vmem_elems": 6000},
               boundaries=[3, 6], replicas=[2, 2, 1], packing="sum",
               winner_changed=False,
               calibration={"version": 1, "macs_per_s": 1e9,
                            "stage_overhead_s": 0.0,
                            "link_s_per_elem": 0.0, "samples": 3,
                            "residual": 0.0})
    return doc


def _variants(doc, breaks):
    out = [doc]
    for path, value in breaks:
        bad = copy.deepcopy(doc)
        *head, last = path
        node = bad
        for k in head:
            node = node[k]
        if value is KeyError:
            del node[last]
        else:
            node[last] = value
        out.append(bad)
    return out


QUANT_BREAKS = [(("zoo_capacity_elems",), KeyError),
                (("bytes_reduction_int8",), 1.0),
                (("span_growth_nets",), []),
                (("zoo", 0, "n_spans"), KeyError),
                (("execution", "tolerance"), KeyError),
                (("execution", "matches_prediction_bytes"), False),
                (("execution", "max_abs_err_int8"), 0.5)]
CALIBRATE_BREAKS = [(("calibration",), KeyError),
                    (("calibration", "macs_per_s"), KeyError),
                    (("measured_period_us",), 0),
                    (("calibrated_period_us",), -1),
                    (("error_improvement",), 0)]


def _outcome(validate, doc):
    try:
        validate(doc)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("mod,j_mod,make,breaks", [
    (occam_quant, j_quant, _quant_doc, QUANT_BREAKS),
    (occam_calibrate, j_calibrate, _calibrate_doc, CALIBRATE_BREAKS)],
    ids=["quant", "calibrate"])
def test_schema_gate_equals_reference(mod, j_mod, make, breaks):
    """The same keys, and every document accepted or refused with the
    reference's message."""
    assert mod.REQUIRED_KEYS == j_mod.REQUIRED_KEYS
    docs = _variants(make(), breaks)
    outcomes = [_outcome(mod.validate_doc, d) for d in docs]
    assert outcomes == [_outcome(j_mod.validate_doc, d) for d in docs]
    assert outcomes[0] is None and all(outcomes[1:])
