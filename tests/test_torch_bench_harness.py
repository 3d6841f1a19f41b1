"""The benchmark harness twin (``repro_torch.benchmarks.run``) and its
helpers against the reference's: the harness lists the reference's
entries in its order; ``backfill`` stamps only the port's
``BENCH_torch_*.json`` and leaves every other document byte for byte;
the audit stamp is the reference's verdict; the roofline's analytic
FLOPs equal the reference's on every (arch x shape), and a dry-run
record's missing terms stay ``None`` with their reasons."""
import json

import pytest

from benchmarks import audit_stamp as j_audit_stamp
from benchmarks import roofline as j_roofline
from benchmarks import run as j_run
from repro import occam as j_occam
from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPE_GRID as J_SHAPE_GRID
from repro.core.graph import chain as j_chain
from repro_torch import configs, occam
from repro_torch.benchmarks import audit_stamp, roofline, run
from repro_torch.core.graph import chain
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh


def test_harness_lists_the_reference_entries_in_order():
    assert [b[0] for b in run.BENCHES] == [b[0] for b in j_run.BENCHES]
    assert [b[2] for b in run.BENCHES] == [b[2] for b in j_run.BENCHES]


def test_backfill_stamps_only_the_port_documents(tmp_path):
    docs = {"BENCH_stap.json": {"x": 1},
            "BENCH_torch_stap.json": {"x": 2},
            "BENCH_torch_serve.json": {"x": 3, "audit": {"ok": True}},
            "BENCH_torch_bad.json": None}
    raw = {}
    for name, doc in docs.items():
        text = "{not json" if doc is None else json.dumps(doc)
        (tmp_path / name).write_text(text)
        raw[name] = (tmp_path / name).read_bytes()
    stamped = audit_stamp.backfill(str(tmp_path))
    assert stamped == [str(tmp_path / "BENCH_torch_stap.json")]
    stamp = json.loads((tmp_path / "BENCH_torch_stap.json").read_text())
    assert stamp["audit"] == audit_stamp.UNAUDITED
    assert stamp["audit"]["ok"] is None and stamp["audit"]["rules"] == []
    for name in ("BENCH_stap.json", "BENCH_torch_serve.json",
                 "BENCH_torch_bad.json"):
        assert (tmp_path / name).read_bytes() == raw[name]
    assert audit_stamp.backfill(str(tmp_path / "missing")) == []


def test_audit_verdict_equals_reference():
    specs_ = [("conv", 3, 1, 1, 8), ("conv", 3, 1, 1, 8),
              ("pool", 2, 2, 0, 0), ("conv", 3, 1, 1, 16)]
    plan = occam.plan(chain("t", specs_, in_h=16, in_w=16, in_ch=3), 3000)
    j_plan = j_occam.plan(j_chain("t", specs_, in_h=16, in_w=16, in_ch=3),
                          3000)
    got = audit_stamp.audit_verdict(plan, plan.place(pipeline=True))
    want = j_audit_stamp.audit_verdict(j_plan, j_plan.place(pipeline=True))
    assert got == want and got["ok"]


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_model_flops_equal_reference(arch):
    assert sorted(configs.SHAPE_GRID) == sorted(J_SHAPE_GRID)
    for shape in J_SHAPE_GRID:
        assert roofline.model_flops_global(arch, shape) == \
            j_roofline.model_flops_global(arch, shape), shape


def test_roofline_row_keeps_missing_terms_none(tmp_path):
    """A port record (the smoke Llama's train cell on the single-pod
    ``meta`` mesh, labelled as ``train_4k``): the compute term from its
    own FLOP count at 989 TFLOP/s, the memory and collective terms, the
    dominant term and the fraction ``None`` with the record's reasons."""
    mesh = make_production_mesh(multi_pod=False, devices=["meta"] * 256)
    shape = configs.ShapeCfg("smoke_train", 64, 32, "train")
    rec = dryrun.cell_record(configs.get_smoke("llama3.2-1b"), shape,
                             specs.make_ctx(mesh, False, shape))
    rec.update(arch="llama3.2-1b", shape="train_4k", mesh="16x16")
    (tmp_path / "cell.json").write_text(json.dumps(rec))
    (row,) = roofline.load_rows(str(tmp_path), mesh="16x16")
    assert roofline.load_rows(str(tmp_path), mesh="2x16x16") == []
    flops = rec["cost_per_device"]["flops"]
    assert row["t_compute_s"] == flops / 989e12
    assert row["counted_flops_per_dev"] == flops
    assert row["model_flops_per_dev"] == \
        j_roofline.model_flops_global("llama3.2-1b", "train_4k") / 256
    for key in ("t_memory_s", "t_collective_s", "dominant",
                "roofline_fraction"):
        assert row[key] is None and row["reasons"][key]
    assert row["reasons"]["t_memory_s"] == rec["notes"]["bytes_accessed"]
    assert "n/a" in roofline.fmt_table([row])
    bad = dict(rec, collectives_per_device={"total_bytes": 1})
    with pytest.raises(ValueError, match="no collectives"):
        roofline.roofline_row(bad)
