"""The port's dry run (``launch/dryrun.py``) on the ``meta`` device: its
records carry every key of the reference's record, each ``None``
explained in ``notes``, and its command line writes a record.

The reference's keys are read from its source (its module forces 512
placeholder devices when imported, so it is not imported here)."""
import ast
import json
from pathlib import Path

import pytest

from repro_torch import configs
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("train", "prefill", "decode")


def _reference_keys() -> dict:
    """The reference's ``record`` literal: {key: nested keys or None}."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())

    def keys(d: ast.Dict) -> dict:
        return {k.value: keys(v) if isinstance(v, ast.Dict) else None
                for k, v in zip(d.keys, d.values)}

    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "record"):
            return keys(node.value)
    raise AssertionError("no record literal in the reference's dry run")


def _check_record(rec: dict, ref: dict, notes: dict, where=()):
    for k, sub in ref.items():
        assert k in rec, where + (k,)
        if rec[k] is None:
            assert notes.get(k, "").startswith("None:"), k
        elif sub is not None:
            _check_record(rec[k], sub, notes, where + (k,))


@pytest.mark.parametrize(
    "arch,kind,multi_pod",
    [(a, k, False) for a in ("llama3.2-1b", "olmoe-1b-7b", "mamba2-1.3b",
                             "seamless-m4t-large-v2") for k in KINDS]
    + [("llama3.2-1b", k, True) for k in KINDS])
def test_smoke_record_has_the_reference_keys(arch, kind, multi_pod):
    """Smoke configs at 32 x 64 on a production mesh of ``meta``
    positions (two rows a data position single-pod, one multi-pod)."""
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    shape = configs.ShapeCfg(f"smoke_{kind}", 64, 32, kind)
    rec = dryrun.cell_record(configs.get_smoke(arch), shape,
                             specs.make_ctx(mesh, multi_pod, shape))
    _check_record(rec, _reference_keys(), rec["notes"])
    assert rec["n_chips"] == n
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    m, c = rec["memory_per_device"], rec["cost_per_device"]
    assert all(isinstance(m[k], int) and m[k] > 0 for k in m
               if k != "alias_bytes")
    assert (m["alias_bytes"] > 0) == (kind != "prefill")
    assert m["peak_estimate_bytes"] == (m["arguments_bytes"]
                                        + m["output_bytes"] + m["temp_bytes"]
                                        - m["alias_bytes"])
    assert c["flops"] == c["flops_global"] / n and c["n_dots"] > 0
    assert "n/a" in dryrun.fmt(rec)


def test_cli_writes_one_cell(tmp_path, capsys):
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "llama3.2-1b/decode_32k/serve_step" in out
    assert "all dry-run cells built OK" in out
    (path,) = tmp_path.iterdir()
    assert path.name == "llama3.2-1b__decode_32k__16x16.json"
    rec = json.loads(path.read_text())
    assert rec["arch"] == "llama3.2-1b" and rec["kind"] == "decode"
    assert rec["collectives_per_device"] is None
    assert rec["params_total"] == configs.get_config(
        "llama3.2-1b").param_count()[0]


def test_cli_needs_a_cell():
    with pytest.raises(SystemExit):
        dryrun.main([])
    with pytest.raises(SystemExit):  # there is no HLO to save
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                     "--save-hlo"])
