"""``BENCHMARK.json`` and the files it names: the contract's charset and
limits, every metric's ``moves`` target reported where the metric is, and
every cell's files found by name."""
import json

import pytest

from perfbench import generator, spec

BENCH = spec.load()
NAMES = ([c["name"] for c in BENCH["configs"]]
         + [w["name"] for w in BENCH["workloads"]]
         + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", NAMES)
def test_names_use_the_allowed_characters(name):
    assert spec.NAME.fullmatch(name), name


def test_names_are_unique_and_units_well_formed():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert spec.UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_short_texts_fit_on_a_line():
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]


def test_every_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in target.get("workloads", cells), (m["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in spec.metrics_for(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert spec.metrics_for(BENCH, w["name"], True), w["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    c = spec.cell(BENCH, cell)
    assert c.config["layers"] and c.traffic["loop"] in generator.LOOPS
    assert 0 < c.limits["worst_rel_gap"] < 1
    for m in spec.metrics_for(BENCH, cell, False) + spec.metrics_for(
            BENCH, cell, True):
        assert callable(spec.reader(m["name"]))


def test_configuration_files_are_distinct_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        assert (spec.ROOT / c["file"]).is_file()
        assert set(c["reduced"]) <= set(json.loads(
            (spec.ROOT / c["file"]).read_text()))


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no-such-cell")


def test_a_malformed_traffic_mix_is_refused():
    with pytest.raises(ValueError):
        generator.check({"loop": "sometimes", "images_on": "host"})
    with pytest.raises(ValueError):
        generator.check({"loop": "closed", "images_on": "host",
                         "round_batch": 8, "pool_images": 4,
                         "request_images": 8, "outstanding": 2})
