"""BENCHMARK.json against the shape its readers require, and every
piece found by its name alone."""

import json
import re

import pytest

from asmbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["asmbench"]
    assert BENCH["command"][1] == "asmbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_named_one(c):
    assert c["file"] == f"asmbench/configs/{c['name']}.json"
    cfg = spec.load_json("configs", c["name"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert all(k in cfg for k in c["reduced"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_pieces_are_found_by_name(w):
    assert w["chips"] == 1
    spec.load_json("configs", w["config"])
    mix = spec.load_json("traffic", w["traffic"])
    entry = spec.load_module("entries", mix["entry"])
    for fn in ("setup", "job", "reads", "release", "control", "check"):
        assert callable(getattr(entry, fn))
    assert spec.per_layer_metrics(BENCH, w["name"])
    assert {m["name"] for m in spec.end_to_end_metrics(BENCH)} \
        == {"reads_per_s", "job_p95_ms", "setup_s"}


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_its_reader(m):
    assert callable(spec.load_module("metrics", m["name"]).read)
    assert m["moves"] == "reads_per_s"
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m["workloads"]) <= cells


def test_bounds():
    b = {m["name"]: m["bound"] for m in BENCH["end_to_end"]}
    assert b["setup_s"] == 0.25
    assert all(0.01 <= v <= 0.25 for v in b.values())


def test_a_new_piece_is_found_without_an_edit(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "configs" / "new-config.json").write_text(
        json.dumps({"name": "new-config", "k0": 31}))
    (tmp_path / "traffic" / "new-mix.json").write_text(
        json.dumps({"entry": "level0", "libraries": 3}))
    (tmp_path / "metrics" / "new_metric.py").write_text(
        "def read(view):\n    return 42.0\n")
    roots = (tmp_path, spec.HERE)
    assert spec.load_json("configs", "new-config", roots)["k0"] == 31
    mix = spec.load_json("traffic", "new-mix", roots)
    assert spec.load_module("entries", mix["entry"], roots).LIMITS
    assert spec.load_module("metrics", "new_metric", roots).read(None) == 42
    # the pieces already there are still found through the same roots
    assert spec.load_json("traffic", "level0", roots)["entry"] == "level0"
    bench = {"end_to_end": [{"name": "reads_per_s"}],
             "per_layer": [{"name": "new_metric", "moves": "reads_per_s"},
                           {"name": "other", "moves": "reads_per_s",
                            "workloads": ["elsewhere"]}]}
    assert [m["name"] for m in spec.per_layer_metrics(bench, "any")] == \
        ["new_metric"]


def test_a_missing_piece_says_where_it_looked():
    with pytest.raises(FileNotFoundError, match="configs/nothing.json"):
        spec.load_json("configs", "nothing")
