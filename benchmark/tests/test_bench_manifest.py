"""BENCHMARK.json against the contract's form, and every name it gives
found as a file."""
import json
import re

import pytest

from benchmark.harness.cell import BENCH, ROOT, load_json

B = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = B["end_to_end"] + B["per_layer"]


def test_keys_and_size():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(B)) < 64 * 1024
    assert B["paths"] == ["benchmark"] and 1 <= B["run_seconds"] <= 51
    cells = len(B["workloads"])
    assert 1 <= cells <= 24
    # a full check of 24 cells fits its time
    assert 2 + 14 * 24 * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_names_and_units(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"} | (
        {"bound"} if m in B["end_to_end"] else {"layer", "moves"})
    assert set(m) <= allowed


def test_names_are_unique_and_valid():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in B[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_bounds():
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def reports(cell):
    return [m["name"] for m in B["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


@pytest.mark.parametrize("m", B["per_layer"],
                         ids=[m["name"] for m in B["per_layer"]])
def test_per_layer_moves_what_its_cells_report(m):
    assert m["moves"] in {e["name"] for e in B["end_to_end"]}
    cells = m.get("workloads", [w["name"] for w in B["workloads"]])
    for c in cells:
        assert m["moves"] in reports(c), (m["name"], c)
    assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("w", B["workloads"],
                         ids=[w["name"] for w in B["workloads"]])
def test_each_cell_reports_what_it_must(w):
    r = reports(w["name"])
    assert "setup_s" in r and len(r) >= 2
    assert any(w["name"] in m.get("workloads", [w["name"]])
               for m in B["per_layer"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()


@pytest.mark.parametrize("c", B["configs"], ids=[c["name"] for c in B["configs"]])
def test_config_files(c):
    f = load_json(ROOT / c["file"])
    assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
    assert len(c["source"]) <= 200 and len(c["reduced"]) <= 16
    assert all(k in f for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in B["workloads"])


def test_layers_are_one_line_and_shared_by_name():
    layers = {m["layer"] for m in B["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)



PENDING = sorted((BENCH / "pending").glob("*.json"))


@pytest.mark.parametrize("f", PENDING, ids=[f.stem for f in PENDING])
def test_a_pending_cell_is_whole(f):
    """A cell held in pending/ holds entries that BENCHMARK.json takes as
    they are: a valid cell, its metrics, their files."""
    from benchmark.harness.cell import with_pending
    extra = load_json(f)
    assert set(extra) <= {"workloads", "end_to_end", "per_layer"}
    assert [w["name"] for w in extra["workloads"]] == [f.stem]
    m = with_pending(B, f.stem)
    names = [x["name"] for k in ("end_to_end", "per_layer") for x in m[k]]
    assert len(set(names)) == len(names)
    w = extra["workloads"][0]
    assert w["config"] in {c["name"] for c in B["configs"]}
    reported = [e["name"] for e in m["end_to_end"]
                if "workloads" not in e or f.stem in e["workloads"]]
    assert "setup_s" in reported and len(reported) >= 2
    for x in extra.get("end_to_end", []):
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert 0.01 <= x["bound"] <= 0.25
    for x in extra.get("per_layer", []):
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["moves"] in reported
        assert (BENCH / "metrics" / f"{x['name']}.py").is_file()
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
