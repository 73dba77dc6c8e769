"""The manifest keeps to the benchmark's contract, and everything a run is
made of is found by name: a configuration, a workload and a metric reader
added under another directory are found without editing any file."""

import json
import re
import shutil

import pytest

from benchmark.harness import catalog

MAN = catalog.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_shape():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"] and MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in MAN[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    cfg = json.loads((catalog.ROOT / entry["file"]).read_text())
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for text in (entry["source"], entry["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda e: e["name"])
def test_cell_reports_what_the_contract_asks(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"} and cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    wl = catalog.workload(cell["name"])
    assert wl["config"] == cell["config"]
    e2e = [m["name"] for m in catalog.cell_metrics(MAN, cell["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = catalog.cell_metrics(MAN, cell["name"], True)
    assert per_layer and all(m["moves"] in e2e for m in per_layer)
    assert catalog.loop(wl["loop"]).Loop
    assert catalog.problem(catalog.config(wl["config"])["problem"]).program


@pytest.mark.parametrize("entry", MAN["end_to_end"] + MAN["per_layer"], ids=lambda e: e["name"])
def test_reader_declares_its_manifest_entry(entry):
    """Each metric has its reader; its declaration is its manifest entry."""
    assert callable(catalog.reader(entry["name"]).read)
    assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    cells = {w["name"] for w in MAN["workloads"]}
    assert set(entry.get("workloads", cells)) <= cells
    if entry in MAN["per_layer"]:
        assert set(entry) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert entry["moves"] in {m["name"] for m in MAN["end_to_end"]}
        assert 1 <= len(entry["layer"]) <= 200 and "\n" not in entry["layer"]
    else:
        assert entry["source"] in ("host_clock", "device_trace") and 0.01 <= entry["bound"] <= 0.25


def test_files_added_elsewhere_are_found_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    for sub in ("configs", "workloads", "metrics", "problems"):
        shutil.copytree(catalog.BENCH / sub, bench / sub)
    (bench / "problems" / "heat_scaled.py").write_text(
        "from benchmark.problems.heat import *  # noqa: F403\n\nSCALE = 2.0\n")
    cfg = dict(catalog.config("heat_gramfree_1e5"), name="heat_small", n=2000, problem="heat_scaled")
    (bench / "configs" / "heat_small.json").write_text(json.dumps(cfg))
    wl = dict(catalog.workload("heat.condition"), config="heat_small")
    (bench / "workloads" / "heat_small.condition.json").write_text(json.dumps(wl))
    (bench / "metrics" / "steps.py").write_text("def read(rec):\n    return len(rec.steps)\n")
    before = sorted(p.name for p in catalog.BENCH.rglob("*") if p.is_file())
    assert catalog.config("heat_small", bench)["n"] == 2000
    assert catalog.workload("heat_small.condition", bench)["config"] == "heat_small"
    prob = catalog.problem(catalog.config("heat_small", bench)["problem"], bench)
    assert prob.SCALE == 2.0 and prob.noise_variance(cfg) == catalog.problem("heat").noise_variance(cfg)
    rec = type("Rec", (), {"steps": [1, 2, 3]})()
    assert catalog.reader("steps", bench).read(rec) == 3
    # The existing files are found there too, and nothing of the harness changed.
    assert catalog.reader("condition_s", bench).read(type("Rec", (), {"steps": [1, 2], "window_s": 3.0})()) == 1.5
    assert sorted(p.name for p in catalog.BENCH.rglob("*") if p.is_file()) == before
