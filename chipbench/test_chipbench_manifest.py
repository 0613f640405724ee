"""The manifest against the contract's rules, the files it names, and a
metric added by a file and an entry alone."""

import json
import re
import shutil

import pytest

from chipbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_names_units_and_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51
    names = [c["name"] for c in manifest["configs"]] + \
        [w["name"] for w in manifest["workloads"]] + \
        [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in manifest["workloads"]]:
        assert NAME.match(n), n
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in manifest["end_to_end"]} >= {"setup_s"}
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_what_its_metrics_move(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for w in m.get("workloads", cells):
            assert w in cells and w in e2e[m["moves"]], (m["name"], w)
    for w in cells:
        assert w in e2e["setup_s"]
        assert any(w in v for k, v in e2e.items() if k != "setup_s")
        assert any(w in m.get("workloads", cells)
                   for m in manifest["per_layer"])
    four = [w for w in manifest["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)


def test_every_name_finds_its_files(manifest):
    root = harness.ROOT
    for c in manifest["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in manifest["workloads"]:
        cell = harness.Cell(manifest, w["name"])
        assert cell.limits and callable(harness.driver(cell).run_cell)
    for m in manifest["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_a_metric_is_added_by_a_file_and_an_entry(manifest, tmp_path):
    """A later change adds a reader and a manifest entry in a copy,
    editing no file that is there, and the harness reports it."""
    shutil.copytree(harness.BENCH, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "chipbench").rglob("*") if p.is_file()}
    (tmp_path / "chipbench" / "metrics" / "dummy_count.train.py").write_text(
        "def read(rec):\n    return rec['n_steps'] * 2\n")
    new = dict(manifest)
    cell = manifest["workloads"][0]["name"]
    new["per_layer"] = manifest["per_layer"] + [
        {"name": "dummy_count.train", "unit": "count", "better": "lower",
         "source": "program_counter", "layer": "trainer",
         "moves": "setup_s", "workloads": [cell]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "chipbench").rglob("*") if p.is_file()
             and p.name != "dummy_count.train.py"}
    assert after == before
    c = harness.Cell(harness.load_manifest(tmp_path), cell, root=tmp_path)
    got = harness.per_layer_values(c, {"n_steps": 21}, root=tmp_path)
    assert got["dummy_count.train"] == {"value": 42.0, "unit": "count"}
