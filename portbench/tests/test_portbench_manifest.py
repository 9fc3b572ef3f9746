"""BENCHMARK.json against the contract's rules of names and sizes, and
every file a cell, configuration, mix or metric names, found by name."""
import json
import re

import pytest

from portbench.lib import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in MAN["configs"]]
             + [w["name"] for w in MAN["workloads"]]
             + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]])
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["name"] == f"{w['traffic']}.{w['config']}"
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_metric_rules():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            reported = e2e[m["moves"]].get("workloads")
            assert reported is None or cell in reported, (m["name"], cell)


def test_every_cell_reports_enough():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in MAN["end_to_end"]
               if harness._applies(m, w)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(harness._applies(m, w) for m in MAN["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(cell):
    w = harness.find_cell(MAN, cell)
    config = harness.load_json("configs", w["config"])
    traffic = harness.load_json("traffic", w["traffic"])
    driver = harness.load_module("drivers", traffic["driver"])
    for fn in ("setup", "step", "finish", "check", "yardstick"):
        assert callable(getattr(driver, fn))
    assert callable(harness.load_module("indexes", config["index"]).make)


def test_config_files():
    for c in MAN["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = harness.load_json("configs", c["name"])
        assert cfg["reduced"] == c["reduced"]
        assert cfg["k"] == 31
        assert 1 <= len(c["source"]) <= 200


@pytest.mark.parametrize("kind,entries", [
    ("metrics", MAN["per_layer"]), ("end_to_end", MAN["end_to_end"])])
def test_metric_readers_found_by_name(kind, entries):
    for m in entries:
        assert callable(harness.load_module(kind, m["name"]).read)


def test_check_budget_fits_with_24_cells():
    """A full check of 24 cells: 2 + 14 runs a cell at run_seconds + 60,
    2 x 90 s of compile a cell and 1200 s spare, within 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_a_new_cell_needs_only_new_files(tmp_path, monkeypatch):
    """A configuration, mix and metric added as new files and entries,
    with no existing file edited, are found by name."""
    for kind in ("configs", "traffic", "metrics", "drivers", "indexes",
                 "end_to_end"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "chr21_signature.json").write_text(json.dumps(
        dict(harness.load_json("configs", "wg_signature"),
             ref_bases=46700000, n_variants=1330000,
             reduced=["ref_bases", "n_variants"])))
    (tmp_path / "traffic" / "map_hashes_small.json").write_text(json.dumps(
        dict(harness.load_json("traffic", "map_hashes"),
             reads_per_request=100000)))
    (tmp_path / "metrics" / "map.requests.py").write_text(
        "def read(run):\n    return run.requests or None\n")
    monkeypatch.setattr(harness, "BENCH_DIR", tmp_path)
    assert harness.load_json("configs", "chr21_signature")["n_variants"] == \
        1330000
    assert harness.load_json("traffic", "map_hashes_small")["driver"] == \
        "map_hashes"
    assert harness.load_module("metrics", "map.requests").read(
        type("R", (), {"requests": 3})()) == 3
