"""BENCHMARK.json against the contract: keys, names, units, and every file
it names found by name."""

import json
import os
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(b["command"]) <= 32
    for w in b["command"]:
        assert LINE.match(w) and not w.startswith("/") and ".." not in w
        if w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024


def test_names_units_and_entries():
    b = bench()
    seen = set()
    for kind, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                       ("workloads", {"name", "config", "traffic", "chips", "why"})):
        assert 1 <= len(b[kind]) <= 24
        for e in b[kind]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and LINE.match(e["why"])
    for c in b["configs"]:
        assert LINE.match(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert LINE.match(m["layer"])


def test_every_cell_finds_its_files_and_reports_its_metrics():
    from port_bench import harness

    b = bench()
    configs = {c["name"] for c in b["configs"]}
    used = set()
    pairs = set()
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        traffic = harness.data_file("traffic", w["traffic"], ROOT)
        assert harness.entry(traffic["entry"], ROOT).run
        e2e, layer = harness.cell_metrics(b, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        for m in layer:
            assert os.path.isfile(os.path.join(ROOT, "port_bench", "metrics",
                                               m["name"] + ".py"))
    assert used == configs
    cells = {w["name"] for w in b["workloads"]}
    e2e_cells = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        # the metric it moves is reported in each cell that reports it
        assert set(m.get("workloads", cells)) <= e2e_cells[m["moves"]]
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_config_files_state_their_deployment():
    b = bench()
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        for key in ("source", "precision", "guarantees", "grid", "fusion",
                    "camera", "reference"):
            assert key in cfg, (c["name"], key)
