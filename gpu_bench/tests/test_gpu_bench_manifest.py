"""``BENCHMARK.json`` against the rules it keeps (names, units, keys,
bounds, what each cell reports), and every piece it names found by name
under ``gpu_bench/``."""

from __future__ import annotations

import os
import re

import pytest

from gpu_bench import harness

BENCH = harness.Bench()
SPEC = BENCH.spec
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == KEYS["top"]
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_entries_keys_and_names(group):
    entries = SPEC[group]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = set(e) - KEYS[group]
        assert KEYS[group] <= set(e)
        assert extra <= ({"workloads"} if group in ("end_to_end",
                                                    "per_layer") else set())
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"])
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e and group != "end_to_end":
                assert _line(e[key])


def test_metric_names_unique_across_groups():
    names = [m["name"] for g in ("end_to_end", "per_layer") for m in SPEC[g]]
    assert len(names) == len(set(names))


def test_configs_files_and_reduced():
    for c in SPEC["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_found_by_name(cell):
    w = BENCH.workload(cell)
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and _line(w["why"])
    cfg = BENCH.config(w["config"])
    assert callable(BENCH.model(w["config"]).build)
    mix = BENCH.mix(w["traffic"])
    part = BENCH.part(w["config"], BENCH.loop(mix["kind"]).MODE)
    assert part.flops_per_sample(cfg) > 0
    limits = BENCH.limits(cell)
    assert limits, f"{cell} has no limits file"
    for m in BENCH.per_layer(cell):
        assert callable(BENCH.reader(m["name"]).read)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = {m["name"] for m in BENCH.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = BENCH.per_layer(cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e


def test_pairs_of_config_and_traffic_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_run_seconds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    # the full check of 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_layers_named_as_perf_md_lists_them():
    """Every metric's layer is a layer of PERF.md's list, letter for
    letter (the first column of its section 3 table)."""
    text = open(os.path.join(harness.ROOT, "PERF.md")).read()
    section = text.split("## 3. Layers", 1)[1].split("\n## ", 1)[0]
    listed = {row.split("|")[1].strip() for row in section.splitlines()
              if row.startswith("| ") and not row.startswith("| Layer")}
    assert {m["layer"] for m in SPEC["per_layer"]} <= listed


def test_roofline_and_mfu_names():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
