"""BENCHMARK.json against the benchmark's contract: names and units, the
files each entry points to, and every per-layer metric's ``moves`` reported
in every cell it lists."""
import json
import os
import re

import pytest

from conftest import ROOT

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
BENCH = os.path.join(ROOT, "port_bench")


def names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[key]:
            yield entry["name"]
    for w in SPEC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(names())))
def test_names_are_plain(name):
    assert NAME.fullmatch(name), name


def test_units_and_sides():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher"), m


def test_keys_and_bounds():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace"), m
    for m in SPEC["per_layer"]:
        assert "bound" not in m and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock"), m
    for text in [w["why"] for w in SPEC["workloads"]] + [c["why"] for c in SPEC["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_files_each_entry_names_exist():
    for c in SPEC["configs"]:
        assert c["file"].startswith("port_bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert os.path.exists(os.path.join(BENCH, "configs", f"{c['name']}.py"))
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        traffic = json.load(open(os.path.join(BENCH, "traffic", f"{w['traffic']}.json")))
        assert os.path.exists(os.path.join(BENCH, "drivers", f"{traffic['driver']}.py"))
    for m in SPEC["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{m['name']}.py")), m["name"]
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}


def test_every_moves_is_reported_where_the_metric_is():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s", m
        listed = e2e[m["moves"]].get("workloads", sorted(cells))
        assert m["workloads"], m["name"]
        for w in m["workloads"]:
            assert w in cells and w in listed, (m["name"], w)
    for w in cells:
        reported = [n for n, m in e2e.items() if w in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2, w
        assert any(w in m["workloads"] for m in SPEC["per_layer"]), w
