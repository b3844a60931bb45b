"""Every cell's parts are found by name, and BENCHMARK.json keeps to the
contract's shape."""
from __future__ import annotations

import json
import re

import pytest

from conftest import BENCH, ROOT
from harness import registry

BM = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("wl", BM["workloads"], ids=lambda w: w["name"])
def test_cell_parts_found_by_name(wl):
    cfg = registry.config(BM, wl["config"])
    assert cfg["name"] == wl["config"]
    registry.reference(cfg["reference"])
    mix = registry.traffic(wl["traffic"])
    assert 0 < mix["fraction"] <= 1
    limits = registry.limits(wl["name"])
    assert limits["mismatches"] == 0
    assert wl["chips"] == 1


@pytest.mark.parametrize("m", BM["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_found_by_name(m):
    assert callable(registry.metric_reader(m["name"]).read)
    assert m["moves"] in {e["name"] for e in BM["end_to_end"]}


@pytest.mark.parametrize("name", sorted(p.stem for p in
                                        (BENCH / "bytes").glob("*.py")))
def test_byte_counts_found_by_name(name):
    assert callable(registry.byte_count(name).least_bytes)


def test_every_roofline_has_a_byte_count():
    for m in BM["per_layer"]:
        if m["name"].endswith("_roofline"):
            kernel = m["name"][:-len("_roofline")]
            assert (BENCH / "bytes" / f"{kernel}.py").is_file()
            assert m["unit"] == "%"


def test_benchmark_json_shape():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["paths"] == ["bench"]
    assert 1 <= BM["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BM[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and c["reduced"] == []
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BM["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    assert {m["name"] for m in BM["end_to_end"]} == {
        "items_per_s", "window_p95_ms", "window_p95_ms.tenants", "setup_s"}
    assert {registry.quantity(m) for m in BM["end_to_end"]} == {
        "items_per_s", "window_p95_ms", "setup_s"}
    assert len(json.dumps(BM)) < 64 * 1024


@pytest.mark.parametrize("wl", BM["workloads"], ids=lambda w: w["name"])
def test_cell_reports_setup_another_end_to_end_metric_and_what_it_moves(wl):
    e2e = {m["name"] for m in registry.cell_metrics(BM, wl["name"], False)}
    per_layer = registry.cell_metrics(BM, wl["name"], True)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert per_layer
    # A per-layer metric moves an end-to-end metric of every cell it lists.
    assert all(m["moves"] in e2e for m in per_layer), wl["name"]
