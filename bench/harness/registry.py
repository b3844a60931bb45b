"""Everything a cell is made of, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, their
configurations and metrics. Beside it, under ``bench/``:

* ``configs/<config>.json``: a deployment (the file ``BENCHMARK.json``
  gives), naming its plain reference ``reference/<name>.py``;
* ``traffic/<traffic>.json``: a traffic mix, read by ``traffic.py``;
* ``limits/<workload>.json``: the limit of each number the output check
  compares in that cell;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a
  function ``read(ctx) -> float | None``;
* an end-to-end metric named ``<quantity>.<suffix>`` measures
  ``<quantity>`` (``quantity``) under a bound of its own, in the cells
  it lists; a per-layer metric that moves it is named the same way;
* ``bytes/<name>.py``: the least bytes of one kernel (``KERNEL``, its
  name in the device trace) or of the whole window.

A new cell, mix, metric or byte count is a new file; no code changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} does not exist")
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; known: "
                   f"{sorted(e['name'] for e in entries)}")


def workload(bm: dict, name: str) -> dict:
    return _named(bm["workloads"], name, "workload")


def config(bm: dict, name: str) -> dict:
    entry = _named(bm["configs"], name, "configuration")
    return _json(ROOT / entry["file"])


def traffic(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    return _json(BENCH / "limits" / f"{workload_name}.json")


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return _module(BENCH / "metrics" / f"{name}.py", f"bench_metric_{name}")


def byte_count(name: str):
    return _module(BENCH / "bytes" / f"{name}.py", f"bench_bytes_{name}")


def reference(name: str):
    return _module(BENCH / "reference" / f"{name}.py", f"bench_ref_{name}")


def quantity(metric: dict) -> str:
    """What an end-to-end metric measures: its name up to the first dot.
    ``window_p95_ms.tenants`` is ``window_p95_ms`` held to a bound of its
    own in the cells it lists."""
    return metric["name"].split(".", 1)[0]


def cell_metrics(bm: dict, workload_name: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics (``traced`` false) or per-layer
    metrics (true): those with no ``workloads`` key, and those that list
    the cell."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in bm[key]
            if workload_name in m.get("workloads", [workload_name])]
