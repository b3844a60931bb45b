"""The benchmark's CPU tests: ``python -m pytest bench/tests`` from the
checkout's root. Tests that need a card are marked ``cuda`` and skip
without one."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SRC = ROOT / "src"
sys.path[:0] = [str(BENCH), str(SRC)]

# A cell small enough for the CPU: the testbed's tree and streams at
# 12,000 items a tick.
TINY_CAPACITY = 4096
TINY_ITEMS = 12000


def make_tiny_checkout(dst: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``bench/`` in ``dst`` with a tiny
    configuration of each deployment and a tiny cell of each mix
    (``tiny.<config>.<traffic>``, with that cell's limits and on the lists
    of that cell's metrics), made by adding files and entries."""
    shutil.copytree(BENCH, dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in list(bm["configs"]):
        cfg = json.loads((ROOT / entry["file"]).read_text())
        cfg["topology"]["capacity"] = TINY_CAPACITY
        cfg["stream"]["items_per_tick"] = TINY_ITEMS
        name = f"tiny-{entry['name']}"
        rel = f"bench/configs/{name}.json"
        (dst / rel).write_text(json.dumps(cfg))
        bm["configs"].append(dict(entry, name=name, file=rel))
    tiny = {}
    for wl in list(bm["workloads"]):
        name = f"tiny.{wl['config']}.{wl['traffic']}"
        tiny[wl["name"]] = name
        if any(w["name"] == name for w in bm["workloads"]):
            continue
        bm["workloads"].append(dict(wl, name=name,
                                    config=f"tiny-{wl['config']}"))
        shutil.copy(BENCH / "limits" / f"{wl['name']}.json",
                    dst / "bench" / "limits" / f"{name}.json")
    for m in bm["end_to_end"] + bm["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [tiny[w] for w in m["workloads"]]
    (dst / "BENCHMARK.json").write_text(json.dumps(bm, indent=1))
    return dst


def run_tiny(root: Path, workload: str, seed: int = 2**31 + 7,
             seconds: float = 0.5, traced: bool = False, fault: str = "",
             timeout: float = 240) -> dict:
    """One run of a tiny cell on the CPU in a fresh process (the harness
    of ``root``; ``fault`` plants a fault from ``faults.py``) → the
    result object."""
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(root / 'bench')!r}, {str(SRC)!r}, "
        f"{str(BENCH / 'tests')!r}]\n"
        "t = time.perf_counter()\n"
        "from harness import cell\n"
        "import faults\n"
        f"faults.plant({fault!r})\n"
        f"r = cell.run({workload!r}, {seed}, {seconds}, {traced}, 'cpu', t)\n"
        "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=timeout, cwd=root)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_checkout(tmp_path_factory.mktemp("checkout"))
