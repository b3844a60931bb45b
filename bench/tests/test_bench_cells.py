"""Tiny cells run end to end on the CPU: the result line, a mix added as
a file, the generator's seed, and the output check against planted
faults and its bfloat16 control."""
from __future__ import annotations

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, SRC, run_tiny
from harness import compare, registry, traffic

CELL = "tiny.approxiot-testbed.peak-f10"


def test_result_line_schema(tiny_root):
    r = run_tiny(tiny_root, CELL)
    assert r["correct"] is True
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(compare.NUMBERS)
    assert set(r["metrics"]) == {"items_per_s", "window_p95_ms", "setup_s"}
    assert r["attempted"] > 0 and r["failed"] == 0
    for m in r["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        r["device"])
    sys.path.insert(0, str(BENCH))
    import run as runner

    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        runner.report(r)
    assert json.loads(out.getvalue().splitlines()[-1]) == r
    lines = err.getvalue().splitlines()
    assert [ln.split()[1] for ln in lines] == list(r["checks"])


def test_traced_run_reports_per_layer_metrics_it_can_read(tiny_root):
    r = run_tiny(tiny_root, "tiny.approxiot-skew.peak-f10", traced=True)
    assert r["correct"] is True
    # The CPU has no device trace: only the host-clock metrics are read.
    assert set(r["metrics"]) == {"dispatch_ms", "readback_ms"}


def test_a_mix_added_as_a_file_runs(tiny_root, tmp_path):
    import shutil

    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    (root / "bench" / "traffic" / "peak-f30-e2.json").write_text(json.dumps(
        {"fraction": 0.3, "ticks_per_epoch": 2, "pool_epochs": 3,
         "loop": "closed", "in_flight": 1, "ingest": "device"}))
    bm = json.loads((root / "BENCHMARK.json").read_text())
    bm["workloads"].append({"name": "tiny.new", "config":
                            "tiny-approxiot-skew", "traffic": "peak-f30-e2",
                            "chips": 1, "why": "a new mix"})
    (root / "BENCHMARK.json").write_text(json.dumps(bm))
    (root / "bench" / "limits" / "tiny.new.json").write_text(
        (root / "bench" / "limits" / f"{CELL}.json").read_text())
    r = run_tiny(root, "tiny.new")
    assert r["correct"] is True and r["attempted"] % 2 == 0


def test_generator_repeats_for_a_seed():
    cfg = json.loads((ROOT / "bench/configs/approxiot-skew.json").read_text())
    cfg["topology"]["capacity"] = 2048
    cfg["stream"]["items_per_tick"] = 6000
    mix = registry.traffic("peak-f10")
    seed = 2**31 + 99
    a = traffic.make_pool(cfg, mix, seed, "cpu")
    b = traffic.make_pool(cfg, mix, seed, "cpu")
    c = traffic.make_pool(cfg, mix, seed + 1, "cpu")
    assert len(a) == mix["pool_epochs"]
    for e in range(len(a)):
        for x, y in zip(a.epoch_host(e), b.epoch_host(e)):
            np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a.values[0], c.values[0])
    v, s, n = a.epoch_host(0)
    assert v.shape == (4, 4, 2048) and n.shape == (4, 4)
    # Sub-stream shares: 80% of the items in stratum 0.
    valid = np.arange(2048)[None, None, :] < n[..., None]
    share = (s[valid] == 0).mean()
    assert 0.75 < share < 0.85
    assert np.all(v[~valid] == 0)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered", "item_altered"])
def test_planted_fault_fails_the_check(tiny_root, fault):
    r = run_tiny(tiny_root, CELL, fault=fault)
    assert r["correct"] is False, r["checks"]


def test_bfloat16_control_fails_the_limits(tiny_root):
    code = ("import sys, json; sys.path[:0] = [%r, %r]\n"
            "import control\n"
            "from harness import compare, registry\n"
            "n = control.control_numbers(%r, 5, 4, 'cpu')\n"
            "print(json.dumps([n, compare.verdict(n, "
            "registry.limits(%r))]))\n"
            % (str(tiny_root / "bench"), str(SRC), CELL, CELL))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tiny_root, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    numbers, ok = json.loads(out.stdout.splitlines()[-1])
    assert ok is False and numbers["mismatches"] > 0


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "testbed.peak-f10", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_cell_is_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "testbed.peak-f10", "--seed", "4242", "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"] is True
