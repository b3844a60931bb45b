"""The taxi-zones deployment (``configs/approxiot-taxi-zones.json``): its
shares and fares follow the formulas the file states, a tiny cell of it
reads 0 on every number against ``reference/whs_tree.py`` and against
the configuration's ``reference/whs_tree_zones.py``, the two references
agree bitwise, and ``level_tick_passes`` reads its hand count."""
from __future__ import annotations

import json
import shutil

import numpy as np
import pytest

from conftest import ROOT, run_tiny
from harness import cell, registry, traffic
from reference import whs_tree, whs_tree_zones

CONFIG = json.loads((ROOT / "bench/configs/approxiot-taxi-zones.json")
                    .read_text())
ZONES = 263
CELL = "tiny.approxiot-taxi-zones.peak-f10"


def test_shares_and_fares_follow_the_stated_formulas():
    subs = CONFIG["stream"]["substreams"]
    assert [s["name"] for s in subs] == [f"zone-{r:03d}"
                                         for r in range(1, ZONES + 1)]
    h = sum(1.0 / r for r in range(1, ZONES + 1))
    for r, s in enumerate(subs, start=1):
        mu = 10.0 + 30.0 * (r - 1) / 262
        assert s["dist"] == "gaussian"
        assert s["share"] == pytest.approx((1.0 / r) / h, rel=1e-12)
        assert s["params"] == pytest.approx([mu, mu / 4], rel=1e-12)
    assert sum(s["share"] for s in subs) == pytest.approx(1.0, rel=1e-12)
    assert subs[0]["share"] == pytest.approx(0.163, abs=5e-4)
    assert subs[-1]["share"] == pytest.approx(0.00062, abs=5e-6)
    topo = CONFIG["topology"]
    # the tail zone's items a level-0 node a tick (two sources a node)
    tail = (CONFIG["stream"]["items_per_tick"] * subs[-1]["share"]
            * (topo["num_sources"] // topo["fanin"][0]) / topo["num_sources"])
    assert 1200 < tail < 1300
    assert CONFIG["sampler"]["allocation"] == "neyman"
    assert topo["fanin"] == [4, 2, 1] and topo["capacity"] == 2700032
    assert CONFIG["reference"] == "whs_tree_zones"


@pytest.mark.parametrize("reference", ["whs_tree", "whs_tree_zones"])
def test_tiny_cell_reads_zero_on_every_number(tiny_root, tmp_path,
                                              reference):
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    path = root / "bench/configs/tiny-approxiot-taxi-zones.json"
    cfg = json.loads(path.read_text())
    cfg["reference"] = reference
    path.write_text(json.dumps(cfg))
    r = run_tiny(root, CELL, seconds=0.3)
    assert r["correct"] is True
    assert {k: c["value"] for k, c in r["checks"].items()} == {
        "mismatches": 0, "answer_gap": 0.0, "histogram_gap": 0.0}


def test_zones_reference_is_bitwise_whs_tree(tiny_root):
    bm = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny_root / "bench/configs/"
                      "tiny-approxiot-taxi-zones.json").read_text())
    mix = registry.traffic(registry.workload(bm, CELL)["traffic"])
    pool = traffic.make_pool(cfg, mix, 2**31 + 29, "cpu")
    trees = [cell.reference_tree(ref, cfg, mix)
             for ref in (whs_tree, whs_tree_zones)]
    key = whs_tree.root_key(29)
    v, s, c = pool.epoch_host(0)
    for t in range(v.shape[0]):
        a, b = (ref.tick(tree, key, t + 1, v[t], s[t], c[t], device="cpu")
                for ref, tree in zip((whs_tree, whs_tree_zones), trees))
        assert a.keys() == b.keys()
        _same(a, b)


def _same(a, b, where="tick"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, where
        assert x.tobytes() == y.tobytes(), where


def test_level_tick_passes_reads_its_hand_count(monkeypatch):
    """Two traced ticks, each with the cell's two level ticks: [4, 2.7M]
    and [2, 540k] at 263 strata, 6 radix passes and 3 moments windows
    each: (4 + 2) x (6 + 3) = 54 passes a tick. Spans without the
    kernel's regime (the CPU's) read nothing."""
    reader = registry.metric_reader("level_tick_passes")
    regime = {"strata": ZONES, "digit_bits": 6, "radix_passes": 6,
              "moment_windows": 3}
    spans = [("run_epoch", 1.0, 1.5, {"ticks": 2})]
    for t0 in (1.1, 1.3):
        spans += [("tick", t0, t0 + 0.1, {"t": 1}),
                  ("level_tick", t0 + 0.01, t0 + 0.05,
                   {"nodes": 4, "slots": 2700032, **regime}),
                  ("level_tick", t0 + 0.06, t0 + 0.08,
                   {"nodes": 2, "slots": 540006, **regime})]
    ctx = cell.Context(None, {}, {"ticks": 2}, 2, None)
    ctx.trace = type("T", (), {"window": (1.0, 2.0)})()
    monkeypatch.setattr(reader.program_spans, "spans", lambda _: spans)
    assert reader.read(ctx) == 54.0
    cpu = [(n, s, e, {k: m[k] for k in m if k in ("nodes", "slots",
                                                  "strata")})
           for n, s, e, m in spans]
    monkeypatch.setattr(reader.program_spans, "spans", lambda _: cpu)
    assert reader.read(ctx) is None
    monkeypatch.setattr(reader.program_spans, "spans", lambda _: None)
    assert reader.read(ctx) is None
