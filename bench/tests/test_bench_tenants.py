"""A deployment's standing queries: tenants built from the configuration,
their answers and sketch state against the plain reference, the faults
and the control that must fail the check, and the sketch kernels' byte
counts."""
from __future__ import annotations

import importlib.util
import io
import json
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from conftest import BENCH, ROOT, SRC, run_tiny
from harness import cell, compare, registry, tenants, traffic

CELL = "tiny.approxiot-testbed-tenants.peak-f10"
TENANTS = "approxiot-testbed-tenants"
BM = registry.benchmark()
ref = registry.reference("whs_tree")
qref = registry.reference("standing_queries")


@pytest.mark.parametrize("wl", [w for w in BM["workloads"]
                                if "tenants" not in registry.config(
                                    BM, w["config"])],
                         ids=lambda w: w["name"])
def test_tenant_free_cell_builds_the_same_spec_and_reads_the_same_fields(wl):
    from repro_torch.api import (PipelineSpec, SamplerSpec, TelemetrySpec,
                                 TopologySpec)

    cfg = registry.config(BM, wl["config"])
    mix = registry.traffic(wl["traffic"])
    seed = 2**31 + 12345
    topo, samp = cfg["topology"], cfg["sampler"]
    want = PipelineSpec(
        topology=TopologySpec(fanin=tuple(topo["fanin"]),
                              capacity=int(topo["capacity"]),
                              interval_ticks=tuple(topo["interval_ticks"]),
                              num_strata=len(cfg["stream"]["substreams"])),
        sampler=SamplerSpec(mode=samp["mode"], backend=samp["backend"],
                            allocation=samp["allocation"],
                            fraction=float(mix["fraction"])),
        seed=seed % (1 << 31),
        telemetry=TelemetrySpec(enabled=bool(cfg["telemetry"])))
    spec = cell.build_spec(cfg, mix, seed)
    assert spec == want and spec.tenants == ()
    assert cell.readback_fields(spec) == (
        "tick", "ok", "sum", "sum_var", "mean", "mean_var", "n_sampled",
        "histogram", "n_forwarded") == cell.FIELDS


def test_tenants_config_builds_the_smoke_tests_registries():
    from repro_torch.query import QueryRegistry

    loader = importlib.util.spec_from_file_location(
        "chip_smoke_for_bench", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(smoke)
    cfg = registry.config(BM, TENANTS)
    spec = cell.build_spec(cfg, registry.traffic("peak-f10"), 7)
    assert spec.tenants == (
        smoke.k8_registry(QueryRegistry).as_tenant("k8"),
        smoke.serve_registry(QueryRegistry).as_tenant("dashboard"))
    assert {q.kind for t in spec.tenants for q in t.queries} == set(
        qref.SKETCH_KINDS + qref.HH_KINDS
        + ("sum", "count", "mean", "histogram"))
    assert cell.readback_fields(spec) == cell.FIELDS + ("answers", "bounds")
    without = {k: v for k, v in cfg.items() if k != "tenants"}
    assert cell.build_spec(without, registry.traffic("peak-f10"), 7) == (
        cell.build_spec(registry.config(BM, "approxiot-testbed"),
                        registry.traffic("peak-f10"), 7))


def _tiny_tenants_cfg():
    cfg = registry.config(BM, TENANTS)
    cfg["topology"]["capacity"] = 4096
    cfg["stream"]["items_per_tick"] = 12000
    return cfg


def test_reference_is_the_ports_standing_queries():
    """Three epochs of four windows, so that the ring of four windows
    turns over and the decayed table carries state: every answer and the
    sketches' state bitwise, the bounds to the rounding of their two
    unordered sums."""
    from repro_torch.api import compile as compile_pipeline

    cfg = _tiny_tenants_cfg()
    mix = registry.traffic("peak-f10")
    seed = 2**31 + 77
    spec = cell.build_spec(cfg, mix, seed)
    pool = traffic.make_pool(cfg, mix, seed, "cpu")
    pipe = compile_pipeline(spec, device="cpu")
    state = pipe.init()
    epochs, states = [], {}
    for e in range(3):
        state, wa = pipe.run_epoch(state, pipe.default_key, pool.values[e],
                                   pool.strata[e], pool.counts[e])
        epochs.append({"pool": e, "window": e > 0, "answers": {
            f: getattr(wa, f).numpy()
            for f in cell.readback_fields(spec)}})
        states[e] = tenants.host_state(state.tree.qstate, pipe.plan)
    tree = cell.reference_tree(ref, cfg, mix)
    plan = qref.Plan(cfg["tenants"], tree.num_strata)
    assert plan.n_out == pipe.plan.n_out == 86
    # The three chained from init in the reference's own state; the last
    # alone, from the port's state at its start; and all three by hand.
    limits = registry.limits("tenants.peak-f10")
    for checked in ([0, 1, 2], [2]):
        numbers = compare.check_queries(ref, tree, ref.root_key(spec.seed),
                                        pool, epochs, qref, plan, states,
                                        checked, "cpu")
        assert numbers["query_mismatches"] == 0
        assert numbers["query_answer_gap"] == 0.0
        assert numbers["query_bound_gap"] <= limits["query_bound_gap"]
    rstate = plan.init()
    for k in range(12):
        v, s, c = pool.epoch_host(k // 4)
        r = ref.tick(tree, ref.root_key(spec.seed), k + 1, v[k % 4],
                     s[k % 4], c[k % 4], device="cpu")
        rstate, a, b = plan.window(rstate, r["root"], ref.node_key(
            ref.root_key(spec.seed), k + 1, 2, 0))
        got = epochs[k // 4]["answers"]
        np.testing.assert_array_equal(got["answers"][k % 4], a)
        np.testing.assert_allclose(got["bounds"][k % 4], b, rtol=1e-6)
    assert compare.compare_query_state(states[2], rstate,
                                       qref.INTEGER_FIELDS) == (0, 0.0)


def test_tenants_cell_result_line(tiny_root):
    r = run_tiny(tiny_root, CELL)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"window_p95_ms.tenants", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r["checks"]) == list(compare.NUMBERS + compare.QUERY_NUMBERS)
    assert r["checks"]["query_mismatches"]["value"] == 0
    assert r["checks"]["query_answer_gap"]["value"] == 0.0
    sys.path.insert(0, str(BENCH))
    import run as runner

    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        runner.report(r)
    assert json.loads(out.getvalue().splitlines()[-1]) == r
    assert [ln.split()[1] for ln in err.getvalue().splitlines()] == list(
        r["checks"])


def test_traced_tenants_run_reports_its_own_per_layer_metrics(tiny_root):
    r = run_tiny(tiny_root, CELL, traced=True)
    assert r["correct"] is True
    # The CPU has no device trace: only the host-clock metrics are read.
    assert set(r["metrics"]) == {"dispatch_ms.tenants", "readback_ms.tenants",
                                 "items_per_s.tenants"}
    assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("fault,number", [
    ("hh_key_flipped", "query_mismatches"),
    ("compaction_offset", "query_answer_gap"),
    ("decay_skipped", "query_answer_gap"),
    ("state_unchanged", "mismatches"), ("half_batch", "mismatches"),
    ("answer_altered", "answer_gap"), ("item_altered", "mismatches")])
def test_planted_fault_fails_the_tenants_cell(tiny_root, fault, number):
    r = run_tiny(tiny_root, CELL, fault=fault)
    assert r["correct"] is False, r["checks"]
    c = r["checks"][number]
    assert c["value"] > c["limit"], r["checks"]


def test_bfloat16_control_fails_each_query_number(tiny_root):
    code = ("import sys, json; sys.path[:0] = [%r, %r]\n"
            "import control\n"
            "from harness import registry\n"
            "n = control.control_numbers(%r, 5, 3, 'cpu')\n"
            "print(json.dumps([n, registry.limits(%r)]))\n"
            % (str(tiny_root / "bench"), str(SRC), CELL, CELL))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tiny_root, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    numbers, limits = json.loads(out.stdout.splitlines()[-1])
    for name in compare.QUERY_NUMBERS:
        assert numbers[name] > 10 * max(limits[name], 1), (name, numbers)
    # Also where the reference is not 0, and not by the gap's floor alone.
    for name in ("query_answer_gap", "query_bound_gap"):
        assert numbers[name + ".nonzero"] > 10 * limits[name], (name, numbers)


def test_query_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "from harness import registry\n"
            "registry.reference('standing_queries')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax')]\n"
            "assert not bad, bad\n" % str(BENCH))
    subprocess.run([sys.executable, "-c", code], check=True)


def test_interval_sum_is_the_ports_compaction():
    """On intervals from a blocked scan with dips, in any order of
    targets, each target sums every slot that holds it, in slot order."""
    import torch

    from repro_torch.kernels.sketch_update import ref as port

    rng = np.random.default_rng(5)
    for p, m in ((1000, 64), (40_000, 128), (17, 5)):
        w = rng.exponential(1.0, p).astype(np.float32)
        w[rng.random(p) < 0.3] = 0.0
        cum = qref.blocked_cumsum(w)
        lo = np.concatenate([[np.float32(0)], cum[:-1]]).astype(np.float32)
        v = rng.normal(0, 100, p).astype(np.float32)
        t = ((np.arange(m, dtype=np.float32) + np.float32(rng.random()))
             * np.float32(cum[-1] / np.float32(m))).astype(np.float32)
        for targets in (t, t[::-1].copy()):
            want = port.quantile_compact(*(torch.from_numpy(a) for a in
                                           (v, lo, cum, targets))).numpy()
            np.testing.assert_array_equal(
                qref.interval_sum(v, lo, cum, targets), want)
        from repro_torch.query.sketches import blocked_cumsum

        np.testing.assert_array_equal(
            blocked_cumsum(torch.from_numpy(w)).numpy(), cum)


def test_sketch_byte_counts_at_the_cells_shapes():
    """One window of the cell: 270,003 items sampled at the root, whose
    buffer holds 540,006 slots. Each count is below what the kernels'
    plain versions read and write."""
    cfg = registry.config(BM, TENANTS)
    sampled, slots = 270_003, 540_006
    flows = {"level_in": [8_000_000, 4 * sampled, 2 * sampled],
             "level_out": [4 * sampled, 2 * sampled, sampled],
             "ticks": 1, "sampled_ticks": 1}
    cms = registry.byte_count("cms_update").least_bytes(flows, cfg)
    assert cms == 2 * 8 * sampled + 2 * 4 * 4
    # Plain: every slot's key and weight, the whole table written.
    assert cms <= 2 * 8 * slots + 4 * 4 * (1024 + 256)
    qc = registry.byte_count("quantile_compact").least_bytes(flows, cfg)
    targets = 3 * (3 * 128 + 256) + 2 * (3 * 64 + 128)
    assert qc == 8 * targets + 4 * 4 * sampled
    # Plain: every slot's value and interval ends at each of 20 levels,
    # the targets read and the values written.
    assert qc <= 4 * 12 * (slots + 256) + 8 * targets
    # The window's least bytes take the sketch kernels' beside the tree's.
    tree = 8 * (8_000_000 + 2 * 4 * sampled + 2 * 2 * sampled + sampled)
    assert registry.byte_count("window").least_bytes(flows, cfg) == (
        tree + cms + qc)
    empty = dict(flows, level_out=[0, 0, 0], sampled_ticks=0)
    assert registry.byte_count("cms_update").least_bytes(empty, cfg) == 0
