"""The plain reference against the port's CPU path, the byte counts at
the cells' shapes, and the import guard."""
from __future__ import annotations

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, SRC
from harness import cell, compare, guard, registry

ref = registry.reference("whs_tree")


def _ingest(rng, shares, kind, width=4096, ticks=3, per_node=1500):
    """Level-0 ingest of 4 nodes, 2 sources each, 4 sub-streams."""
    vals = np.zeros((ticks, 4, width), np.float32)
    strata = np.zeros((ticks, 4, width), np.int32)
    counts = np.zeros((ticks, 4), np.int32)
    for t in range(ticks):
        for k in range(4):
            parts, ss = [], []
            for _ in range(2):
                for x, share in enumerate(shares):
                    n = rng.poisson(per_node * share / 2)
                    if kind == "gaussian":
                        v = rng.normal(10.0 ** (x + 1), 5.0 * 10 ** x, n)
                    else:
                        v = rng.poisson((10, 100, 1e3, 1e7)[x], n)
                    parts.append(v)
                    ss.append(np.full(n, x))
            v = np.concatenate(parts)[:width]
            vals[t, k, :len(v)] = v
            strata[t, k, :len(v)] = np.concatenate(ss)[:width]
            counts[t, k] = len(v)
    return vals, strata, counts


@pytest.mark.parametrize("allocation,fraction,kind", [
    ("fair", 0.1, "gaussian"), ("fair", 0.8, "gaussian"),
    ("neyman", 0.1, "poisson"), ("neyman", 0.8, "poisson")])
def test_reference_is_the_port_bit_for_bit(allocation, fraction, kind):
    from repro_torch.api import (PipelineSpec, SamplerSpec, TelemetrySpec,
                                 TopologySpec, compile)

    shares = ((0.25,) * 4 if kind == "gaussian"
              else (0.8, 0.1989, 0.001, 0.0001))
    vals, strata, counts = _ingest(np.random.default_rng(3), shares, kind)
    seed = 12345
    spec = PipelineSpec(
        topology=TopologySpec(fanin=(4, 2, 1), capacity=4096, num_strata=4),
        sampler=SamplerSpec(mode="whs", backend="pallas_fused",
                            allocation=allocation, fraction=fraction),
        seed=seed, telemetry=TelemetrySpec(True))
    pipe = compile(spec, device="cpu")
    state, wa = pipe.run_epoch(pipe.init(), pipe.default_key, vals, strata,
                               counts)
    tree = ref.Tree((4, 2, 1), 4096, 4, fraction, allocation)
    for t in range(3):
        r = ref.tick(tree, ref.root_key(seed), t + 1, vals[t], strata[t],
                     counts[t], device="cpu")
        prog = {f: getattr(wa, f)[t].numpy() for f in
                ("ok", "n_sampled", "histogram") + compare.ANSWERS}
        prog["n_forwarded"] = list(wa.n_forwarded[t].numpy())
        assert compare.compare_tick(prog, r) == (0, 0.0, 0.0)
    final = cell._host_state(state)
    assert compare.compare_levels(final["levels"], r["levels"]) == (0, 0.0)
    flows = ref.count_replay(tree, counts)
    for f in ("items_in", "items_kept", "flushes", "saturation_hits"):
        np.testing.assert_array_equal(final["telemetry"][f], flows[f])


def test_uniforms_are_the_ports_priorities():
    from repro_torch.core import prng

    key = ref.node_key(ref.root_key(7), 3, 1, 2)
    got = ref.uniforms(key, 1000, "cpu")
    k = prng.fold_in(prng.fold_in(prng.fold_in(prng.PRNGKey(7), 3), 1), 2)
    assert torch.equal(got, prng.uniform(k, (1000,)))


def test_byte_counts_at_the_cells_shapes():
    # One tick at f = 0.1 with exactly 8M items: every node keeps
    # int(2,700,032 × 0.1) = 270,003; a level-1 node takes 2 × 270,003.
    keep = 270_003
    flows = {"level_in": [8_000_000, 4 * keep, 2 * keep],
             "level_out": [4 * keep, 2 * keep, keep]}
    cfg = registry.config(registry.benchmark(), "approxiot-testbed")
    assert registry.byte_count("fused_level_tick").least_bytes(
        flows, cfg) == (
        8 * (8_000_000 + 4 * keep + 4 * keep + 2 * keep))
    assert registry.byte_count("window").least_bytes(flows, cfg) == 92_080_312
    # f = 0.8: level 0 keeps all 8M, the upper nodes 2,160,025 each.
    keep = 2_160_025
    flows = {"level_in": [8_000_000, 8_000_000, 2 * keep],
             "level_out": [8_000_000, 2 * keep, keep]}
    assert registry.byte_count("window").least_bytes(flows, cfg) == 8 * (
        24_000_000 + 5 * keep)


def test_guard_compares_whole_top_level_names():
    assert guard.loaded_forbidden({"jax": 0, "jax.numpy": 0, "flax": 0,
                                   "repro.core": 0, "repro_torch": 0,
                                   "repro_torch.core": 0, "jaxtyping": 0}
                                  ) == ["flax", "jax", "jax.numpy",
                                        "repro.core"]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "from harness import registry\n"
            "registry.reference('whs_tree')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax')]\n"
            "assert not bad, bad\n" % str(BENCH))
    subprocess.run([sys.executable, "-c", code], check=True)


def test_no_file_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in guard.FORBIDDEN, (path, n)
                if "reference" in path.parts:
                    assert n.split(".")[0] != "repro_torch", (path, n)


def test_harness_start_up_refuses_jax_loaded():
    code = ("import sys, types; sys.modules['jax'] = types.ModuleType('jax')\n"
            "sys.argv = ['run.py', '--workload', 'testbed.peak-f10', "
            "'--seed', '1', '--seconds', '1']\n"
            "sys.path[:0] = [%r]\n"
            "import runpy; runpy.run_path(%r, run_name='__main__')\n"
            % (str(SRC), str(BENCH / "run.py")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode != 0 and out.stdout == ""
    assert "jax" in out.stderr
