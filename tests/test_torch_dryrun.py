"""The port's cost model and dry run against the reference's, on the CPU.

* Matrix-product FLOPs of the prefill step (reduced configs, B 2, S 64,
  one device): the port's ``hlocost`` count of the operations dispatched
  equals the reference's ``hlocost.analyze_text(...)["dot_flops"]`` on
  its compiled module for smollm-135m and qwen2-moe-a2.7b. For
  zamba2-1.2b and rwkv6-7b the port counts more, within ``DOT_RTOL``:
  at S 64 each layer's sequence is one chunk, whose inter-chunk product
  (mamba2's ``C·exp(l)·S``, rwkv6's ``r·S``) is taken against the zero
  initial state, a product XLA folds away (``dot(x, broadcast(0))`` is
  zero) and the port runs: the difference is exactly that product's
  operations.
* The dry run's per-chip argument bytes of smollm-135m × train_4k on the
  16×16 mesh (parameters, AdamW state, batch) equal the sum of the local
  shards the reference's ``param_specs``, ``opt_state_specs`` and
  ``batch_specs`` give its ``eval_shape`` trees.
* A cell counts the same in a fresh process and after another cell has
  run in it (DTensor's cached planning is not counted).
* The CLI runs one cell in a subprocess and writes its record.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.launch import hlocost as JH  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.optim import train_step as JT  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch import analysis, dryrun, hlocost  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import train_step as TT  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
DOT_RTOL = 0.03
EXACT = ("smollm-135m", "qwen2-moe-a2.7b")
FOLDED = ("zamba2-1.2b", "rwkv6-7b")


def _ref_dot_flops(cfg, b, s):
    p = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    text = jax.jit(JT.make_prefill_step(cfg)).lower(p, batch).compile() \
        .as_text()
    return JH.analyze_text(text)["dot_flops"]


@pytest.mark.parametrize("arch", EXACT + FOLDED)
def test_prefill_matmul_flops_match_the_references_hlocost(arch):
    b, s = 2, 64
    want = _ref_dot_flops(JR.get_config(arch).reduced(), b, s)
    cfg = TR.get_config(arch).reduced()
    params = TM.init_params(cfg, 0, "cpu")
    batch = {"tokens": torch.zeros((b, s), dtype=torch.int32)}
    _, got = hlocost.analyze(TT.make_prefill_step(cfg), params, batch)
    if arch in EXACT:
        assert got["dot_flops"] == want
    else:
        assert want < got["dot_flops"] <= want * (1 + DOT_RTOL)
        # exactly the folded product: per layer 2·(B·S·H·P)·N for
        # mamba2's C·exp(l)·S, 2·(B·S·H·V)·K for rwkv6's r·S
        if cfg.family == "hybrid":
            h = 2 * cfg.d_model // cfg.ssm_head_dim
            inter = 2 * b * s * h * cfg.ssm_head_dim * cfg.ssm_state
        else:
            k = cfg.ssm_head_dim
            inter = 2 * b * s * (cfg.d_model // k) * k * k
        assert got["dot_flops"] - want == cfg.num_layers * inter
    assert got["flops"] >= got["dot_flops"] > 0
    assert got["collectives"] == {} and got["collective_bytes"] == 0


def test_meta_tensors_count_the_same_as_real_ones():
    cfg = TR.get_config("smollm-135m").reduced()
    step = TT.make_prefill_step(cfg)
    counts = []
    for dev in ("cpu", "meta"):
        params = TM.init_params(cfg, 0, dev)
        batch = {"tokens": torch.zeros((2, 64), dtype=torch.int32,
                                       device=dev)}
        counts.append(hlocost.analyze(step, params, batch)[1])
    assert counts[0] == counts[1]


def test_roofline_terms_use_the_h100_peaks():
    t = analysis.roofline_terms(989e12, 3.35e12, 450e9)
    assert t["compute_s"] == t["memory_s"] == t["collective_s"] == 1.0
    t = analysis.roofline_terms(1.0, 2 * 3.35e12, 0.0)
    assert t["dominant"] == "memory_s" and t["step_s"] == 2.0


def _local_bytes(shapes, specs, sizes):
    """Σ over leaves of one device's shard bytes under ``specs``."""
    total = 0
    flat = jax.tree.leaves(shapes)
    sflat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert len(flat) == len(sflat)
    for leaf, spec in zip(flat, sflat):
        n = int(np.prod(leaf.shape)) * jnp.dtype(leaf.dtype).itemsize
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    n //= sizes[a]
        total += n
    return total


def test_argument_bytes_per_chip_are_the_references_shards():
    class Mesh16:
        axis_names = ("data", "model")
        shape = {"data": 16, "model": 16}

    cfg = JR.get_config("smollm-135m")
    p = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
    o = jax.eval_shape(JA.init, p)
    inputs = JR.input_specs(cfg, "train_4k")
    ps = JS.param_specs(p, Mesh16)
    want = {
        "params": _local_bytes(p, ps, Mesh16.shape),
        "opt_state": _local_bytes(o, JS.opt_state_specs(o, ps, Mesh16),
                                  Mesh16.shape),
        "inputs": _local_bytes(inputs, JS.batch_specs(inputs, Mesh16),
                               Mesh16.shape),
    }
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    try:
        dryrun._fake_group(256)
        mesh = make_production_mesh()
        _, got = dryrun.cell_step(TR.get_config("smollm-135m"),
                                  TR.SHAPES["train_4k"], mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert got == want


_COUNT_CELLS = """
import json, sys
from repro_torch.launch import dryrun
recs = [dryrun.lower_cell(a, s, multi_pod=False)
        for a, s in (c.split(":") for c in sys.argv[1:])]
print(json.dumps([{k: v for k, v in r.items() if k != "run_s"}
                  for r in recs]))
"""


def test_a_cells_count_does_not_depend_on_what_ran_before():
    cell, other = "qwen2-moe-a2.7b:decode_32k", "whisper-medium:decode_32k"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", _COUNT_CELLS, cell, other,
                          cell], env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    fresh, _, after = json.loads(run.stdout.strip().splitlines()[-1])
    assert fresh["bytes_per_chip"] > 0
    assert fresh == after


def test_cli_runs_one_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "zamba2-1.2b", "--shape", "long_500k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "done; failures=0" in run.stdout
    rec = json.loads((tmp_path / "zamba2-1.2b__long_500k__16x16.json")
                     .read_text())
    for key in ("flops_per_chip", "dot_flops_per_chip", "bytes_per_chip",
                "collective_bytes_per_chip", "collectives", "terms",
                "params", "active_params", "model_flops_per_chip",
                "model_vs_counted", "memory"):
        assert key in rec, key
    assert rec["chips"] == 256 and rec["collective_bytes_per_chip"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    # a cell the reference skips is recorded with its reason
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "long_500k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.loads((tmp_path / "smollm-135m__long_500k__16x16.json")
                     .read_text())
    ok, why = JR.shape_applicable(JR.get_config("smollm-135m"),
                                  JR.SHAPES["long_500k"])
    assert rec["skipped"] and not ok and rec["reason"] == why
