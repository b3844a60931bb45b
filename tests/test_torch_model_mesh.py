"""The port's model mesh against the reference's sharded runs, on the CPU.

The reference runs in one subprocess with eight forced host devices and
**Auto** mesh axes (on jax 0.9.0 ``jax.make_mesh`` makes Explicit axes
by default, which ``with_sharding_constraint`` refuses), its steps
jitted with the sharding rules' ``in_shardings`` under ``use_mesh``. The
port runs on four gloo CPU ranks (``data 2 × model 2``), spawned once
for the file (``tests/torch_model_mesh_ranks.py``), with the same
carried weights and batches, concurrently with the reference.

* ``moe_apply`` in ``G = 4`` groups (the port on one process under a
  stand-in ``(4, 2)`` mesh of names and sizes, the reference under a
  ``(4, 2)`` mesh): at capacity factor 8
  nothing drops and the outputs agree within ``MOE_TOL`` of the output's
  scale; at capacity factor 1 each group drops on its own, and the kept
  set (the reference's from its own top-k and grouped rank cumsum on its
  gates) is bitwise the port's, ``aux`` equal to ``TOL``. Under the
  ``(2, 2)`` rank mesh every rank's kept set is its group's of the
  reference's ``G = 2`` dispatch.
* Attention on both of the reference's mesh branches: kv heads dividing
  the model axis (grouped) and not (K/V repeated to every head), once
  with heads that the model axis does not divide (padded), with the
  einsum core (``"xla"``) and the flash kernel (``"pallas"``: the
  reference runs its Pallas kernel in interpret mode, the port's ranks
  the kernel's plain version on their local tensors).
* Sharded prefills with ``"pallas"``: a reduced SmolLM-135M with its own
  9 query and 3 kv heads (repeated and padded over model 2) and a
  reduced whisper-medium (grouped; its encoder and cross-attention keep
  the einsum core), logits within ``TOL`` of the reference's sharded
  prefill; every rank calls the flash wrapper once a causal layer with
  plain tensors of its local shapes, and the einsum core only where the
  reference does. The wrapper refuses DTensors, and a sharded train step
  with ``"pallas"`` raises (the kernel has no backward, nor has the
  reference's).
* One sharded train step of each of the six families: loss and
  ``grad_norm`` within ``STEP_TOL`` of the reference's **sharded** step
  at the same mesh shape (for qwen2-moe the sharded loss, whose groups
  drop other pairs than one device does; and a 5-expert variant, whose
  experts take the TP layout), ``m`` and ``v`` leaf by leaf
  as ``tests/test_torch_train.py`` holds them, and the parameters to
  ``STEP_TOL`` plus ``2·lr`` where the gradient is under ``TINY_GRAD``.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.launch.meshctx import use_mesh  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

import torch_model_mesh_ranks as R  # noqa: E402

TOL = 1e-4
MOE_TOL = 1e-5
STEP_TOL = 1e-4
TINY_GRAD = 1e-6
ARCHS = ["smollm-135m", "internvl2-1b", "qwen2-moe-a2.7b", "whisper-medium",
         "zamba2-1.2b", "rwkv6-7b"]      # dense, vlm, moe, encdec, hybrid, ssm
# name -> (arch, reduced-config overrides); qwen2-moe's 8 experts are
# expert-parallel over model 2, 5 experts take the TP layout (moe_d_ff
# over "model", the experts replicated)
TRAIN = {**{a: (a, {}) for a in ARCHS},
         "qwen2-moe-tp": ("qwen2-moe-a2.7b", {"num_experts": 5})}
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
ATTN = {  # name -> reduced-config overrides
    "grouped": dict(num_heads=4, num_kv_heads=2),
    "repeated": dict(num_heads=4, num_kv_heads=1),
    "repeated_padded": dict(num_heads=3, num_kv_heads=1),
}
IMPLS = ("xla", "pallas")
# name -> (arch, reduced-config overrides): SmolLM-135M's own heads (3 kv
# heads over model 2: repeated, 9 heads padded to 10), whisper-medium's
# reduced 4 / 2 (grouped)
PREFILL = {"smollm-135m": ("smollm-135m", dict(num_heads=9,
                                               num_kv_heads=3)),
           "whisper-medium": ("whisper-medium", {})}
ROOT = pathlib.Path(__file__).resolve().parents[1]

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, pickle
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs import registry
    from repro.launch import sharding
    from repro.launch.meshctx import use_mesh
    from repro.models import layers as L
    from repro.models import moe as MOE
    from repro.optim import adamw, train_step

    job = pickle.load(open(sys.argv[1], "rb"))

    def mesh_of(shape):
        return jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto, AxisType.Auto))

    def named(mesh, tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    def host(t):
        return jax.tree.map(lambda a: np.asarray(a, np.float32), t)

    out = {}
    mesh = mesh_of((2, 2))
    opt_cfg = adamw.AdamWConfig(**job["opt"])
    for name, (arch, kw, params, batch) in job["train"].items():
        cfg = dataclasses.replace(registry.get_config(arch).reduced(), **kw)
        params = jax.tree.map(jnp.asarray, params)
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        with use_mesh(mesh):
            ps = sharding.param_specs(params, mesh)
            opt = adamw.init(params)
            step = jax.jit(
                train_step.make_train_step(cfg, opt_cfg),
                in_shardings=(named(mesh, ps), named(
                    mesh, sharding.opt_state_specs(opt, ps, mesh)),
                    named(mesh, sharding.batch_specs(batch, mesh))))
            p2, o2, met = step(params, opt, batch)
        out["train/" + name] = {
            "metrics": {k: float(v) for k, v in met.items()},
            "params": host(p2), "m": host(o2["m"]), "v": host(o2["v"])}

    for name, (kw, impl, p, x) in job["attention"].items():
        cfg = dataclasses.replace(registry.get_config("smollm-135m")
                                  .reduced(), **kw)
        b, s, _ = x.shape
        pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
        with use_mesh(mesh):
            y = jax.jit(lambda p, x: L.attention(p, cfg, x, pos,
                                                 attn_impl=impl))(
                jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        out["attention/" + name] = np.asarray(y)

    for name, (arch, kw, params, batch) in job["prefill"].items():
        cfg = dataclasses.replace(registry.get_config(arch).reduced(),
                                  attention_impl="pallas", **kw)
        params = jax.tree.map(jnp.asarray, params)
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        with use_mesh(mesh):
            step = jax.jit(train_step.make_prefill_step(cfg), in_shardings=(
                named(mesh, sharding.param_specs(params, mesh)),
                named(mesh, sharding.batch_specs(batch, mesh))))
            out["prefill/" + name] = np.asarray(step(params, batch),
                                                np.float32)

    cfg = registry.get_config("qwen2-moe-a2.7b").reduced()

    def reference_keep(p, x, cf, g):
        # the reference's routing and grouped rank cumsum, line for line
        e, k = cfg.num_experts, cfg.num_experts_per_tok
        t = x.shape[0] * x.shape[1]
        xt = x.reshape(t, -1)
        gates = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], -1)
        _, ix = jax.lax.top_k(gates, k)
        tg = t // g
        cap = int(max(1, (k * tg / e) * cf))
        oh = jax.nn.one_hot(ix, e, dtype=jnp.int32).reshape(g, tg * k, e)
        ranks = jnp.cumsum(oh, axis=1) - oh
        slot = (ranks * oh).sum(-1).reshape(t, k)
        return ix, slot < cap

    for name, (p, x, cf, shape) in job["moe"].items():
        m = mesh_of(shape)
        p = jax.tree.map(jnp.asarray, p)
        with use_mesh(m):
            y, aux = jax.jit(lambda p, x: MOE.moe_apply(
                p, cfg, x, capacity_factor=cf))(p, jnp.asarray(x))
        ix, keep = jax.jit(lambda p, x: reference_keep(p, x, cf, shape[0])
                           )(p, jnp.asarray(x))
        out["moe/" + name] = {"y": np.asarray(y), "aux": float(aux),
                              "ix": np.asarray(ix), "keep": np.asarray(keep)}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, b=4, s=64, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, :3] = -1
    out = {"tokens": toks, "labels": labels,
           "stratum": np.zeros((b,), np.int32),
           "weight": rng.uniform(0.5, 3.0, b).astype(np.float32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, s // 2, cfg.d_model)).astype(
            np.float32)
        out["tokens"], out["labels"] = toks[:, :s // 2], labels[:, :s // 2]
    if cfg.family == "vlm":
        p = cfg.num_patches
        out["patches"] = rng.normal(size=(b, p, cfg.d_model)).astype(
            np.float32)
        out["tokens"], out["labels"] = toks[:, :s - p], labels[:, :s - p]
    return out


def _job():
    train = {}
    for name, (arch, kw) in TRAIN.items():
        cfg = dataclasses.replace(JR.get_config(arch).reduced(), **kw)
        params = _host(JM.init_params(cfg, jax.random.PRNGKey(0)))
        train[name] = (arch, kw, params, _batch(cfg, seed=2))
    rng = np.random.default_rng(5)
    attention = {}
    for name, kw in ATTN.items():
        cfg = dataclasses.replace(JR.get_config("smollm-135m").reduced(),
                                  **kw)
        p = _host(JL.attention_init(jax.random.PRNGKey(3), cfg, jnp.float32))
        x = rng.normal(size=(4, 64, cfg.d_model)).astype(np.float32)
        for impl in IMPLS:
            attention[f"{name}/{impl}"] = (kw, impl, p, x)
    prefill = {}
    for name, (arch, kw) in PREFILL.items():
        cfg = dataclasses.replace(JR.get_config(arch).reduced(), **kw)
        params = _host(JM.init_params(cfg, jax.random.PRNGKey(4)))
        batch = _batch(cfg, seed=6)
        prefill[name] = (arch, kw, params,
                         {k: batch[k] for k in ("tokens", "frames")
                          if k in batch})
    mcfg = JR.get_config("qwen2-moe-a2.7b").reduced()
    mp = _host(JMOE.moe_init(jax.random.PRNGKey(7), mcfg, jnp.float32))
    x8 = rng.normal(size=(8, 16, mcfg.d_model)).astype(np.float32)
    x4 = rng.normal(size=(4, 32, mcfg.d_model)).astype(np.float32)
    moe = {"g4_cf8": (mp, x8, 8.0, (4, 2)), "g4_cf1": (mp, x8, 1.0, (4, 2)),
           "g2_cf1": (mp, x4, 1.0, (2, 2))}
    return dict(train=train, attention=attention, prefill=prefill, moe=moe,
                opt=OPT)


@pytest.fixture(scope="module")
def runs():
    """(job, the reference's results, rank 0's results, every rank's)."""
    import pickle

    job = _job()
    rank_job = dict(
        opt=OPT, train=job["train"],
        attention={n: ("smollm-135m", kw, impl, p, x)
                   for n, (kw, impl, p, x) in job["attention"].items()},
        prefill=job["prefill"],
        refusals=True, moe={"g2_cf1": job["moe"]["g2_cf1"][:3]})
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "job.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(job, f)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, src, dst],
                               env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
        try:
            ranks = spawn_ranks(R.run_rank, 4,
                                args=((2, 2), ("data", "model"), "cpu",
                                      "gloo", rank_job),
                                device="cpu", backend="gloo", timeout_s=600)
        finally:
            log, _ = ref.communicate(timeout=900)
        assert ref.returncode == 0, log[-4000:]
        with open(dst, "rb") as f:
            want = pickle.load(f)
    return job, want, ranks[0], ranks


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _leaf_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = STEP_TOL * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=atol,
                               err_msg=what)


# -------------------------------------------------------------------- moe --
class FakeMesh:
    """Axis-name/size stand-in: the model code reads only names and
    sizes of a mesh that is not a ``DeviceMesh``."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_moe_groups_match_the_sharded_reference(runs, cf):
    job, want, _, _ = runs
    name = "g4_cf8" if cf == 8.0 else "g4_cf1"
    p, x, _, _ = job["moe"][name]
    w = want["moe/" + name]
    cfg = TR.get_config("qwen2-moe-a2.7b").reduced()
    tp = convert.params_from_numpy(cfg, {"moe": p}, "cpu")["moe"]
    seen, real = [], TMOE.select

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out

    TMOE.select = spy
    try:
        with use_mesh(FakeMesh({"data": 4, "model": 2})):
            y, aux = TMOE.moe_apply(tp, cfg, torch.from_numpy(x),
                                    capacity_factor=cf)
    finally:
        TMOE.select = real
    np.testing.assert_array_equal(seen[0][1].numpy(), w["ix"])
    np.testing.assert_array_equal(seen[0][3].numpy(), w["keep"])
    _close(aux, w["aux"])
    scale = float(np.abs(w["y"]).max())
    np.testing.assert_allclose(y.numpy(), w["y"], rtol=0,
                               atol=MOE_TOL * scale)
    if cf == 1.0:
        assert not w["keep"].all()
        one = TMOE.route(tp, cfg, torch.from_numpy(x).reshape(-1, x.shape[-1]),
                         cf)[3].numpy()
        assert (one != w["keep"]).any(), "groups must drop other pairs"


def test_moe_one_group_keeps_what_it_kept():
    """``G = 1`` (no mesh) is the dispatch the port had: one group of
    all tokens, its capacity ``capacity(cfg, B·S, cf)``, the kept pairs
    alone written into the expert buffer by a masked index write."""
    cfg = TR.get_config("qwen2-moe-a2.7b").reduced()
    p = TMOE.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    from repro_torch.models.layers import Params

    p = Params(p)
    x = torch.randn((4, 32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    xt = x.reshape(-1, cfg.d_model)
    gates = torch.softmax(xt @ p["router"], -1)
    vals, ix = torch.sort(gates, dim=-1, descending=True, stable=True)
    ix = ix[:, :cfg.num_experts_per_tok]
    oh = torch.nn.functional.one_hot(ix.reshape(-1), cfg.num_experts)
    slot = ((torch.cumsum(oh, 0) - oh) * oh).sum(-1).reshape(ix.shape)
    keep = slot < TMOE.capacity(cfg, xt.shape[0], 1.0)
    got = TMOE.route(p, cfg, xt, 1.0)
    assert torch.equal(got[1], ix) and torch.equal(got[3], keep)
    assert not keep.all()
    # the one-group dispatch as the port wrote it before the mesh
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = TMOE.capacity(cfg, xt.shape[0], 1.0)
    gv = got[0]
    flat = (ix * cap + torch.where(keep, slot, cap - 1)).reshape(-1)
    kept = keep.reshape(-1)
    token = torch.arange(xt.shape[0]).repeat_interleave(k)
    buf = xt.new_zeros((e * cap, cfg.d_model)).index_put(
        (flat[kept],), xt[token[kept]]).reshape(e, cap, -1)
    h = torch.nn.functional.silu(torch.bmm(buf, p["w_gate"])) * \
        torch.bmm(buf, p["w_up"])
    out = torch.bmm(h, p["w_down"]).reshape(e * cap, -1)
    want = torch.sum(torch.where(keep[..., None], out[flat].reshape(
        xt.shape[0], k, -1), 0.0) * gv[..., None], dim=1)
    want = want + TMOE.L.swiglu(p["shared"], xt)
    y, _ = TMOE.moe_apply(p, cfg, x, capacity_factor=1.0)
    np.testing.assert_allclose(y.reshape(-1, cfg.d_model).numpy(),
                               want.numpy(), rtol=0,
                               atol=MOE_TOL * float(want.abs().max()))


def test_moe_ranks_keep_their_groups(runs):
    """Each rank of the ``(2, 2)`` mesh routes its data shard's group:
    its kept set and choices are that group's rows of the reference's
    ``G = 2`` dispatch; the output and aux gathered match it."""
    _, want, _, ranks = runs
    w = want["moe/g2_cf1"]
    tg = w["keep"].shape[0] // 2
    for r in ranks:
        got = r["moe/g2_cf1"]
        g = r["coords"][0]
        np.testing.assert_array_equal(got["ix"], w["ix"][g * tg:(g + 1) * tg])
        np.testing.assert_array_equal(got["keep"],
                                      w["keep"][g * tg:(g + 1) * tg])
        scale = float(np.abs(w["y"]).max())
        np.testing.assert_allclose(got["y"], w["y"], rtol=0,
                                   atol=MOE_TOL * scale)
        _close(got["aux"], w["aux"])
    assert not w["keep"].all()


# -------------------------------------------------------------- attention --
@pytest.mark.parametrize("attn_impl", IMPLS)
@pytest.mark.parametrize("name", list(ATTN))
def test_attention_branches_match_the_reference(runs, name, attn_impl):
    _, want, got, _ = runs
    key = f"attention/{name}/{attn_impl}"
    _close(got[key], want[key])


@pytest.mark.parametrize("name", list(PREFILL))
def test_sharded_pallas_prefill_matches_the_sharded_reference(runs, name):
    _, want, got, _ = runs
    _close(got[f"prefill/{name}"]["logits"], want[f"prefill/{name}"])


def _local_heads(cfg, n_model):
    """(query heads, kv heads) a rank's flash call takes: the grouped
    layout's blocks, or the repeated heads padded to the model axis."""
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    if hkv % n_model == 0:
        return h // n_model, hkv // n_model
    hp = h + (-h) % n_model
    return hp // n_model, hp // n_model


@pytest.mark.parametrize("name", list(PREFILL))
def test_every_rank_calls_the_flash_wrapper_once_a_causal_layer(runs, name):
    """Under the ``(2, 2)`` mesh each rank reaches
    ``flash_ops.flash_attention`` once per causal self-attention layer,
    with plain tensors of its batch shard and its heads; the einsum core
    runs only where the reference runs it too (whisper's encoder and
    cross-attention), never in place of the kernel."""
    job, _, _, ranks = runs
    arch, kw, _, batch = job["prefill"][name]
    cfg = dataclasses.replace(TR.get_config(arch).reduced(), **kw)
    b, s = batch["tokens"].shape
    hq, hkv = _local_heads(cfg, 2)
    d = cfg.head_dim
    want = [((True, True, True),
             ((b // 2, hq, s, d), (b // 2, hkv, s, d), (b // 2, hkv, s, d)))
            ] * cfg.num_layers
    # whisper: each encoder layer's attention and each decoder layer's
    # cross-attention
    einsum = (cfg.encoder_layers + cfg.num_layers
              if cfg.family == "encdec" else 0)
    for r in ranks:
        calls = r[f"prefill/{name}"]["calls"]
        assert calls["flash"] == want, (r["rank"], calls["flash"])
        assert calls["einsum"] == einsum, r["rank"]


def test_the_wrapper_refuses_dtensors_and_pallas_does_not_train(runs):
    _, _, _, ranks = runs
    for r in ranks:
        kind, msg = r["refusals"]["dtensor"]
        assert kind == "TypeError" and "not DTensors" in msg
        kind, msg = r["refusals"]["train"]
        assert kind == "RuntimeError" and "no backward" in msg


# ------------------------------------------------------------- train step --
@pytest.mark.parametrize("arch", list(TRAIN))
def test_sharded_train_step_matches_the_sharded_reference(runs, arch):
    _, want, got, _ = runs
    w, g = want["train/" + arch], got["train/" + arch]
    met = g["metrics"][0]
    assert set(met) == set(w["metrics"])
    for k in w["metrics"]:
        _close(met[k], w["metrics"][k], STEP_TOL)

    def grads(m, loss_met):
        scale = min(1.0, 1.0 / max(float(loss_met["grad_norm"]), 1e-9))
        return [np.asarray(x, np.float32) / (0.1 * scale)
                for x in jax.tree.leaves(m)]

    g_want = grads(w["m"], w["metrics"])
    for name, a_tree, b_tree in (
            ("grad", grads(g["m"], met), g_want),
            ("m", jax.tree.leaves(g["m"]), jax.tree.leaves(w["m"])),
            ("v", jax.tree.leaves(g["v"]), jax.tree.leaves(w["v"]))):
        assert len(a_tree) == len(b_tree), (arch, name)
        for i, (a, b) in enumerate(zip(a_tree, b_tree)):
            _leaf_close(a, b, f"{arch} {name} leaf {i}")
    for a, b, gw in zip(jax.tree.leaves(g["params"]),
                        jax.tree.leaves(w["params"]), g_want):
        slack = np.where(np.abs(gw) < TINY_GRAD, 2 * OPT["lr"], 0.0)
        assert (np.abs(a - b) <= STEP_TOL * (1 + np.abs(b)) + slack).all(), \
            arch
    assert jax.tree.structure(g["params"]) == jax.tree.structure(
        w["params"])


def test_every_rank_returns_the_same_gathered_step(runs):
    _, _, _, ranks = runs
    coords = sorted(tuple(r["coords"]) for r in ranks)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks[1:]:
        for arch in TRAIN:
            a = jax.tree.leaves(r["train/" + arch]["params"])
            b = jax.tree.leaves(ranks[0]["train/" + arch]["params"])
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_a_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import (make_host_mesh, make_model_mesh,
                                         make_production_mesh)

    with pytest.raises(RuntimeError, match="ranks"):
        make_model_mesh((2, 2), ("data", "model"), device="cpu",
                        backend="gloo")
    with pytest.raises(RuntimeError, match="ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh()
