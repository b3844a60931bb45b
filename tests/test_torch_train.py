"""The port's training plane against the reference's, on the CPU:
``weighted_loss``, ``TokenStream``, ``ApproxTrainPipeline``,
``loss_fn`` for every family, AdamW and one whole train step.

Inputs are made with numpy from a seed and weights carried with
``repro_torch.convert``; reference functions run under ``jax.jit``.

* ``TokenStream`` batches and ``ApproxTrainPipeline.next_batch`` (the
  stream, ``whsamp``'s selection and its Eq. 9 weights, the repeat-pad)
  are the reference's bit for bit.
* ``weighted_loss``, ``schedule``, ``adamw.update`` and ``loss_fn``:
  rtol = atol = 1e-4 (f32 sums and matmuls in other orders than XLA's).
* One ``make_train_step`` against the jitted reference step, every
  family of the zoo: ``STEP_TOL`` 1e-4 on the loss, ``grad_norm`` and
  ``lr``. Each gradient leaf (recovered from ``m``, which at the first
  step is ``0.1 · clip_scale · g``), ``m`` and ``v`` are held to rtol
  ``STEP_TOL`` with atol ``STEP_TOL`` times the leaf's largest entry:
  they differ by f32 rounding, and a limit on the leaf's own scale
  catches a leaf whose gradient is off by a factor. The parameters and ``master`` move by
  ``lr · m̂ / (√v̂ + eps)``, which at the first step is
  ``lr · g / (|g| + eps)``: for a gradient entry near 0 that ratio turns
  on the entry's rounding, so they are held to ``STEP_TOL`` plus
  ``2·lr`` where ``|g|`` is under ``TINY_GRAD`` (1e-6), and to
  ``STEP_TOL`` everywhere else.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.core import queries as JQ  # noqa: E402
from repro.core.types import StratumMeta as JMeta  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.data import stream as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.optim import train_step as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.core import queries as TQ  # noqa: E402
from repro_torch.core.types import StratumMeta as TMeta  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.data import stream as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import train_step as TT  # noqa: E402

TOL = 1e-4
STEP_TOL = 1e-4
TINY_GRAD = 1e-6
ARCHS = ["smollm-135m", "internvl2-1b", "qwen2-moe-a2.7b", "whisper-medium",
         "zamba2-1.2b", "rwkv6-7b"]      # dense, vlm, moe, encdec, hybrid, ssm


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _leaf_close(got, want, what):
    """``got`` within ``STEP_TOL`` of ``want`` relative to each entry and
    to the leaf's largest entry: a gradient leaf's own scale, so a leaf
    off by a factor fails however small its entries are."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = STEP_TOL * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=atol,
                               err_msg=what)


def _bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8))


# ---------------------------------------------------------------- queries --
def test_weighted_loss_matches_reference():
    rng = np.random.default_rng(0)
    m, x = 200, 5
    loss = rng.gamma(2.0, 1.0, m).astype(np.float32)
    strat = rng.integers(0, x, m).astype(np.int32)
    sel = rng.random(m) < 0.4
    w = rng.uniform(1, 9, x).astype(np.float32)
    c = rng.uniform(0, 50, x).astype(np.float32)
    want = jax.jit(JQ.weighted_loss)(jnp.asarray(loss), jnp.asarray(strat),
                                     jnp.asarray(sel),
                                     JMeta(jnp.asarray(w), jnp.asarray(c)))
    got = TQ.weighted_loss(_t(loss), _t(strat), _t(sel), TMeta(_t(w), _t(c)))
    _close(got, want)
    none = TQ.weighted_loss(_t(loss), _t(strat), torch.zeros(m, dtype=bool),
                            TMeta(_t(w), _t(c)))
    assert float(none) == 0.0


# ----------------------------------------------------------------- stream --
def test_token_stream_is_the_reference():
    rates = list(np.linspace(1.0, 4.0, 4))
    js = JS.TokenStream(512, 16, 4, rates=rates, seed=3)
    ts = TS.TokenStream(512, 16, 4, rates=rates, seed=3)
    for n in (5, 32, 1):
        want, got = js.examples(n), ts.examples(n)
        assert set(got) == set(want) == {"tokens", "labels", "stratum"}
        for k in want:
            _bits(got[k], want[k])


@pytest.mark.parametrize("batch,interval,fraction,allocation", [
    (8, 32, 0.5, "fair"),
    (16, 24, 0.25, "fair"),            # short sample: repeat-padded
    (8, 40, 0.3, "proportional"),
])
def test_pipeline_batches_are_the_reference(batch, interval, fraction,
                                            allocation):
    rates = list(np.linspace(1.0, 4.0, 4))
    kw = dict(batch_size=batch, interval_size=interval, num_strata=4,
              sampling_fraction=fraction, allocation=allocation, seed=5)
    jp = JP.ApproxTrainPipeline(JP.PipelineConfig(**kw),
                                JS.TokenStream(512, 16, 4, rates=rates))
    tp = TP.ApproxTrainPipeline(TP.PipelineConfig(**kw),
                                TS.TokenStream(512, 16, 4, rates=rates),
                                device="cpu")
    for _ in range(4):
        want, got = jp.next_batch(), tp.next_batch()
        assert set(got) == set(want)
        for k in want:
            _bits(got[k], want[k])
    assert tp.stats == jp.stats
    assert tp.stats["sampled"] < tp.stats["arrived"]


# ---------------------------------------------------------------- loss_fn --
def _cfgs(arch, **kw):
    return (dataclasses.replace(JR.get_config(arch).reduced(), **kw),
            dataclasses.replace(TR.get_config(arch).reduced(), **kw))


def _train_batch(cfg, b=2, s=128, seed=0):
    """numpy inputs as ``tests/test_models.py`` builds them, with some
    labels -1 (no loss) and uneven weights."""
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
        out["tokens"] = toks[:, :s // 2]
        out["labels"] = labels[:, :s // 2]
    if cfg.family == "vlm":
        p = cfg.num_patches
        out["patches"] = rng.normal(size=(b, p, cfg.d_model)).astype(
            np.float32)
        out["tokens"] = toks[:, :s - p]
        out["labels"] = labels[:, :s - p]
    return out


def _split(batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: (_t(v).long() if k in ("tokens", "labels") else _t(v))
          for k, v in batch.items()}
    return jb, tb


@pytest.fixture(scope="module")
def carried():
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        params = JM.init_params(jcfg, jax.random.PRNGKey(0))
        out[arch] = (jcfg, tcfg, params, jax.tree.map(np.asarray, params))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(carried, arch):
    jcfg, tcfg, params, host = carried[arch]
    tparams = convert.params_from_numpy(tcfg, host, "cpu")
    jb, tb = _split(_train_batch(jcfg))
    want_loss, want = jax.jit(lambda p, b: JM.loss_fn(jcfg, p, b))(params,
                                                                  jb)
    got_loss, got = TM.loss_fn(tcfg, tparams, tb)
    _close(got_loss, want_loss)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    del tb["weight"], jb["weight"]
    _close(TM.loss_fn(tcfg, tparams, tb)[0],
           jax.jit(lambda p, b: JM.loss_fn(jcfg, p, b))(params, jb)[0])


# ------------------------------------------------------------------ adamw --
def test_schedule_and_update_match_reference():
    cfg = JA.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=10)
    tcfg = TA.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=10)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(JA.AdamWConfig()) == dataclasses.asdict(
        TA.AdamWConfig())
    steps = np.arange(0, 14, dtype=np.int32)
    _close(TA.schedule(tcfg, _t(steps)),
           jax.jit(lambda s: JA.schedule(cfg, s))(jnp.asarray(steps)))
    rng = np.random.default_rng(1)
    params = {"a": {"w": rng.normal(size=(6, 5)).astype(np.float32)},
              "b": rng.normal(size=(7,)).astype(np.float32)}
    from repro_torch.models.layers import Params

    tparams = Params({k: ({kk: _t(vv) for kk, vv in v.items()}
                          if isinstance(v, dict) else _t(v))
                      for k, v in params.items()})
    jparams = jax.tree.map(jnp.asarray, params)
    state, tstate = JA.init(jparams), TA.init(tparams, device="cpu")
    upd = jax.jit(lambda g, s, p: JA.update(cfg, g, s, p))
    for i in range(4):
        # big gradients on the first steps: the clip scales them
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * (3.0 if i < 2
                                                                else 0.1)
                                    ).astype(np.float32), params)
        jparams, state, met = upd(jax.tree.map(jnp.asarray, g), state,
                                  jparams)
        tg = [_t(g["b"]), _t(g["a"]["w"])]   # parameters() order
        tparams, tstate, tmet = TA.update(tcfg, tg, tstate, tparams)
        _close(tmet["grad_norm"], met["grad_norm"])
        _close(tmet["lr"], met["lr"])
        assert int(tstate["step"]) == int(state["step"]) == i + 1
        _close(tparams["a"]["w"], jparams["a"]["w"])
        _close(tparams["b"], jparams["b"])
        for k in ("m", "v", "master"):
            _close(tstate[k]["a"]["w"], state[k]["a"]["w"])
            _close(tstate[k]["b"], state[k]["b"])


def test_adamw_init_mirrors_params_and_defaults_to_cuda():
    _, tcfg = _cfgs("zamba2-1.2b", param_dtype=torch.bfloat16)
    params = TM.init_params(tcfg, seed=0, device="cpu")
    state = TA.init(params, device="cpu")
    names = [n for n, _ in params.named_parameters()]
    for k in ("m", "v", "master"):
        assert [n for n, _ in state[k].named_parameters()] == names
        assert all(t.dtype == torch.float32 for t in state[k].parameters())
    for p, m in zip(params.parameters(), state["master"].parameters()):
        assert torch.equal(p.float(), m) and p.data_ptr() != m.data_ptr()
    assert state["step"].dtype == torch.int32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TA.init(params)


# ------------------------------------------------------------- train step --
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(carried, arch):
    jcfg, tcfg, params, host = carried[arch]
    tparams = convert.params_from_numpy(tcfg, host, "cpu")
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(JT.make_train_step(jcfg, JA.AdamWConfig(**opt)))
    tstep = TT.make_train_step(tcfg, TA.AdamWConfig(**opt))
    jb, tb = _split(_train_batch(jcfg, seed=2))
    jopt = JA.init(params)
    topt = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jopt),
                                        "cpu")
    p2, o2, met = jstep(params, jopt, jb)
    tp2, to2, tmet = tstep(tparams, topt, tb)
    assert set(tmet) == set(met)
    for k in met:
        _close(tmet[k], met[k], STEP_TOL)
    assert all(not t.requires_grad for t in tp2.parameters())
    got_p = convert.params_to_numpy(tp2)
    got_o = convert.opt_state_to_numpy(to2)
    assert int(got_o["step"]) == int(o2["step"]) == 1
    # the gradients, from m = (1 − b1)·g·clip_scale at the first step,
    # each side with its own clip scale
    def grads(m, met):
        scale = min(1.0, 1.0 / max(float(met["grad_norm"]), 1e-9))
        return [np.asarray(x, np.float32) / (0.1 * scale)
                for x in jax.tree.leaves(m)]

    g_want = grads(o2["m"], met)
    for name, got, want in (
            ("grad", grads(got_o["m"], tmet), g_want),
            ("m", jax.tree.leaves(got_o["m"]), jax.tree.leaves(o2["m"])),
            ("v", jax.tree.leaves(got_o["v"]), jax.tree.leaves(o2["v"]))):
        assert len(got) == len(want), (arch, name)
        for i, (a, b) in enumerate(zip(got, want)):
            _leaf_close(a, b, f"{arch} {name} leaf {i}")
    g_abs = [np.abs(g) for g in g_want]
    for tree_got, tree_want in ((got_p, p2), (got_o["master"], o2["master"])):
        for a, b, g in zip(jax.tree.leaves(tree_got),
                           jax.tree.leaves(tree_want),
                           g_abs):
            b = np.asarray(b, np.float32)
            slack = np.where(g < TINY_GRAD, 2 * opt["lr"], 0.0)
            assert (np.abs(a - b) <= STEP_TOL * (1 + np.abs(b))
                    + slack).all(), arch
    assert jax.tree.structure(got_p) == jax.tree.structure(
        jax.tree.map(np.asarray, p2))


def test_pallas_under_autograd_raises():
    _, tcfg = _cfgs("smollm-135m", attention_impl="pallas")
    params = TM.init_params(tcfg, seed=0, device="cpu")
    opt = TA.init(params, device="cpu")
    _, tb = _split(_train_batch(tcfg, s=64))
    step = TT.make_train_step(tcfg, TA.AdamWConfig())
    before = [t.clone() for t in params.parameters()]
    with pytest.raises(RuntimeError, match="no backward"):
        step(params, opt, tb)
    # nothing moved, and the parameters take no gradient again
    for a, b in zip(before, params.parameters()):
        assert torch.equal(a, b) and not b.requires_grad
    # the serving path still runs the kernel's plain version
    logits = TT.make_prefill_step(tcfg)(params, tb)
    assert torch.isfinite(logits).all()
