"""The port's moe, encdec, hybrid and ssm families against the
reference's, on the CPU.

Weights are the reference's ``init_params`` (and its ``moe_init``,
``mamba2_init``, ``rwkv6_init``, ``attention_init``) carried across with
``repro_torch.convert``; inputs are made with numpy from a seed; every
reference function runs under ``jax.jit``, compiled once per module
where it can be. Tolerances:

* ``MATMUL_TOL`` 1e-4 (rtol = atol) for attention, ``moe_apply``,
  mamba2 and rwkv6, ``forward`` of the reduced (f32) configs and
  ``decode_step`` with a carried cache: f32 matmuls summed in other
  orders than XLA's, and mamba2's and rwkv6's in-chunk log-decay
  cumsums, XLA's blocked scan under ``jit`` against a sequential sum
  here (both well inside the tolerance at these sizes).
* The reference's law, teacher-forced decode ≡ forward, 2e-2 as
  ``tests/test_models.py``.

moe dispatch drops the reference's (token, choice) pairs: the test
derives them with the reference's own routing lines (``lax.top_k``, the
rank cumsum) and holds the port's ``keep`` mask to them bitwise, at a
decode-sized batch where capacity 1 drops pairs too.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba2 as JM2  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import rwkv6 as JR6  # noqa: E402
from repro.optim import train_step as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mamba2 as TM2  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import rwkv6 as TR6  # noqa: E402
from repro_torch.optim import train_step as TT  # noqa: E402

MATMUL_TOL = 1e-4
LAW_TOL = 2e-2
FAMILY_ARCHS = ["qwen2-moe-a2.7b", "grok-1-314b", "whisper-medium",
                "zamba2-1.2b", "rwkv6-7b"]


def _cfgs(arch, **kw):
    return (dataclasses.replace(JR.get_config(arch).reduced(), **kw),
            dataclasses.replace(TR.get_config(arch).reduced(), **kw))


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=MATMUL_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _batch(cfg, b, s, seed=0):
    """numpy inputs as ``tests/test_models.py`` builds them: encdec takes
    ``s // 2`` frames and ``s // 2`` tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = {"tokens": toks}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, s // 2, cfg.d_model)).astype(
            np.float32)
        out["tokens"] = toks[:, :s // 2]
    return out


def _split(batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: (_t(v).long() if v.dtype.kind == "i" else _t(v))
          for k, v in batch.items()}
    return jb, tb


# -------------------------------------------------------------- attention --
@pytest.fixture(scope="module")
def whisper_attn():
    jcfg, tcfg = _cfgs("whisper-medium")
    p = JL.attention_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    return jcfg, tcfg, p, convert.params_from_numpy(
        tcfg, {"a": _host(p)}, "cpu")["a"]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_noncausal_and_cross_attention_match_reference(whisper_attn, impl):
    """``causal=False`` and ``kv_x`` take the einsum path whatever the
    impl, with no mask; cross-attention gets no RoPE (a qwen3 config,
    which has RoPE and qk-norm, shows it)."""
    rng = np.random.default_rng(4)
    for jcfg, tcfg, p, tp in (whisper_attn, _qwen3_attn()):
        x = rng.normal(size=(2, 32, jcfg.d_model)).astype(np.float32)
        kv = rng.normal(size=(2, 48, jcfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(32)[None], (2, 32)).astype(np.int32)
        want = jax.jit(lambda p, x, kv, pos: (
            JL.attention(p, jcfg, x, pos, causal=False, attn_impl=impl),
            JL.attention(p, jcfg, x, pos, causal=False, kv_x=kv,
                         attn_impl=impl)))(p, jnp.asarray(x),
                                           jnp.asarray(kv), jnp.asarray(pos))
        got = (TL.attention(tp, tcfg, _t(x), _t(pos), causal=False,
                            attn_impl=impl),
               TL.attention(tp, tcfg, _t(x), _t(pos), causal=False,
                            kv_x=_t(kv), attn_impl=impl))
        for g, w in zip(got, want):
            _close(g, w, MATMUL_TOL)


def _qwen3_attn():
    jcfg, tcfg = _cfgs("qwen3-4b")
    p = JL.attention_init(jax.random.PRNGKey(5), jcfg, jnp.float32)
    return jcfg, tcfg, p, convert.params_from_numpy(
        tcfg, {"a": _host(p)}, "cpu")["a"]


def test_cross_attention_decode_matches_reference(whisper_attn):
    jcfg, tcfg, p, tp = whisper_attn
    rng = np.random.default_rng(6)
    shape = (2, jcfg.num_kv_heads, 24, jcfg.head_dim)
    kc = rng.normal(size=shape).astype(np.float32)
    vc = rng.normal(size=shape).astype(np.float32)
    x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x, k, v: JL.attention_decode(
        p, jcfg, x, k, v, jnp.int32(3), update_cache=False, cross=True))(
        p, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc))
    tk, tv = _t(kc), _t(vc)
    got = TL.attention_decode(tp, tcfg, _t(x), tk, tv, 3, cross=True)
    for g, w in zip(got, want):
        _close(g, w, MATMUL_TOL)
    np.testing.assert_array_equal(tk.numpy(), kc)   # no write
    np.testing.assert_array_equal(tv.numpy(), vc)


# -------------------------------------------------------------------- moe --
def _reference_keep(jcfg, p, xt, capacity_factor):
    """The reference's dropped set, by its own routing lines
    (``repro/models/moe.py``, ``G = 1``)."""
    e, k = jcfg.num_experts, jcfg.num_experts_per_tok
    t = xt.shape[0]
    gates = jax.nn.softmax(jnp.asarray(xt) @ p["router"], axis=-1)
    _, expert_ix = jax.lax.top_k(gates, k)
    cap = int(max(1, (k * t / e) * capacity_factor))
    onehot = jax.nn.one_hot(expert_ix, e, dtype=jnp.int32).reshape(t * k, e)
    ranks = jnp.cumsum(onehot, axis=0) - onehot
    slot = (ranks * onehot).sum(-1).reshape(t, k)
    return np.asarray(expert_ix), np.asarray(slot < cap), cap


@pytest.mark.parametrize("arch,experts,b,s", [
    ("qwen2-moe-a2.7b", None, 2, 64),
    ("grok-1-314b", None, 2, 64),
    # qwen2-moe's own routing (60 experts, top 4) at decode, B 8: capacity
    # int(4·8/60·1.25) = 1, so pairs are dropped
    ("qwen2-moe-a2.7b", (60, 4), 8, 1),
])
def test_moe_apply_matches_reference(arch, experts, b, s):
    kw = {}
    if experts:
        kw = dict(num_experts=experts[0], num_experts_per_tok=experts[1])
    jcfg, tcfg = _cfgs(arch, **kw)
    p = JMOE.moe_init(jax.random.PRNGKey(7), jcfg, jnp.float32)
    tp = convert.params_from_numpy(tcfg, {"m": _host(p)}, "cpu")["m"]
    rng = np.random.default_rng(8)
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    cf = jcfg.capacity_factor
    want_y, want_aux = jax.jit(lambda p, x: JMOE.moe_apply(
        p, jcfg, x, capacity_factor=cf))(p, jnp.asarray(x))
    got_y, got_aux = TMOE.moe_apply(tp, tcfg, _t(x), capacity_factor=cf)
    _close(got_y, want_y, MATMUL_TOL)
    _close(got_aux, want_aux, MATMUL_TOL)
    xt = x.reshape(b * s, -1)
    want_ix, want_keep, cap = _reference_keep(jcfg, p, xt, cf)
    _, ix, _, keep, _ = TMOE.route(tp, tcfg, _t(xt), cf)
    assert TMOE.capacity(tcfg, b * s, cf) == cap
    np.testing.assert_array_equal(ix.numpy(), want_ix)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if experts:
        assert cap == 1 and not want_keep.all()


# ----------------------------------------------------------------- mamba2 --
def _same_state(got, want):
    """Zero states of the same names, shapes and dtypes (the SSM and WKV
    states f32 in a bf16 model)."""
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).replace("torch.", "") == w.dtype.name, k
        assert not got[k].any()


@pytest.fixture(scope="module")
def zamba():
    jcfg, tcfg = _cfgs("zamba2-1.2b")
    p = JM2.mamba2_init(jax.random.PRNGKey(9), jcfg, jnp.float32)
    # a non-trivial dt_bias and d_skip (init has 0 and 1)
    p = dict(p, dt_bias=p["dt_bias"] + 0.3, d_skip=p["d_skip"] * 0.7)
    return jcfg, tcfg, p, convert.params_from_numpy(
        tcfg, {"m": _host(p)}, "cpu")["m"]


def test_mamba2_forward_and_decode_match_reference(zamba):
    jcfg, tcfg, p, tp = zamba
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 256, jcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: JM2.mamba2_forward(p, jcfg, x))(
        p, jnp.asarray(x))
    _close(TM2.mamba2_forward(tp, tcfg, _t(x)), want, MATMUL_TOL)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TM2.mamba2_forward(tp, tcfg, _t(x[:, :200]))
    st = JM2.mamba2_init_state(jcfg, 2)
    _same_state(TM2.mamba2_init_state(tcfg, 2, torch.bfloat16),
                JM2.mamba2_init_state(jcfg, 2, jnp.bfloat16))
    st = {k: rng.normal(size=v.shape).astype(np.float32)
          for k, v in st.items()}
    x1 = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x, s: JM2.mamba2_decode(p, jcfg, x, s))(
        p, jnp.asarray(x1), {k: jnp.asarray(v) for k, v in st.items()})
    got = TM2.mamba2_decode(tp, tcfg, _t(x1), {k: _t(v)
                                               for k, v in st.items()})
    _close(got[0], want[0], MATMUL_TOL)
    for name in ("conv", "ssm"):
        _close(got[1][name], want[1][name], MATMUL_TOL)


# ------------------------------------------------------------------ rwkv6 --
def test_rwkv6_forward_and_decode_match_reference():
    jcfg, tcfg = _cfgs("rwkv6-7b")
    p = JR6.rwkv6_init(jax.random.PRNGKey(11), jcfg, jnp.float32)
    tp = convert.params_from_numpy(tcfg, {"r": _host(p)}, "cpu")["r"]
    rng = np.random.default_rng(12)
    b, s, d = 2, 128, jcfg.d_model
    h, hd = d // jcfg.ssm_head_dim, jcfg.ssm_head_dim
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    shift = rng.normal(size=(b, d)).astype(np.float32)
    state = rng.normal(size=(b, h, hd, hd)).astype(np.float32)
    x1 = rng.normal(size=(b, 1, d)).astype(np.float32)
    _same_state(TR6.rwkv6_init_state(tcfg, b, torch.bfloat16),
                JR6.rwkv6_init_state(jcfg, b, jnp.bfloat16))

    def ref(p, x, shift, state, x1):
        return (JR6.rwkv6_time_mix(p, jcfg, x, shift, state),
                JR6.rwkv6_channel_mix(p, jcfg, x, shift),
                JR6.rwkv6_decode(p, jcfg, x1, shift, state),
                JR6.rwkv6_channel_mix_decode(p, jcfg, x1, shift))

    want = jax.jit(ref)(p, *map(jnp.asarray, (x, shift, state, x1)))
    got = (TR6.rwkv6_time_mix(tp, tcfg, _t(x), _t(shift), _t(state)),
           TR6.rwkv6_channel_mix(tp, tcfg, _t(x), _t(shift)),
           TR6.rwkv6_decode(tp, tcfg, _t(x1), _t(shift), _t(state)),
           TR6.rwkv6_channel_mix_decode(tp, tcfg, _t(x1), _t(shift)))
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            _close(g, w, MATMUL_TOL)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TR6.rwkv6_time_mix(tp, tcfg, _t(x[:, :100]), _t(shift), _t(state))


# ---------------------------------------------------------------- forward --
@pytest.fixture(scope="module")
def carried():
    """arch → (jcfg, tcfg, reference params, port params), built once."""
    out = {}
    for arch in FAMILY_ARCHS:
        jcfg, tcfg = _cfgs(arch)
        params = JM.init_params(jcfg, jax.random.PRNGKey(0))
        out[arch] = (jcfg, tcfg, params,
                     convert.params_from_numpy(tcfg, _host(params), "cpu"))
    return out


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_matches_reference(carried, arch):
    """Both attention impls in one reference program: "pallas" (the
    Pallas kernel in interpret mode there, the kernel's plain version
    here) and "xla"."""
    jcfg, tcfg, params, tparams = carried[arch]
    jb, tb = _split(_batch(jcfg, 2, 128))
    cfgs = {impl: (dataclasses.replace(jcfg, attention_impl=impl),
                   dataclasses.replace(tcfg, attention_impl=impl))
            for impl in ("pallas", "xla")}
    want = jax.jit(lambda p, b: {impl: JM.forward(c[0], p, b)
                                 for impl, c in cfgs.items()})(params, jb)
    for impl, (_, tc) in cfgs.items():
        got, aux = TM.forward(tc, tparams, tb)
        assert got.shape == want[impl][0].shape
        _close(got, want[impl][0], MATMUL_TOL)
        _close(aux, want[impl][1], MATMUL_TOL)
        prefill = TT.make_prefill_step(tc)(tparams, tb)
        assert torch.equal(prefill, got)


# ----------------------------------------------------------------- decode --
@pytest.mark.parametrize("arch,layers", [
    ("qwen2-moe-a2.7b", None), ("whisper-medium", None),
    ("zamba2-1.2b", 3),          # segments [2, 1]: a short last segment
    ("rwkv6-7b", None)])
def test_decode_step_matches_reference(arch, layers):
    kw = {"num_layers": layers} if layers else {}
    jcfg, tcfg = _cfgs(arch, **kw)
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_numpy(tcfg, _host(params), "cpu")
    if layers:
        assert JM._segments(jcfg) == TM._segments(tcfg) == [2, 1]
    b, s = 2, 12
    rng = np.random.default_rng(13)
    cache = JM.init_cache(jcfg, b, s)
    cache = jax.tree.map(lambda a: jnp.asarray(
        0.5 * rng.normal(size=a.shape), a.dtype), cache)
    tcache = convert.cache_from_numpy(tcfg, _host(cache), "cpu")
    assert set(tcache) == set(TM.init_cache(tcfg, b, s, "cpu"))
    step = jax.jit(JT.make_decode_step(jcfg))
    tstep = TT.make_decode_step(tcfg)
    for pos in (0, 5, 11):
        tok = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        want, cache = step(params, cache, jnp.asarray(tok), jnp.int32(pos))
        got, tcache = tstep(tparams, tcache, _t(tok).long(), pos)
        _close(got, want, MATMUL_TOL)
        for name in cache:
            _close(tcache[name], cache[name], MATMUL_TOL)


# -------------------------------------------------------- the reference's law
@pytest.mark.parametrize("arch,kw", [
    ("qwen2-moe-a2.7b", {"capacity_factor": 8.0}),
    ("grok-1-314b", {"capacity_factor": 8.0}),
    ("zamba2-1.2b", {"num_layers": 3}),
    ("rwkv6-7b", {}),
])
def test_teacher_forced_decode_matches_forward(arch, kw):
    """``tests/test_models.py``'s law on the port: moe with capacity
    factor 8 (no drops), the hybrid with a short last segment."""
    _, tcfg = _cfgs(arch, **kw)
    params = TM.init_params(tcfg, seed=0, device="cpu")
    b, s = 2, 128
    _, tb = _split(_batch(tcfg, b, s))
    full = TM.forward(tcfg, params, tb)[0]
    cache = TM.init_cache(tcfg, b, s, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = TM.decode_step(tcfg, params, cache,
                                   tb["tokens"][:, t:t + 1], t)
        outs.append(lg)
    _close(torch.stack(outs, dim=1), full, LAW_TOL)


def test_encdec_teacher_forced_decode_matches_forward():
    _, tcfg = _cfgs("whisper-medium")
    params = TM.init_params(tcfg, seed=0, device="cpu")
    b, s = 2, 64
    _, tb = _split(_batch(tcfg, b, 2 * s))
    full = TM.forward(tcfg, params, tb)[0]
    cache = TM.build_encdec_cache(tcfg, params, tb["frames"], s,
                                  device="cpu")
    outs = []
    for t in range(s):
        lg, cache = TM.decode_step(tcfg, params, cache,
                                   tb["tokens"][:, t:t + 1], t)
        outs.append(lg)
    _close(torch.stack(outs, dim=1), full, LAW_TOL)


def test_build_encdec_cache_matches_reference(carried):
    jcfg, tcfg, params, tparams = carried["whisper-medium"]
    frames = np.random.default_rng(14).normal(
        size=(2, 40, jcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, f: JM.build_encdec_cache(jcfg, p, f, 40))(
        params, jnp.asarray(frames))
    got = TM.build_encdec_cache(tcfg, tparams, _t(frames), 40, device="cpu")
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], MATMUL_TOL)


# ------------------------------------------------------------ bf16 leaves --
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "zamba2-1.2b",
                                  "rwkv6-7b", "whisper-medium"])
def test_bf16_carry_keeps_the_reference_dtypes(arch):
    """A bf16 copy of the reduced config: every leaf the reference keeps
    in f32 (the router, a_log / dt_bias / d_skip, w0 / u_bonus, the ssm
    and wkv caches) is f32 in the port after ``params_from_numpy`` and
    in its own ``init_params`` / ``init_cache``, and stays f32 when it
    goes out (``params_to_numpy``) and comes back; every bf16 leaf
    crosses bit for bit."""
    jcfg, tcfg = _cfgs(arch, param_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, param_dtype=torch.bfloat16)
    params = _host(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    paths = jax.tree_util.tree_flatten_with_path(params)[0]
    tparams = convert.params_from_numpy(tcfg, params, "cpu")
    mine = TM.init_params(tcfg, seed=0, device="cpu")
    f32_seen = 0
    for port in (tparams, mine, convert.params_from_numpy(
            tcfg, convert.params_to_numpy(tparams), "cpu")):
        back = convert.params_to_numpy(port)
        assert (jax.tree.structure(back)
                == jax.tree.structure(params)), arch
        flat = jax.tree_util.tree_flatten_with_path(back)[0]
        for (path, want), (_, got) in zip(paths, flat):
            name = str(path[-1].key)
            if want.dtype == np.float32:
                f32_seen += 1
                assert name in TM.F32_LEAVES and got.dtype == np.float32
            else:
                assert want.dtype.name == "bfloat16"
                assert name not in TM.F32_LEAVES
        for t in port.parameters():
            assert t.dtype in (torch.float32, torch.bfloat16)
        names = {n.rsplit(".", 1)[-1]: t.dtype
                 for n, t in port.named_parameters()}
        for n, dt in names.items():
            assert dt == (torch.float32 if n in TM.F32_LEAVES
                          else torch.bfloat16), (arch, n)
    assert (f32_seen > 0) == (jcfg.family != "encdec")
    for (path, want), (_, got) in zip(
            paths, jax.tree_util.tree_flatten_with_path(
                convert.params_to_numpy(tparams))[0]):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    jcache = _host(JM.init_cache(jcfg, 2, 8))
    for cache in (convert.cache_from_numpy(tcfg, jcache, "cpu"),
                  TM.init_cache(tcfg, 2, 8, "cpu")):
        assert set(cache) == set(jcache)
        for name, a in jcache.items():
            want = torch.float32 if a.dtype == np.float32 else torch.bfloat16
            assert cache[name].dtype == want, (arch, name)
            assert tuple(cache[name].shape) == a.shape
        back = convert.cache_to_numpy(cache)
        for name, a in jcache.items():
            assert back[name].dtype == np.float32
