"""The port's model zoo (dense and vlm) against the reference's, on the CPU.

Weights are the reference's ``init_params`` carried across with
``repro_torch.convert.params_from_numpy``; inputs are made with numpy.
Tolerances: norms and RoPE rtol = atol = 1e-5 (f32 elementwise, rsqrt,
cos and sin to the last bit); every function with a matrix product
rtol = atol = 1e-4 (f32 matmuls summed in other orders than XLA's);
``forward`` logits of the reduced (f32) configs against the jitted
reference, with ``attention_impl`` "pallas" (the Pallas kernel in
interpret mode there, the kernel's plain version here) and "xla", 1e-4;
``decode_step`` with a carried cache 1e-4; the reference's own law,
teacher-forced decode ≡ forward, 2e-2 as ``tests/test_models.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import train_step as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import train_step as TT  # noqa: E402

ELEM_TOL = 1e-5
MATMUL_TOL = 1e-4
LAW_TOL = 2e-2
ARCHS = ["smollm-135m", "qwen3-4b", "olmo-1b", "internvl2-1b"]


def _cfgs(arch, impl="xla"):
    return (dataclasses.replace(JR.get_config(arch).reduced(),
                                attention_impl=impl),
            dataclasses.replace(TR.get_config(arch).reduced(),
                                attention_impl=impl))


def _carry(jcfg, tcfg, seed=0):
    params = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return params, convert.params_from_numpy(tcfg, tree, "cpu")


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size,
                        (b, s - cfg.num_patches)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks).long()}
    if cfg.family == "vlm":
        pt = rng.normal(size=(b, cfg.num_patches, cfg.d_model))
        jb["patches"] = jnp.asarray(pt, jnp.float32)
        tb["patches"] = torch.from_numpy(pt.astype(np.float32))
    return jb, tb


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ----------------------------------------------------------------- configs --
def test_configs_are_the_reference_configs():
    assert TR.ARCH_NAMES == JR.ARCH_NAMES
    for name in JR.ARCH_NAMES:
        for jc, tc in ((JR.get_config(name), TR.get_config(name)),
                       (JR.get_config(name).reduced(),
                        TR.get_config(name).reduced())):
            jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
            assert (jnp.dtype(jd.pop("param_dtype")).name
                    == str(td.pop("param_dtype")).replace("torch.", ""))
            assert jd == td, name
            assert jc.param_count() == tc.param_count()
            assert jc.active_param_count() == tc.active_param_count()
    assert TR.get_config("smollm-135m").param_dtype == torch.bfloat16
    assert TR.get_config("smollm-135m").reduced().param_dtype == torch.float32
    for (a, s, ok, why) in TR.all_cells():
        assert (ok, why) == JR.shape_applicable(JR.get_config(a),
                                                JR.SHAPES[s])
    with pytest.raises(KeyError, match="unknown arch"):
        TR.get_config("gpt-5")


# ------------------------------------------------------------------ layers --
def test_norms_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(3.0, 2.0, (2, 5, 64)).astype(np.float32)
    scale = rng.normal(1.0, 0.1, (64,)).astype(np.float32)
    bias = rng.normal(0.0, 0.1, (64,)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    _close(TL.rmsnorm(tp, tx), JL.rmsnorm(jp, jx), ELEM_TOL)
    _close(TL.layernorm(tp, tx), JL.layernorm(jp, jx), ELEM_TOL)
    _close(TL.nonparametric_ln({}, tx), JL.nonparametric_ln({}, jx), ELEM_TOL)
    _close(TL.rope_freqs(32, 10_000.0), JL.rope_freqs(32, 10_000.0), ELEM_TOL)
    h = rng.normal(size=(2, 4, 7, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7)[None] + 100, (2, 7)).astype(np.int32)
    _close(TL.apply_rope(torch.from_numpy(h),
                         torch.from_numpy(pos)[:, None, :], 10_000.0),
           jax.jit(JL.apply_rope, static_argnums=2)(
               jnp.asarray(h), jnp.asarray(pos)[:, None, :], 10_000.0),
           ELEM_TOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-4b"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_attention_matches_reference(arch, impl):
    jcfg, tcfg = _cfgs(arch, impl)
    params, tparams = _carry(jcfg, tcfg)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 128, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(128)[None], (2, 128)).astype(np.int32)
    first = jax.tree.map(lambda a: a[0], params["layers"])
    want = jax.jit(lambda p, x, pos: JL.attention(
        p, jcfg, x, pos, attn_impl=impl))(first["attn"], jnp.asarray(x),
                                          jnp.asarray(pos))
    got = TL.attention(tparams["layers"][0]["attn"], tcfg,
                       torch.from_numpy(x), torch.from_numpy(pos),
                       attn_impl=impl)
    _close(got, want, MATMUL_TOL)


def test_attention_decode_and_mlps_match_reference():
    jcfg, tcfg = _cfgs("qwen3-4b")
    params, tparams = _carry(jcfg, tcfg)
    jl = jax.tree.map(lambda a: a[1], params["layers"])
    tl = tparams["layers"][1]
    rng = np.random.default_rng(3)
    b, s = 2, 16
    shape = (b, jcfg.num_kv_heads, s, jcfg.head_dim)
    kc = rng.normal(size=shape).astype(np.float32)
    vc = rng.normal(size=shape).astype(np.float32)
    x = rng.normal(size=(b, 1, jcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x, k, v: JL.attention_decode(
        p, jcfg, x, k, v, jnp.int32(9)))(jl["attn"], jnp.asarray(x),
                                         jnp.asarray(kc), jnp.asarray(vc))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = TL.attention_decode(tl["attn"], tcfg, torch.from_numpy(x), tk, tv,
                              9)
    for g, w in zip(got, want):
        _close(g, w, MATMUL_TOL)
    assert got[1] is tk and got[2] is tv        # updated in place
    h = rng.normal(size=(b, 5, jcfg.d_model)).astype(np.float32)
    _close(TL.swiglu(tl["mlp"], torch.from_numpy(h)),
           jax.jit(JL.swiglu)(jl["mlp"], jnp.asarray(h)), MATMUL_TOL)
    gp = JL.gelu_mlp_init(jax.random.PRNGKey(4), jcfg.d_model, 64,
                          jnp.float32)
    gp = dict(gp, b_up=gp["b_up"] + 0.1, b_down=gp["b_down"] - 0.2)
    tgp = {k: torch.from_numpy(np.array(v)) for k, v in gp.items()}
    _close(TL.gelu_mlp(tgp, torch.from_numpy(h)),
           jax.jit(JL.gelu_mlp)(gp, jnp.asarray(h)), MATMUL_TOL)
    toks = rng.integers(0, jcfg.vocab_size, (b, 5))
    _close(TL.embed(tparams["embed"], torch.from_numpy(toks)),
           JL.embed(params["embed"], jnp.asarray(toks)), 0.0)
    _close(TL.unembed(tparams["unembed"], torch.from_numpy(h)),
           jax.jit(JL.unembed)(params["unembed"], jnp.asarray(h)), MATMUL_TOL)


# ------------------------------------------------------------------- model --
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_forward_matches_reference(arch, impl):
    jcfg, tcfg = _cfgs(arch, impl)
    params, tparams = _carry(jcfg, tcfg)
    jb, tb = _batch(jcfg, 2, 128)
    want, _ = jax.jit(lambda p, b: JM.forward(jcfg, p, b))(params, jb)
    got, aux = TM.forward(tcfg, tparams, tb)
    assert got.shape == (2, 128, jcfg.vocab_size) and float(aux) == 0.0
    _close(got, want, MATMUL_TOL)
    prefill = TT.make_prefill_step(tcfg)(tparams, tb)
    assert torch.equal(prefill, got)


@pytest.mark.parametrize("arch", ["smollm-135m", "internvl2-1b"])
def test_decode_step_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    params, tparams = _carry(jcfg, tcfg)
    b, s = 2, 12
    rng = np.random.default_rng(5)
    cache = JM.init_cache(jcfg, b, s)
    cache = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), cache)
    tcache = convert.cache_from_numpy(tcfg, jax.tree.map(np.asarray, cache),
                                      "cpu")
    step = jax.jit(JT.make_decode_step(jcfg))
    tstep = TT.make_decode_step(tcfg)
    for pos in (0, 5, 11):
        tok = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        want, cache = step(params, cache, jnp.asarray(tok), jnp.int32(pos))
        got, tcache = tstep(tparams, tcache, torch.from_numpy(tok).long(),
                            pos)
        _close(got, want, MATMUL_TOL)
        for name in ("k", "v"):
            _close(tcache[name], cache[name], MATMUL_TOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-4b", "olmo-1b"])
def test_teacher_forced_decode_matches_forward(arch):
    """The reference's law (``tests/test_models.py``), on the port."""
    _, tcfg = _cfgs(arch)
    params = TM.init_params(tcfg, seed=0, device="cpu")
    b, s = 2, 64
    _, tb = _batch(tcfg, b, s)
    full = TM.forward(tcfg, params, tb)[0]
    cache = TM.init_cache(tcfg, b, s, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = TM.decode_step(tcfg, params, cache,
                                   tb["tokens"][:, t:t + 1], t)
        outs.append(lg)
    _close(torch.stack(outs, dim=1), full, LAW_TOL)


def test_params_round_trip_and_init_layout():
    jcfg, tcfg = _cfgs("qwen3-4b")
    params, tparams = _carry(jcfg, tcfg, seed=3)
    tree = jax.tree.map(np.asarray, params)
    back = convert.params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # random init: the reference's tree, shapes and scales
    mine = convert.params_to_numpy(TM.init_params(tcfg, seed=0, device="cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(tree)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.1, atol=1e-6)
    assert sum(a.size for a in jax.tree.leaves(mine)) == sum(
        a.size for a in jax.tree.leaves(tree))
    # bf16 weights cross bit for bit and come back as exact f32
    full = TR.get_config("smollm-135m")
    small = dataclasses.replace(full, num_layers=1, vocab_size=64)
    bf = JM.init_params(dataclasses.replace(JR.get_config("smollm-135m"),
                                            num_layers=1, vocab_size=64),
                        jax.random.PRNGKey(0))
    tb = convert.params_from_numpy(small, jax.tree.map(np.asarray, bf), "cpu")
    assert tb["embed"]["table"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(tb)),
                    jax.tree.leaves(bf)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    cache = {"k": np.arange(6, dtype=np.float32).reshape(1, 1, 1, 2, 3)}
    c2 = convert.cache_to_numpy(convert.cache_from_numpy(tcfg, cache, "cpu"))
    np.testing.assert_array_equal(c2["k"], cache["k"])


def test_cuda_is_the_default_device():
    cfg = TR.get_config("smollm-135m").reduced()
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_cache(cfg, 1, 4)
