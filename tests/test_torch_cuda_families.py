"""The moe, encdec, hybrid and ssm families and training on the card,
against the same calls on the CPU.

Every test needs a CUDA device: each carries the ``cuda`` marker and
skips without one. The module imports neither JAX nor the reference:

    python -m pytest -m cuda tests/test_torch_cuda_families.py

The reduced (f32) configs with the same weights on both devices:
``forward`` with ``attention_impl`` "pallas" (the flash kernel, launched
once per causal self-attention: every moe layer, every encdec decoder
layer, once per hybrid segment, never for ssm) and "xla", within
``TOL`` 1e-4 of the CPU (f32 sums in other orders, the CUDA-core flash
kernel against its plain version); ``decode_step`` with a carried cache
within ``TOL``; one ``make_train_step`` of each family within ``TOL``
on the loss, ``grad_norm`` and ``lr``, each leaf's gradient (from ``m``,
``0.1·clip_scale·g`` at the first step) and ``m`` within ``TOL`` plus
``TOL`` times the leaf's largest entry, ``v`` (``∝ g²``) within twice
that, as squaring doubles a relative error; the parameters
within ``TOL`` plus ``2·lr`` where the gradient entry is under 1e-6 (the
step moves a parameter by ``lr·g/(|g| + eps)``, which turns on that
entry's rounding there). A bf16 copy keeps its f32 leaves f32 on the
card, and the train CLI runs there.
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.launch import train as TTRAIN  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import train_step as TT  # noqa: E402

TOL = 1e-4
TINY_GRAD = 1e-6
FAMILY_ARCHS = ["qwen2-moe-a2.7b", "grok-1-314b", "whisper-medium",
                "zamba2-1.2b", "rwkv6-7b"]
TRAIN_ARCHS = ["smollm-135m", "internvl2-1b", "qwen2-moe-a2.7b",
               "whisper-medium", "zamba2-1.2b", "rwkv6-7b"]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _cfg(arch, **kw):
    cfg = TR.get_config(arch).reduced()
    if cfg.family == "hybrid":           # segments [2, 1]
        cfg = dataclasses.replace(cfg, num_layers=3)
    return dataclasses.replace(cfg, **kw)


def _batch(cfg, b=2, s=128, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    out = {"tokens": toks, "labels": labels,
           "weight": torch.from_numpy(rng.uniform(0.5, 3, b).astype(
               np.float32))}
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.normal(
            size=(b, s // 2, cfg.d_model)).astype(np.float32))
        out["tokens"], out["labels"] = toks[:, :s // 2], labels[:, :s // 2]
    if cfg.family == "vlm":
        p = cfg.num_patches
        out["patches"] = torch.from_numpy(rng.normal(
            size=(b, p, cfg.d_model)).astype(np.float32))
        out["tokens"], out["labels"] = toks[:, :s - p], labels[:, :s - p]
    return out


def _to(batch, dev):
    return {k: v.to(dev) for k, v in batch.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().cpu().float().numpy(),
                               want.detach().cpu().float().numpy(),
                               rtol=tol, atol=tol)


def _leaf_close(got, want, what, tol):
    """Within ``tol`` of each entry plus ``tol`` times the leaf's largest
    entry: a leaf's own scale, so a leaf off by a factor fails."""
    want = want.detach().cpu().float().numpy()
    np.testing.assert_allclose(got.detach().cpu().float().numpy(), want,
                               rtol=tol,
                               atol=tol * float(np.abs(want).max(
                                   initial=0.0)), err_msg=what)


def _flash_per_forward(cfg) -> int:
    if cfg.family == "hybrid":
        return len(TM._segments(cfg))
    return 0 if cfg.family == "ssm" else cfg.num_layers


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_on_the_card_is_the_cpu(cuda_device, arch):
    cfg = _cfg(arch, attention_impl="pallas")
    params = TM.init_params(cfg, seed=0, device="cpu")
    card = copy.deepcopy(params).to(cuda_device)
    batch = _batch(cfg)
    want = TM.forward(cfg, params, batch)
    for impl in ("pallas", "xla"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        reset_launches()
        got = TT.make_prefill_step(c)(card, _to(batch, cuda_device))
        torch.cuda.synchronize()
        n = _flash_per_forward(cfg) if impl == "pallas" else 0
        assert LAUNCHES["flash_attention"] == n, (impl, dict(LAUNCHES))
        _close(got, want[0])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_step_on_the_card_is_the_cpu(cuda_device, arch):
    cfg = _cfg(arch)
    params = TM.init_params(cfg, seed=1, device="cpu")
    card = copy.deepcopy(params).to(cuda_device)
    b, s = 2, 12
    rng = np.random.default_rng(2)
    cache = {k: torch.from_numpy(0.5 * rng.normal(size=v.shape)).to(v.dtype)
             for k, v in TM.init_cache(cfg, b, s, "cpu").items()}
    ccache = {k: v.to(cuda_device) for k, v in cache.items()}
    step, cstep = TT.make_decode_step(cfg), TT.make_decode_step(cfg)
    for pos in (0, 5, 11):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)))
        want, cache = step(params, cache, tok, pos)
        got, ccache = cstep(card, ccache, tok.to(cuda_device), pos)
        _close(got, want)
        for name in cache:
            _close(ccache[name], cache[name])


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_is_the_cpu(cuda_device, arch):
    cfg = _cfg(arch)
    opt_cfg = TA.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    params = TM.init_params(cfg, seed=0, device="cpu")
    card = copy.deepcopy(params).to(cuda_device)
    opt, copt = TA.init(params, "cpu"), TA.init(card, cuda_device)
    batch = _batch(cfg, seed=3)
    step = TT.make_train_step(cfg, opt_cfg)
    p2, o2, met = step(params, opt, batch)
    cp2, co2, cmet = step(card, copt, _to(batch, cuda_device))
    for k in met:
        _close(cmet[k], met[k])
    # the gradients from m = (1 − b1)·g·clip_scale, each side's own scale
    cmg, mg = (0.1 * min(1.0, 1.0 / max(float(x["grad_norm"]), 1e-9))
               for x in (cmet, met))
    for name in ("grad", "m", "v"):
        key = "m" if name == "grad" else name
        got, want = co2[key].parameters(), o2[key].parameters()
        for i, (a, b) in enumerate(zip(got, want, strict=True)):
            if name == "grad":
                a, b = a / cmg, b / mg
            _leaf_close(a, b, f"{arch} {name} leaf {i}",
                        2 * TOL if name == "v" else TOL)
    for got, want in ((cp2, p2), (co2["master"], o2["master"])):
        for a, b, m in zip(got.parameters(), want.parameters(),
                           o2["m"].parameters()):
            a, b = a.cpu().float(), b.float()
            g = m.abs() / mg
            slack = torch.where(g < TINY_GRAD, 2 * opt_cfg.lr, 0.0)
            assert bool(((a - b).abs() <= TOL * (1 + b.abs()) + slack)
                        .all()), arch


def test_bf16_copies_keep_their_f32_leaves_on_the_card(cuda_device):
    for arch in ("qwen2-moe-a2.7b", "zamba2-1.2b", "rwkv6-7b"):
        cfg = _cfg(arch, param_dtype=torch.bfloat16,
                   attention_impl="pallas")
        params = TM.init_params(cfg, seed=0, device=cuda_device)
        for name, t in params.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            assert t.dtype == (torch.float32 if leaf in TM.F32_LEAVES
                               else torch.bfloat16), (arch, name)
        logits = TT.make_prefill_step(cfg)(params,
                                           _to(_batch(cfg), cuda_device))
        assert logits.dtype == torch.bfloat16
        assert bool(torch.isfinite(logits).all())
        back = convert.params_to_numpy(params)
        again = convert.params_from_numpy(cfg, back, cuda_device)
        for a, b in zip(again.parameters(), params.parameters()):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_cli_runs_on_the_card(cuda_device, tmp_path, capsys):
    losses = TTRAIN.main(["--smoke", "--steps", "6", "--batch", "4", "--seq",
                          "64", "--log-every", "2", "--ckpt-dir",
                          str(tmp_path)])
    out = capsys.readouterr().out
    assert out.splitlines()[-1].startswith("done: 6 steps in")
    assert len(losses) == 6 and np.isfinite(losses).all()
