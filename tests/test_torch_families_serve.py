"""The serve CLI's decode loop and lines for the moe, encdec, hybrid and
ssm families, against the reference, on the CPU.

``serve_batch`` with carried weights gives the reference loop's greedy
tokens (``repro/launch/serve.py``'s loop: a fresh cache, the prompt
teacher-forced, greedy decode; encdec against the zero cross K/V of
``init_cache``); a token may differ only where the reference's top-2
logits are within ``TIE_GAP`` (1e-4, the model tests' f32 matmul
tolerance), and the rows are compared up to that point. The CLI prints
the reference's lines, numbers aside, for each family.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.launch import serve as JSV  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import train_step as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402

TIE_GAP = 1e-4
ARCHS = ["qwen2-moe-a2.7b", "whisper-medium", "zamba2-1.2b", "rwkv6-7b"]
SMALL = ["--smoke", "--requests", "4", "--batch", "2", "--prompt-len", "5",
         "--decode-len", "3"]


def _reference_loop(cfg, params, toks, decode_len):
    """The reference CLI's loop, keeping every decoded step's logits."""
    decode = jax.jit(JT.make_decode_step(cfg))
    b, prompt_len = toks.shape
    max_len = prompt_len + decode_len
    cache = JM.init_cache(cfg, b, max_len)
    tok = jnp.asarray(toks[:, :1], jnp.int32)
    for pos in range(prompt_len - 1):
        _, cache = decode(params, cache,
                          jnp.asarray(toks[:, pos:pos + 1], jnp.int32),
                          jnp.int32(pos))
    out, logits_all = [], []
    for pos in range(prompt_len - 1, max_len):
        logits, cache = decode(params, cache, tok, jnp.int32(pos))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok))
        logits_all.append(np.asarray(logits))
    return np.concatenate(out, 1), np.stack(logits_all, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_gives_the_reference_tokens(arch):
    jcfg = JR.get_config(arch).reduced()
    tcfg = TR.get_config(arch).reduced()
    if jcfg.family == "hybrid":    # segments [2, 1]
        jcfg = dataclasses.replace(jcfg, num_layers=3)
        tcfg = dataclasses.replace(tcfg, num_layers=3)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (4, 10))
    want, logits = _reference_loop(jcfg, params, toks, 6)
    got = TSV.serve_batch(tcfg, tparams, torch.from_numpy(toks), 6).numpy()
    assert got.shape == want.shape == (4, 7)
    for b in range(4):
        for t in range(want.shape[1]):
            if got[b, t] != want[b, t]:
                top2 = np.sort(logits[b, t])[-2:]
                assert top2[1] - top2[0] < TIE_GAP, (b, t, top2)
                break


def _shape(text: str) -> list[str]:
    return [re.sub(r"\d+(\.\d+)?(e[+-]\d+)?", "#", line)
            for line in text.strip().splitlines()]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_prints_the_reference_lines(arch, capsys):
    mean, exact = TSV.main(SMALL + ["--arch", arch, "--device", "cpu"])
    got = capsys.readouterr().out
    JSV.main(SMALL + ["--arch", arch])
    want = capsys.readouterr().out
    assert _shape(got) == _shape(want)
    assert np.isfinite(mean) and mean == pytest.approx(exact, rel=1e-5)
