"""The port's serve CLI (one-shot mode, ``--hot-admit``) against the
reference's, on the CPU (``--serve-loop``: ``tests/test_torch_serve_plane.py``).

``ticks_to_ingest`` and the telemetry plane (``telemetry_spec``: 2 edge
aggregators → 1 root, the dashboard tenant) are held bitwise against the
reference on fixed tick records, but for the quantile sketch's rank bound,
held to ``TOTAL_RTOL`` 1e-5 (an f32 sum over the sketch's slots in another
order). The decode loop (``serve_batch``) with carried weights gives the
reference loop's greedy tokens; a token may differ only where the
reference's top-2 logits are within ``TIE_GAP`` (1e-4, the model tests'
f32 matmul tolerance), and the rows are compared up to that point.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.configs import registry as JR  # noqa: E402
from repro.data import stream as JS  # noqa: E402
from repro.launch import serve as JSV  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import train_step as JT  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.data import stream as TS  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402

TOTAL_RTOL = 1e-5
TIE_GAP = 1e-4
SMALL = ["--smoke", "--requests", "6", "--batch", "2", "--prompt-len", "5",
         "--decode-len", "3"]


def _bits(a, b, name=""):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, name
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8), err_msg=name)


def _records(seed=0, ticks=6, batch=8):
    rng = np.random.default_rng(seed)
    return [(rng.lognormal(3.0, 0.6, batch).astype(np.float32),
             rng.integers(0, TSV.NUM_CLASSES, batch).astype(np.int32))
            for _ in range(ticks)]


def test_ticks_to_ingest_is_the_reference():
    recs = _records(1, ticks=5, batch=150)
    for n_nodes, width in ((2, 64), (3, 100), (1, 200)):
        got = TS.ticks_to_ingest(recs, n_nodes=n_nodes, width=width)
        want = JS.ticks_to_ingest(recs, n_nodes=n_nodes, width=width)
        for f in ("values", "strata", "counts", "offered"):
            _bits(getattr(got, f), getattr(want, f), f)
        assert got.exact_sum == want.exact_sum
        assert got.exact_count == want.exact_count


def test_registries_and_spec_are_the_reference():
    assert (TSV.NUM_CLASSES, TSV.EDGE_NODES) == (JSV.NUM_CLASSES,
                                                 JSV.EDGE_NODES)
    for fn in ("dashboard_registry", "serve_registry"):
        t = getattr(TSV, fn)().as_tenant("x")
        j = getattr(JSV, fn)().as_tenant("x")
        assert repr(t) == repr(j)
    spec = TSV.telemetry_spec(64, 0.25, seed=3, telemetry=True)
    ref = JSV.telemetry_spec(64, 0.25, seed=3, telemetry=True)
    assert spec.to_dict() == ref.to_dict()


@pytest.mark.parametrize("fraction,telemetry", [(0.25, False), (0.5, True)])
def test_telemetry_plane_answers_are_the_reference(fraction, telemetry):
    recs = _records(2, ticks=6, batch=40)
    cap = max(64, 40)
    tp = tapi.compile(TSV.telemetry_spec(cap, fraction, telemetry=telemetry),
                      device="cpu")
    jp = japi.compile(JSV.telemetry_spec(cap, fraction, telemetry=telemetry))
    tb = TS.ticks_to_ingest(recs, n_nodes=TSV.EDGE_NODES, width=cap)
    jb = JS.ticks_to_ingest(recs, n_nodes=JSV.EDGE_NODES, width=cap)
    tst, twa = tp.run_epoch(tp.init(), tp.default_key, tb.values, tb.strata,
                            tb.counts)
    jst, jwa = jp.run_epoch(jp.init(), jp.default_key, jb.values, jb.strata,
                            jb.counts)
    trows, jrows = tp.rows(twa), jp.rows(jwa)
    assert len(trows) == len(jrows) == 6
    layout = jp.query_layout()
    assert tp.query_layout() == layout
    o, w, _ = layout["latency_q_ms"]
    rank = np.arange(o, o + w)
    for tr, jr in zip(trows, jrows):
        assert tr["n_sampled"] == jr["n_sampled"]
        _bits(np.asarray(tr["answers"]), np.asarray(jr["answers"]))
        tb_, jb_ = np.asarray(tr["bounds"]), np.asarray(jr["bounds"])
        exact = np.setdiff1d(np.arange(jb_.shape[-1]), rank)
        _bits(tb_[exact], jb_[exact], "bounds")
        np.testing.assert_allclose(tb_[rank], jb_[rank], rtol=TOTAL_RTOL)
        for q in ("requests", "latency_total_ms", "latency_mean_ms",
                  "latency_q_ms"):
            _bits(tp.answer(tr["answers"], q, tenant="dashboard"),
                  jp.answer(jr["answers"], q, tenant="dashboard"), q)
    assert tp.plan.k == jp.plan.k == 4
    if telemetry:
        from repro.obs import telemetry as JO
        from repro_torch.obs import telemetry as TO

        t_snap, j_snap = TO.snapshot(tst), JO.snapshot(jst)
        assert t_snap["windows"] == j_snap["windows"]
        assert t_snap["bound_2sigma"] == j_snap["bound_2sigma"]


def _reference_loop(cfg, params, toks, decode_len):
    """The reference CLI's loop (``repro/launch/serve.py``), keeping every
    decoded step's logits."""
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


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-4b"])
def test_serve_batch_gives_the_reference_tokens(arch):
    jcfg = JR.get_config(arch).reduced()
    tcfg = TR.get_config(arch).reduced()
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
    """The printed lines with every number blanked."""
    return [re.sub(r"\d+(\.\d+)?(e[+-]\d+)?", "#", line)
            for line in text.strip().splitlines()]


def test_main_prints_the_reference_lines(capsys, tmp_path):
    extra = ["--telemetry", "--metrics-dump", str(tmp_path / "m.txt")]
    mean, exact = TSV.main(SMALL + ["--device", "cpu"] + extra)
    got = capsys.readouterr().out
    JSV.main(SMALL + extra)
    want = capsys.readouterr().out
    assert _shape(got) == _shape(want)
    # the count of windows, queries and records does not depend on timing
    line = [ln for ln in got.splitlines() if ln.startswith("telemetry plane")]
    assert line == [ln for ln in want.splitlines()
                    if ln.startswith("telemetry plane")]
    assert np.isfinite(mean) and mean == pytest.approx(exact, rel=1e-5)
    assert (tmp_path / "m.txt").read_text().startswith("#")


@pytest.mark.parametrize("flag,item", [
    (["--mesh", "2", "--mesh-backend", "nccl"], "one rank per CUDA card")])
def test_unported_modes_raise(flag, item):
    """A mode this machine cannot run raises before anything starts: an
    NCCL mesh on CPU ranks (NCCL runs one rank a card)."""
    with pytest.raises(ValueError, match=item):
        TSV.main(SMALL + ["--device", "cpu"] + flag)


def test_hot_admit_prints_the_reference_lines(capsys):
    """``--hot-admit``: the same lines as the reference, numbers aside;
    the admit opens a new slot group (one program built) and the retire +
    re-admit into the warm slot builds none, in both packages."""
    TSV.main(SMALL + ["--hot-admit", "--device", "cpu"])
    got = capsys.readouterr().out
    JSV.main(SMALL + ["--hot-admit"])
    want = capsys.readouterr().out
    assert _shape(got) == _shape(want)
    assert got.splitlines()[0].startswith("hot-admit 'slo' tenant after 1/3")
    line = [ln for ln in got.splitlines() if "churn cost" in ln][0]
    assert "traced 1 program(s)" in line and "warm slot traced 0" in line
    plane = [ln for ln in got.splitlines() if ln.startswith("telemetry")]
    assert plane == [ln for ln in want.splitlines()
                     if ln.startswith("telemetry")]


def test_requests_below_batch_is_refused_and_cuda_is_the_default():
    with pytest.raises(SystemExit):
        TSV.main(["--requests", "2", "--batch", "4", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TSV.main(SMALL)


def test_serve_batch_reproduces_the_first_token_input():
    """The reference feeds ``toks[:, :1]`` (the prompt's first token) as
    the first decoded input at ``prompt_len − 1``; so does the port: two
    prompts that differ only in their last token decode the same."""
    cfg = dataclasses.replace(TR.get_config("smollm-135m").reduced(),
                              num_layers=1)
    from repro_torch.models import model as TM

    params = TM.init_params(cfg, seed=1, device="cpu")
    a = torch.from_numpy(np.random.default_rng(6).integers(0, 512, (2, 6)))
    b = a.clone()
    b[:, -1] = (b[:, -1] + 1) % cfg.vocab_size
    assert torch.equal(TSV.serve_batch(cfg, params, a, 3),
                       TSV.serve_batch(cfg, params, b, 3))
