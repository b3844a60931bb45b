"""The port against the reference at 263 strata, on the CPU.

The taxi deployment (``bench/configs/approxiot-taxi-zones.json``) at a
small capacity: the 263 NYC TLC taxi zones as strata, zone r's share of
the items ``(1/r) / H_263`` (Zipf, s = 1) and its fares Gaussian with
mean ``10 + 30 (r - 1) / 262`` and a quarter of it as deviation, over the
testbed's tree (8 sources, fanin (4, 2, 1)). Both packages' ``compile``
→ ``init`` → two epochs of two ticks, ``neyman`` and ``fair`` on
``pallas_fused`` and ``topk``: every state buffer (the kept items, the
Eq. 9 weights and counts) and the telemetry bitwise, the answers within
the tolerance ``test_torch_pipeline._compare`` gives sums taken in
another order than the reference's compiled reductions (the port's chain
over the strata, XLA's vectorised reduce at 263); and one level-0 tick of each
package's ``whs.level_tick`` on the same keys: masks, reservoirs,
counts and weights bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as J  # noqa: E402
from repro.core import whs as jwhs  # noqa: E402
import repro_torch as P  # noqa: E402
from repro_torch.core import whs as twhs  # noqa: E402
from repro_torch.data import stream as S  # noqa: E402
from test_torch_pipeline import _bits, _compare  # noqa: E402

ZONES = 263
CAPACITY = 16384
RATE = 5000.0          # items a source a tick: 10,000 a level-0 node
TICKS, EPOCHS = 2, 2
CASES = [(b, a) for b in ("pallas_fused", "topk") for a in ("neyman", "fair")]


def _zones(rate=RATE):
    h = sum(1.0 / r for r in range(1, ZONES + 1))
    specs = []
    for r in range(1, ZONES + 1):
        mu = 10.0 + 30.0 * (r - 1) / 262
        specs.append(S.SubstreamSpec("gaussian", (mu, mu / 4),
                                     rate * (1.0 / r) / h))
    return specs


def _ingest(seed):
    sources = [S.StreamSource(_zones(), seed=seed + i) for i in range(8)]
    return S.batch_ingest(sources, TICKS, 4, CAPACITY)


def _spec(backend, allocation):
    return J.PipelineSpec(
        topology=J.TopologySpec(fanin=(4, 2, 1), capacity=CAPACITY,
                                num_strata=ZONES),
        sampler=J.SamplerSpec(mode="whs", backend=backend,
                              allocation=allocation, fraction=0.1),
        telemetry=J.TelemetrySpec(enabled=True), seed=11)


@pytest.mark.parametrize("backend,allocation", CASES)
def test_two_epochs_match_reference_at_263_zones(backend, allocation):
    jspec = _spec(backend, allocation)
    jp = J.compile(jspec)
    tp = P.compile(P.PipelineSpec.from_dict(jspec.to_dict()), device="cpu")
    js, ts = jp.init(), tp.init()
    for e in range(EPOCHS):
        b = _ingest(seed=100 * e)
        # every zone arrives in every tick (the tail's ~6 items a node
        # may miss a node: that stratum keeps its metadata there)
        for t in range(TICKS):
            live = np.concatenate([b.strata[t, i, :c]
                                   for i, c in enumerate(b.counts[t])])
            assert np.unique(live).size == ZONES
        js, jwa = jp.run_epoch(js, jp.default_key, b.values, b.strata,
                               b.counts)
        ts, twa = tp.run_epoch(ts, tp.default_key, b.values, b.strata,
                               b.counts)
        # The port folds the 263 strata's terms in one chain, as the
        # reference's compiled code does at 4 strata; at 263 XLA's
        # vectorised reductions take another order (1.06e-6 apart at
        # most here), so the answers are held to the tolerance for sums
        # in another order. Every state bit is compared exactly.
        _compare(jwa, twa, js, ts, exact_sums=False)


@pytest.mark.parametrize("backend,allocation", CASES)
def test_level_tick_masks_and_reservoirs_bitwise_at_263_zones(backend,
                                                              allocation):
    b = _ingest(seed=7)
    n = b.values.shape[1]
    values, strata = b.values[0], b.strata[0]
    valid = np.arange(CAPACITY)[None, :] < b.counts[0][:, None]
    w_in = np.ones((n, ZONES), np.float32)
    c_in = np.zeros((n, ZONES), np.float32)
    size = np.float32(CAPACITY * 0.1)
    keys = np.asarray(J.compile(_spec(backend, allocation)).default_key)
    keys = np.stack([keys + np.uint32(i) for i in range(n)])
    kw = dict(out_capacity=int(size), allocation=allocation, backend=backend)
    want = jwhs.level_tick(jnp.asarray(keys), *(jnp.asarray(a) for a in (
        values, strata, valid, w_in, c_in, size)), ZONES, **kw)
    got = twhs.level_tick(torch.from_numpy(keys.astype(np.int64)),
                          *(torch.from_numpy(np.asarray(a)) for a in (
                              values, strata, valid, w_in, c_in, size)),
                          ZONES, **kw)
    (jv, js, jslot, jmeta, jres), (tv, tsc, tslot, tmeta, tres) = want, got
    pairs = {"values_c": (tv, jv), "strata_c": (tsc, js),
             "slot_valid": (tslot, jslot), "weight": (tmeta.weight,
                                                      jmeta.weight),
             "count": (tmeta.count, jmeta.count),
             "selected": (tres.selected, jres.selected),
             "c": (tres.c, jres.c), "y": (tres.y, jres.y),
             "reservoir": (tres.reservoir, jres.reservoir),
             "w_out": (tres.meta.weight, jres.meta.weight),
             "c_out": (tres.meta.count, jres.meta.count)}
    for name, (t, j) in pairs.items():
        _bits(t.numpy(), np.asarray(j), name)
    # every zone is sampled somewhere, and no node keeps more than its budget
    assert np.all(tres.reservoir.numpy().sum(1) <= size)
    assert np.all((tres.y.numpy() > 0).any(0))
