"""The port's ``sample_mask`` stage and ``pallas`` backend against the
reference's, on the CPU.

``thresholds_from_reservoirs`` (stage 1, plain PyTorch) against the
reference's compiled lexsort; ``sample_mask``'s plain version against
the reference's ``ref.sample_mask`` and its Pallas kernel in interpret
mode; ``PallasBackend.counts`` and ``select`` against the reference's
backend. Every comparison is bitwise: the inputs are the same numpy
arrays, the arithmetic one compare and one select per item. Valid items
carry strata in ``[0, X)`` only: for a valid item outside that range the
reference's kernel and its ``ref.py`` disagree (ROADMAP Watch list); the
port follows ``ref.py``, which ``test_padding_strata_follow_the_reference_ref``
shows for invalid slots.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import sampling as jsamp  # noqa: E402
from repro.kernels.sample_mask import ops as jsm  # noqa: E402
from repro.kernels.sample_mask import ref as jsm_ref  # noqa: E402
from repro_torch.core import sampling as tsamp  # noqa: E402
from repro_torch.kernels.sample_mask import ops as tsm  # noqa: E402
from repro_torch.kernels.sample_mask import ref as tsm_ref  # noqa: E402


def _bits(a, b, name=""):
    a, b = np.ascontiguousarray(np.asarray(a)), np.ascontiguousarray(
        np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, (name, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8), err_msg=name)


def _case(m, x, seed, ties=False, res=None, p_valid=0.9):
    rng = np.random.default_rng(seed)
    if ties:    # 29 priority levels: many exact f32 ties at τ
        u = (rng.integers(0, 29, m) / 29.0).astype(np.float32)
    else:
        u = rng.random(m).astype(np.float32)
    strata = rng.integers(0, x, m).astype(np.int32)
    valid = rng.random(m) < p_valid
    if res is None:
        res = rng.integers(1, max(m // x, 2), x).astype(np.float32)
    w = (rng.random(x) * 10).astype(np.float32)
    return u, strata, valid, np.asarray(res, np.float32), w


# The (m, x) cases of tests/test_kernels.py, then the edges: forced ties,
# N = 0 strata, strata with c ≤ N (keep all), 32 strata.
CASES = [
    dict(m=1000, x=4, seed=4000), dict(m=8192, x=32, seed=262144),
    dict(m=333, x=2, seed=666),
    dict(m=2048, x=4, seed=1, ties=True),
    dict(m=500, x=4, seed=2, res=[0, 30, 0, 5]),
    dict(m=300, x=4, seed=3, res=[500, 1, 300, 2]),
    dict(m=700, x=32, seed=5, ties=True, res=[0, 1000] * 16),
    dict(m=1, x=3, seed=6), dict(m=96, x=8, seed=7, p_valid=0.0),
]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"m{c['m']}x{c['x']}-{i}"
                              for i, c in enumerate(CASES)])
def test_thresholds_and_mask_match_reference(case):
    u, s, v, res, w = _case(**case)
    x = case["x"]
    want_tau = jsm.thresholds_from_reservoirs(u, s, v, res, x)
    got_tau = tsm.thresholds_from_reservoirs(
        *(torch.from_numpy(a) for a in (u, s, v, res)), x)
    _bits(got_tau.numpy(), want_tau, "tau")
    tau = np.array(want_tau)
    jk, jw = jsm.sample_mask(u, s, v, tau, w, impl="pallas")
    rk, rw = jax.jit(jsm_ref.sample_mask)(u, s, v, tau, w)
    tk, tw = tsm.sample_mask(*(torch.from_numpy(a) for a in (u, s, v, tau,
                                                             w)))
    for name, got, want in (("keep", tk, jk), ("w", tw, jw),
                            ("keep/ref", tk, rk), ("w/ref", tw, rw)):
        _bits(got.numpy(), want, name)


def test_mask_keeps_every_tie_and_obeys_the_sentinels():
    """τ = −1 keeps every valid item, +2 none; u == τ is kept."""
    u = np.array([0.25, 0.5, 0.5, 0.75, 0.0, 0.99, 0.5, 0.5], np.float32)
    s = np.array([0, 0, 0, 0, 1, 1, 2, 2], np.int32)
    v = np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)
    tau = np.array([0.5, -1.0, 2.0], np.float32)
    w = np.array([3.0, 4.0, 5.0], np.float32)
    keep, wt = tsm.sample_mask(*(torch.from_numpy(a) for a in (u, s, v, tau,
                                                              w)))
    assert keep.tolist() == [False, True, True, True, True, True, False,
                             False]
    assert wt.tolist() == [0.0, 3.0, 3.0, 3.0, 4.0, 4.0, 0.0, 0.0]


def test_padding_strata_follow_the_reference_ref():
    """Invalid slots carry arbitrary strata; the index is taken as the
    reference's ``ref.py`` takes it (negative from the end, then
    clamped), and nothing is kept for them."""
    rng = np.random.default_rng(9)
    m, x = 64, 4
    u = rng.random(m).astype(np.float32)
    s = rng.integers(-9, 9, m).astype(np.int32)
    s[:32] = rng.integers(0, x, 32)
    v = np.zeros(m, bool)
    v[:32] = True
    tau = np.array([0.3, 0.6, -1.0, 2.0], np.float32)
    w = np.array([1.5, 2.5, 3.5, 4.5], np.float32)
    want = jax.jit(jsm_ref.sample_mask)(u, s, v, tau, w)
    got = tsm_ref.sample_mask(*(torch.from_numpy(a) for a in (u, s, v, tau,
                                                             w)))
    for g, wnt in zip(got, want):
        _bits(g.numpy(), wnt)
    assert not got[0][32:].any()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("x", [4, 16])
def test_pallas_backend_matches_reference(ties, x):
    """``counts`` and ``select`` of both ``pallas`` backends on one
    composite-stratum problem (a flattened level), with reservoirs from
    the fair allocation; without ties the mask is the argsort one."""
    u, s, v, _, _ = _case(1024, x, 11 + x, ties=ties)
    jbe, tbe = jsamp.get_backend("pallas"), tsamp.get_backend("pallas")
    tc = tbe.counts(torch.from_numpy(s), torch.from_numpy(v), x)
    jc = jbe.counts(jnp.asarray(s), jnp.asarray(v), x)
    _bits(tc.numpy(), jc, "counts")
    res = jsamp.allocate_reservoirs(jnp.float32(200.0), jc)
    want = jbe.select(None, jnp.asarray(s), jnp.asarray(v), res, x,
                      priorities=jnp.asarray(u))
    got = tbe.select(None, torch.from_numpy(s), torch.from_numpy(v),
                     torch.from_numpy(np.array(res)), x,
                     priorities=torch.from_numpy(u))
    _bits(got.numpy(), want, "keep")
    argsort = tsamp.get_backend("argsort").select(
        None, torch.from_numpy(s), torch.from_numpy(v),
        torch.from_numpy(np.array(res)), x, priorities=torch.from_numpy(u))
    if ties:
        assert bool((got | ~argsort).all())     # keeps argsort's and more
    else:
        assert torch.equal(got, argsort)
