"""The port's flash attention against the reference's, on the CPU.

The plain version of the port's kernel (``kernels/flash_attention/ref.py``
``flash_attention``, what the wrapper runs on a CPU tensor) against the
reference's Pallas kernel in interpret mode
(``repro.kernels.flash_attention.ops.attention(..., impl="pallas")``),
over the reference test's own shapes. Tolerances: f32 atol = rtol = 1e-5
(both are blockwise with the same blocks and rounding points; only the
order of the dot products' sums and the exp's last bit differ); bf16
2e-2, the reference's own tolerance (``tests/test_kernels.py``). The
port's S×S oracle is held against the reference's oracle too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as J  # noqa: E402
from repro.kernels.flash_attention import ref as Jref  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.flash_attention import ops as T  # noqa: E402
from repro_torch.kernels.flash_attention import ref as Tref  # noqa: E402

# The reference test's shapes, then two short sequences (S < 128: one kv
# block of S columns, which the card's bf16 kernel reads as a 128-row tile
# with the rows and columns past S masked).
SHAPES = [(1, 2, 1, 128, 64), (2, 4, 2, 256, 64), (1, 8, 2, 256, 128),
          (2, 3, 3, 128, 32), (1, 4, 2, 64, 64), (1, 6, 2, 16, 32)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2e-2}


def _inputs(b, hq, hkv, s, d, seed=None):
    rng = np.random.default_rng(b * s + d if seed is None else seed)
    return [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _both(arrs, dt):
    jdt, tdt = DTYPES[dt]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,s,d", SHAPES)
def test_plain_version_matches_reference_kernel(b, hq, hkv, s, d, dt):
    jx, tx = _both(_inputs(b, hq, hkv, s, d), dt)
    want = np.asarray(J.attention(*jx, impl="pallas"), np.float32)
    reset_launches()
    got = T.flash_attention(*tx)
    assert LAUNCHES["flash_attention"] == 0     # the CPU launches nothing
    assert got.dtype == DTYPES[dt][1] and got.shape == (b, hq, s, d)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dt],
                               atol=TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,s,d", SHAPES)
def test_oracle_matches_reference_oracle(b, hq, hkv, s, d, dt):
    jx, tx = _both(_inputs(b, hq, hkv, s, d), dt)
    want = np.asarray(Jref.attention(*jx, causal=True), np.float32)
    got = Tref.attention(*tx, causal=True).float().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.parametrize("b,hq,hkv,s,d", SHAPES)
def test_plain_version_matches_oracle(b, hq, hkv, s, d):
    """The reference test's law, f32: flash ≡ the S×S oracle (its 2e-3)."""
    _, tx = _both(_inputs(b, hq, hkv, s, d), "f32")
    np.testing.assert_allclose(T.flash_attention(*tx).numpy(),
                               Tref.attention(*tx).numpy(), rtol=2e-3,
                               atol=2e-3)


def test_flash_attention_is_causal():
    """Future kv must not leak: perturbing k/v at t > t0 leaves outputs at
    positions ≤ t0 unchanged (the reference test's law, atol 1e-5)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 256, 64, 0))
    o1 = T.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 200:] = 99.0
    v2[:, :, 200:] = -99.0
    o2 = T.flash_attention(q, k2, v2)
    np.testing.assert_allclose(o1[:, :, :200].numpy(), o2[:, :, :200].numpy(),
                               atol=1e-5)
    assert float((o1[:, :, 200:] - o2[:, :, 200:]).abs().max()) > 0.1


@pytest.mark.parametrize("s", [192, 320])
def test_seq_that_does_not_tile_raises(s):
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, s, 32, 0))
    with pytest.raises(ValueError, match="tile evenly"):
        T.flash_attention(q, k, v)


def test_short_sequence_is_one_block():
    """S < 128: one block of S, as the reference's min(128, S)."""
    arrs = _inputs(1, 4, 2, 96, 32, 5)
    jx, tx = _both(arrs, "f32")
    np.testing.assert_allclose(
        T.flash_attention(*tx).numpy(),
        np.asarray(J.attention(*jx, impl="pallas")), rtol=1e-5, atol=1e-5)
