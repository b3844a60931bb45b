"""The port's threefry keys and uniforms against ``jax.random``, bitwise.

jax runs with ``jax_threefry_partitionable=True`` (its default on the
pinned release), which is the scheme ``repro_torch.core.prng`` writes out.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import tree as jtree  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import tree as ttree  # noqa: E402


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


def test_golden_values():
    assert prng.PRNGKey(0).tolist() == [0, 0]
    assert prng.fold_in(prng.PRNGKey(0), 3).tolist() == [2467461003,
                                                         3840466878]
    np.testing.assert_allclose(prng.uniform(prng.PRNGKey(0), (3,)).numpy(),
                               [0.947667, 0.9785799, 0.33229148], rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -5])
def test_prng_key_matches(seed):
    _same_bits(prng.PRNGKey(seed).numpy().astype(np.uint32),
               jax.random.PRNGKey(seed))


@pytest.mark.parametrize("data", [0, 1, 3, 77, 2**31 + 5, 2**32 - 1])
def test_fold_in_matches_random_keys(data):
    for k in _keys(data % 1000, 4):
        want = jax.random.fold_in(jnp.asarray(k), data)
        got = prng.fold_in(torch.from_numpy(k.astype(np.int64)), data)
        _same_bits(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("num", [1, 2, 5, 33])
def test_split_matches(num):
    for k in _keys(num, 3):
        want = jax.random.split(jnp.asarray(k), num)
        got = prng.split(torch.from_numpy(k.astype(np.int64)), num)
        _same_bits(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("shape", [(1,), (7,), (1100,), (2201,), (3, 5),
                                   (2, 3, 37)])
def test_uniform_matches(shape):
    for k in _keys(sum(shape), 3):
        want = jax.random.uniform(jnp.asarray(k), shape)
        got = prng.uniform(torch.from_numpy(k.astype(np.int64)), shape)
        assert got.dtype == torch.float32
        _same_bits(got.numpy(), want)


def test_uniform_over_vmapped_node_keys():
    """The per-node priority draw of ``whs.level_tick``: one key per node
    from ``_level_keys``, ``uniform(k, (cap,))`` under ``vmap``."""
    key = jax.random.PRNGKey(9)
    for t, lvl, n, cap in [(1, 0, 4, 333), (17, 1, 2, 100), (5, 2, 1, 64)]:
        jkeys = jtree._level_keys(key, jnp.int32(t), lvl, n)
        want = jax.vmap(lambda k: jax.random.uniform(k, (cap,)))(jkeys)
        tkeys = ttree._level_keys(prng.PRNGKey(9), t, lvl, n)
        _same_bits(tkeys.numpy().astype(np.uint32), jkeys)
        _same_bits(prng.uniform(tkeys, (cap,)).numpy(), want)


def test_epoch_priorities_are_the_per_tick_draws():
    key = jax.random.PRNGKey(4)
    ts = torch.arange(5, dtype=torch.int64) + 11
    got = ttree.epoch_priorities(prng.PRNGKey(4), ts, 1, 3, 50)
    assert got.shape == (5, 3, 50)
    for i, t in enumerate(ts.tolist()):
        jkeys = jtree._level_keys(key, jnp.int32(t), 1, 3)
        want = jax.vmap(lambda k: jax.random.uniform(k, (50,)))(jkeys)
        _same_bits(got[i].numpy(), want)


def test_node_key_matches():
    key = jax.random.PRNGKey(123)
    want = jtree._node_key(key, jnp.int32(8), 2, 0)
    got = ttree._node_key(prng.PRNGKey(123), 8, 2, 0)
    _same_bits(got.numpy().astype(np.uint32), want)
