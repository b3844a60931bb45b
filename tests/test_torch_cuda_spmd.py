"""The mesh data plane on the card: ranks on CUDA against CPU ranks.

Every test needs a CUDA device: each carries the ``cuda`` marker and
skips without one. The module imports neither JAX nor the reference:

    python -m pytest -m cuda tests/test_torch_cuda_spmd.py

Two gloo ranks sharing the card (``cuda:0``, each collective's operand
staged through the host) run the tenant query plane with
``pallas_fused`` and give the answers and sketch rows of two gloo ranks
on the CPU, bitwise but for the sketches' bounds (a sum over the
sketch's weights in another order, ``SKETCH_BOUND_RTOL``); with two
cards or more, two NCCL ranks (one card each) do too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as P  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.query import QueryRegistry as Q  # noqa: E402

import torch_spmd_ranks as R  # noqa: E402

SKETCH_BOUND_RTOL = 1e-5
SKETCH_KINDS = ("quantile", "windowed_quantile", "heavy_hitters",
                "decayed_heavy_hitters")
PATH_KERNELS = ("fused_select", "stratified_stats", "cms_update",
                "quantile_compact", "segment_sum")
T, M = 4, 8192

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _job():
    a = (Q().register_sum().register_count().register_mean()
         .register_quantile("q", (0.5, 0.9), capacity=64)
         .register_heavy_hitters("hh", k=4, width=64, depth=2))
    b = (Q().register_count("n").register_histogram("h", 0.0, 128.0, 16)
         .register_windowed_quantile("w", (0.5,), capacity=32, window=2)
         .register_decayed_heavy_hitters("d", k=4, width=64, decay=0.8))
    spec = P.PipelineSpec(
        topology=P.TopologySpec(fanin=(4, 2, 1), capacity=M // 8,
                                num_strata=3),
        sampler=P.SamplerSpec(mode="whs", backend="pallas_fused",
                              fraction=0.25),
        tenants=(a.as_tenant("a"), b.as_tenant("b")), seed=0)
    rng = np.random.default_rng(0)
    vals = np.round(rng.normal(50.0, 9.0, (T, M))).astype(np.float32)
    strs = rng.integers(0, 3, (T, M)).astype(np.int32)
    return dict(values=vals, strata=strs, tenant=spec.to_dict())


def _held_to_cpu(card, cpu):
    lay = card[0]["tenant"]["layout"]
    sketch = np.asarray([c for o, w, kind in lay.values()
                         if kind in SKETCH_KINDS for c in range(o, o + w)])
    for r, c in zip(card, cpu):
        assert r["device"].startswith("cuda")
        got, want = r["tenant"]["wa"], c["tenant"]["wa"]
        for k, v in want.items():
            if k == "bounds":
                rest = np.setdiff1d(np.arange(v.shape[-1]), sketch)
                np.testing.assert_array_equal(got[k][:, rest], v[:, rest])
                np.testing.assert_allclose(got[k][:, sketch], v[:, sketch],
                                           rtol=SKETCH_BOUND_RTOL, atol=0)
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=k)
        for x, y in zip(r["tenant"]["qstate"], c["tenant"]["qstate"]):
            np.testing.assert_array_equal(x, y)
        for name in PATH_KERNELS:
            assert r["tenant"]["launches"][name] > 0, name


def test_gloo_ranks_sharing_the_card_match_cpu_ranks(cuda_device):
    job = _job()
    cpu = spawn_ranks(R.run_rank, 2, args=(2, "cpu", "gloo", job),
                      device="cpu", backend="gloo", timeout_s=300)
    card = spawn_ranks(R.run_rank, 2, args=(2, "cuda", "gloo", job),
                       device="cuda", backend="gloo", timeout_s=300)
    assert {r["device"] for r in card} == {"cuda:0"}
    _held_to_cpu(card, cpu)


def test_nccl_ranks_match_cpu_ranks(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("an NCCL mesh of 2 ranks needs 2 cards (NCCL refuses "
                    "two ranks on one card)")
    job = _job()
    cpu = spawn_ranks(R.run_rank, 2, args=(2, "cpu", "gloo", job),
                      device="cpu", backend="gloo", timeout_s=300)
    card = spawn_ranks(R.run_rank, 2, args=(2, "cuda", "nccl", job),
                       device="cuda", backend="nccl", timeout_s=300)
    assert [r["device"] for r in card] == ["cuda:0", "cuda:1"]
    _held_to_cpu(card, cpu)
