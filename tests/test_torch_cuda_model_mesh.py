"""The model mesh on the card: a sharded train step on gloo ranks that
share it, against the one-rank card step.

Every test needs a CUDA device: each carries the ``cuda`` marker and
skips without one. The module imports neither JAX nor the reference:

    python -m pytest -m cuda tests/test_torch_cuda_model_mesh.py

Gloo ranks share ``cuda:0`` (every collective staged through the
host). A bf16 sharded prefill through the flash kernel on data 2 × model
2 ranks (a reduced SmolLM-135M with its own 9 / 3 heads: K/V repeated,
heads padded; and with 4 / 2: grouped) launches the kernel once a layer
on every rank, and each rank's first launch is bitwise the one-rank
kernel's output on the same (batch, head) block. And a reduced
SmolLM-135M takes one step on a ``data 2 × model 1``
and a ``data 1 × model 2`` mesh from seeded weights. The loss and
``grad_norm`` are within ``STEP_TOL`` of the one-rank step's; each
leaf's gradient (recovered from ``m``), ``m`` and ``v`` within
``STEP_TOL`` plus ``STEP_TOL`` times the leaf's largest entry, as
``tests/test_torch_model_mesh.py`` holds them; and each parameter within
``STEP_TOL · (1 + |p|)``, plus ``2·lr`` only where the one-rank gradient
is under ``TINY_GRAD`` (AdamW's first step moves such an entry by up to
``lr`` either way, whatever its sign).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import spawn_ranks  # noqa: E402

import torch_model_mesh_ranks as R  # noqa: E402

STEP_TOL = 1e-4
TINY_GRAD = 1e-6
LR = 1e-3

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree, np.float32)]


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_sharded_step_on_ranks_sharing_the_card(cuda_device, shape):
    ranks = spawn_ranks(R.card_train_step, 2, args=(shape, "smollm-135m"),
                        device="cuda", backend="gloo", timeout_s=600)
    got, want = ranks[0], ranks[0]["one_rank"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=STEP_TOL)

    def grads(side):
        # m = (1 − b1)·g·clip_scale after the first step
        scale = min(1.0, 1.0 / max(side["metrics"]["grad_norm"], 1e-9))
        return [m / (0.1 * scale) for m in _leaves(side["m"])]

    g_want = grads(want)
    for kind, a_tree, b_tree in (
            ("grad", grads(got), g_want),
            ("m", _leaves(got["m"]), _leaves(want["m"])),
            ("v", _leaves(got["v"]), _leaves(want["v"]))):
        for i, (a, b) in enumerate(zip(a_tree, b_tree, strict=True)):
            atol = STEP_TOL * float(np.abs(b).max(initial=0.0))
            np.testing.assert_allclose(a, b, rtol=STEP_TOL, atol=atol,
                                       err_msg=f"{kind} leaf {i}")
    for a, b, gw in zip(_leaves(got["params"]), _leaves(want["params"]),
                        g_want, strict=True):
        slack = np.where(np.abs(gw) < TINY_GRAD, 2 * LR, 0.0)
        assert (np.abs(a - b) <= STEP_TOL * (1 + np.abs(b)) + slack).all()
    assert got["ledger"]["calls"] > 0
    assert got["ledger"]["host_copies"] >= 2 * got["ledger"]["calls"]
    for r in ranks[1:]:
        for a, b in zip(_leaves(r["params"]), _leaves(got["params"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("heads", [(9, 3), (4, 2)])
def test_sharded_prefill_runs_the_kernel_on_every_rank(cuda_device, heads):
    from repro_torch.kernels.flash_attention import ops as fa

    kw = dict(num_heads=heads[0], num_kv_heads=heads[1])
    ranks = spawn_ranks(R.card_prefill, 4, args=("smollm-135m", kw),
                        device="cuda", backend="gloo", timeout_s=600)
    for r in ranks:
        assert r["launches"] == r["layers"]
    blocks = {r["coords"]: r["core"] for r in ranks}

    def whole(i):
        return torch.cat([torch.cat([blocks[(d, m)][i] for m in range(2)],
                                    dim=1) for d in range(2)], dim=0)

    q, k, v = (whole(i).to(cuda_device) for i in range(3))
    h, hkv = heads
    hl = q.shape[1] // 2
    if hkv % 2:          # repeated and padded: back to the GQA layout
        g = h // hkv
        assert not q[:, h:].any() and not k[:, h:].any()
        q, k, v = q[:, :h], k[:, :h:g], v[:, :h:g]
    one = fa.flash_attention(q, k, v).cpu()
    bl = q.shape[0] // 2
    for (d, m), core in blocks.items():
        real = min(hl, h - m * hl)
        o = core[3]
        assert torch.equal(o[:, :real].view(torch.int16),
                           one[d * bl:(d + 1) * bl, m * hl:m * hl + real]
                           .view(torch.int16)), (d, m)
        assert not o[:, real:].any()
