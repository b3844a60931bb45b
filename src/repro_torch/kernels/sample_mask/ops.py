"""Threshold selection for the ``pallas`` sampler backend.

Stage 1, ``thresholds_from_reservoirs``, is plain PyTorch (the
reference's is an XLA lexsort, not a kernel): τ_i is the ``N_i``-th
largest valid priority of stratum ``i``, so ``keep = u ≥ τ`` keeps each
stratum's top ``N_i`` and every item tied with the last of them.

Stage 2, ``sample_mask``: on a CUDA tensor the wrapper launches
``csrc/sample_mask.cu``; on a CPU tensor it calls the plain version in
``ref.py``. Any other case raises: there is no fallback from the card to
the plain version. Both give the same bits (one compare and one select
per item).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.sample_mask import ref

# τ and W are staged in shared memory: 2·X floats, under 48 KB.
MAX_STRATA = 6144


def _lib():
    lib = _build.load("sample_mask")
    fn = lib.sample_mask_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, P, P, P]
        fn.restype = I
    return lib


def thresholds_from_reservoirs(priorities: torch.Tensor,
                               strata: torch.Tensor, valid: torch.Tensor,
                               reservoirs: torch.Tensor,
                               num_strata: int) -> torch.Tensor:
    """f32[X] τ: the ``N_i``-th largest valid priority of stratum ``i``,
    with finite sentinels: −1.0 where ``c_i ≤ N_i`` (keep every valid
    item) and +2.0 where ``N_i ≤ 0`` (keep none)."""
    m = priorities.shape[0]
    dev = priorities.device
    seg = torch.where(valid, strata, num_strata).to(torch.int64)
    # Lexicographic (stratum ascending, priority descending), stable: the
    # reference's ``jnp.lexsort`` as two stable sorts, minor key first.
    o1 = torch.argsort(torch.where(valid, -priorities, 0.5), stable=True)
    order = o1[torch.argsort(seg[o1], stable=True)]
    in_range = (seg >= 0) & (seg < num_strata + 2)
    counts = torch.zeros(num_strata + 2, dtype=torch.int64, device=dev)
    counts.index_add_(0, seg[in_range], torch.ones_like(seg[in_range]))
    starts = torch.cumsum(counts, 0) - counts
    n_int = reservoirs.to(torch.int32).to(torch.int64)
    c_int = counts[:num_strata]
    hi = torch.clamp_min(c_int - 1, 0)
    idx = starts[:num_strata] + torch.minimum(
        torch.clamp_min(n_int - 1, 0), hi)
    tau = priorities[order][idx.clamp(0, max(m - 1, 0))]
    return torch.where(n_int <= 0, 2.0,
                       torch.where(c_int > n_int, tau, -1.0))


def sample_mask(priorities: torch.Tensor, strata: torch.Tensor,
                valid: torch.Tensor, tau: torch.Tensor,
                weights: torch.Tensor):
    """``(keep bool[M], w f32[M])``: ``keep = valid ∧ u ≥ τ[s]`` and
    ``w = keep ? W[s] : 0`` (``s`` indexed as ``ref.sample_mask`` does)."""
    if priorities.device.type == "cpu":
        return ref.sample_mask(priorities, strata, valid, tau, weights)
    if priorities.device.type != "cuda":
        raise ValueError(f"sample_mask: unsupported device "
                         f"{priorities.device}")
    m, x = priorities.shape[0], tau.shape[0]
    dtypes = {"priorities": torch.float32, "strata": torch.int32,
              "valid": torch.bool, "tau": torch.float32,
              "weights": torch.float32}
    shapes = {"priorities": (m,), "strata": (m,), "valid": (m,),
              "tau": (x,), "weights": (x,)}
    args = {"priorities": priorities, "strata": strata, "valid": valid,
            "tau": tau, "weights": weights}
    for name, t in args.items():
        if t.device != priorities.device:
            raise ValueError(f"sample_mask: {name} is on {t.device}, "
                             f"expected {priorities.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"sample_mask: {name} has shape "
                             f"{tuple(t.shape)}, expected {shapes[name]}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"sample_mask: {name} must be {dtypes[name]}, "
                            f"got {t.dtype}")
    if not 1 <= x <= MAX_STRATA:
        raise ValueError(f"sample_mask: needs 1 to {MAX_STRATA} strata, "
                         f"got {x}")
    keep = torch.empty((m,), dtype=torch.bool, device=priorities.device)
    w = torch.empty((m,), dtype=torch.float32, device=priorities.device)
    if m == 0:
        return keep, w
    u, s, v, t, wt = (a.contiguous() for a in
                      (priorities, strata, valid, tau, weights))
    lib = _lib()
    P = _build.ptr
    rc = lib.sample_mask_launch(P(u), P(s), P(v), P(t), P(wt), m, x, P(keep),
                                P(w), _build.stream_of(u))
    _build.check(lib, rc, "sample_mask")
    LAUNCHES["sample_mask"] += 1
    return keep, w
