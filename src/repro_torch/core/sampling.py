"""Stratified reservoir sampling as priority sampling (Alg. 2, line 10).

The counterpart of ``repro.core.sampling``. Per-stratum reservoir
sampling keeps a uniform random subset of size ``min(c_i, N_i)``; the
parallel equivalent draws an i.i.d. priority per item and keeps each
stratum's top-``N_i`` items by priority, ties broken by buffer position
(the stable-lexsort law). Three backends realise that law and return
identical masks for identical priorities; ``pallas`` differs only on
exact f32 ties at a threshold, which it keeps all:

* ``argsort``      — one stable lexsort over (stratum, −priority).
* ``topk``         — exact per-stratum thresholds from a dense
  ``torch.topk``, with position-ordered tie resolution.
* ``pallas``       — the reference's two-kernel backend: thresholds,
  then the ``sample_mask`` kernel (keeps every item tied at τ) and
  ``stratified_stats`` for the counts.
* ``pallas_fused`` — the reference's name for the fused selection
  kernel; here it runs ``kernels.fused_level_tick`` (a CUDA kernel on a
  card, its plain version on the CPU) and ``kernels.stratified_stats``
  for the counts.

Every function takes any number of leading batch dimensions (the
reference's ``vmap`` over nodes is a batch dimension here); ``pallas``
takes one flat problem, which the level engine flattens into. Sums that
feed a bitwise result are integer-valued (counts, headroom, which are
exact in any order), taken left to right (``seq_sum``), the order the
reference's compiled reductions use, or per-segment in item order
(``segment_sum``), the order of the reference's scatter.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

from repro_torch.core import prng
# Float sums per segment in item order on every device (the card's kernel
# adds in the reference scatter's order), for the core modules.
from repro_torch.kernels.segment_sum.ops import segment_sum


# --------------------------------------------------------------------------
# Small exact helpers.
# --------------------------------------------------------------------------
def segment_count(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Items per segment along the last axis as f32 ``[..., S]`` (ids
    outside ``[0, S)`` dropped): an integer sum, exact on every device."""
    ones = torch.ones(seg.shape, dtype=torch.int32, device=seg.device)
    return segment_sum(ones, seg, num_segments).float()


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum over the last axis, keepdim — the order of the
    reference's compiled reductions over a stratum vector."""
    acc = x[..., :1]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i:i + 1]
    return acc


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` rounded once to f32, as the reference's compiled code
    contracts it. The product of two f32 values is exact in f64, so the
    only rounding before the f32 one is the f64 sum's."""
    return (a.double() * b.double() + c.double()).float()


def fma_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Σ a_i·b_i`` over the last axis, left to right, each step one
    FMA — how the reference's compiled reductions of a product run."""
    acc = torch.zeros_like(a[..., 0])
    for i in range(a.shape[-1]):
        acc = fma(a[..., i], b[..., i], acc)
    return acc


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, on every device. ``torch.sqrt``
    of f32 on the CPU is not (about 0.6% of inputs come out 1 ulp off);
    the reference's compiled ``sqrt`` and CUDA's ``sqrtf`` are. The f64
    root of an f32 value rounds to the correctly rounded f32 root."""
    return torch.sqrt(x.double()).float()


def gather_last(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[..., index]`` per row with out-of-range ids clamped, as the
    reference's gathers clamp. ``table`` is ``[..., K]``, ``index``
    ``[..., M]`` with the same leading dimensions."""
    ix = index.to(torch.int64).clamp(0, table.shape[-1] - 1)
    return torch.gather(table, -1, ix)


def stratum_counts(stratum: torch.Tensor, valid: torch.Tensor,
                   num_strata: int) -> torch.Tensor:
    """``c_i``: valid items per stratum. f32[..., X]."""
    return segment_count(torch.where(valid, stratum, num_strata), num_strata)


def stratum_stds(values: torch.Tensor, stratum: torch.Tensor,
                 valid: torch.Tensor, num_strata: int) -> torch.Tensor:
    """Per-stratum value standard deviation over valid items. f32[..., X].
    Feeds the ``neyman`` allocation; empty strata report 0."""
    seg = torch.where(valid, stratum, num_strata)
    v = torch.where(valid, values.float(), 0.0)
    c = segment_count(seg, num_strata)
    s1 = segment_sum(v, seg, num_strata)
    s2 = segment_sum(v * v, seg, num_strata)
    safe = torch.clamp_min(c, 1.0)
    mean = s1 / safe
    var = torch.clamp_min(fma(-mean, mean, s2 / safe), 0.0)
    return sqrt_rn(var)


def _exclusive_prefix(x: torch.Tensor) -> torch.Tensor:
    """``Σ_{j<i} x_j`` along the last axis. Only applied to integer-valued
    f32 vectors (counts, headroom), which sum exactly in any order."""
    return torch.cumsum(x, -1) - x


def _settle(alloc, counts, active, budget):
    """Exact-conservation top-up: the unspent part of ``budget`` goes to
    the lowest-indexed strata with headroom, so ``Σ alloc == budget``."""
    alloc = torch.where(active, torch.minimum(alloc, counts), 0.0)
    head = torch.where(active, counts - alloc, 0.0)
    leftover = budget - alloc.sum(-1, keepdim=True)
    give = torch.minimum(
        torch.clamp_min(leftover - _exclusive_prefix(head), 0.0), head)
    return alloc + give


def allocate_reservoirs(sample_size, counts: torch.Tensor, *,
                        policy: str = "fair", water_fill_iters: int = 4,
                        stds: torch.Tensor | None = None) -> torch.Tensor:
    """``getSampleSize`` (Alg. 2 line 7): split the interval budget across
    strata. f32[..., X]; ``sample_size`` is a scalar or broadcasts
    against the leading dimensions of ``counts``.

    Every policy conserves the budget exactly, ``Σ alloc == min(size,
    Σ c)``, with ``alloc_i ≤ c_i``. ``fair`` gives equal shares to the
    active strata and water-fills what small strata leave; ``proportional``
    splits ∝ ``c_i`` with largest-remainder rounding; ``neyman`` splits ∝
    ``c_i·σ_i`` (needs ``stds``). The last two reserve one row per
    non-empty stratum first, so no stratum is dropped without weight.
    """
    counts = counts.float()
    active = counts > 0
    n_active = torch.clamp_min(active.float().sum(-1, keepdim=True), 1.0)
    size = torch.as_tensor(sample_size, dtype=torch.float32,
                           device=counts.device)
    if size.dim() > 0 and size.shape[-1:] != (1,):
        size = size[..., None]
    budget = torch.minimum(size, counts.sum(-1, keepdim=True))

    if policy in ("proportional", "neyman"):
        one = torch.clamp_max(counts, 1.0)
        reserve = torch.minimum(
            torch.clamp_min(budget - _exclusive_prefix(one), 0.0), one)
        rem_budget = budget - reserve.sum(-1, keepdim=True)
        rem_counts = counts - reserve

    if policy == "proportional":
        total = torch.clamp_min(rem_counts.sum(-1, keepdim=True), 1.0)
        quota = rem_budget * rem_counts / total
        base = torch.floor(quota)
        frac = torch.where(rem_counts > 0, quota - base, -1.0)
        n_extra = torch.round(rem_budget - base.sum(-1, keepdim=True))
        # Largest-remainder rank: |{j : frac_j > frac_i, ties to lower j}|.
        ix = torch.arange(counts.shape[-1], device=counts.device)
        fr_j, fr_i = frac[..., None, :], frac[..., :, None]
        ahead = (fr_j > fr_i) | ((fr_j == fr_i) & (ix[None, :] < ix[:, None]))
        rank = ahead.float().sum(-1)
        alloc = reserve + base + torch.where(
            (rem_counts > 0) & (rank < n_extra), 1.0, 0.0)
        return _settle(alloc, counts, active, budget)

    if policy == "neyman":
        if stds is None:
            raise ValueError("neyman allocation requires per-stratum stds")
        sigma = torch.clamp_min(stds.float(), 1e-6)
        score = torch.where(active, counts * sigma, 0.0)
        s_tot0 = torch.clamp_min(seq_sum(score), 1e-30)
        alloc = torch.minimum(
            reserve + torch.floor(rem_budget * score / s_tot0), counts)
        for _ in range(water_fill_iters):
            # Strata at capacity drop out; the unspent budget is re-split
            # ∝ c·σ among the rest.
            uncapped = active & (alloc < counts)
            s = torch.where(uncapped, score, 0.0)
            s_tot = torch.clamp_min(seq_sum(s), 1e-30)
            spare = budget - alloc.sum(-1, keepdim=True)
            alloc = torch.minimum(alloc + torch.floor(spare * s / s_tot),
                                  counts)
        return _settle(alloc, counts, active, budget)

    if policy != "fair":
        raise ValueError(f"unknown allocation policy: {policy}")

    alloc = torch.where(active, torch.floor(budget / n_active), 0.0)
    for _ in range(water_fill_iters):
        # Strata smaller than their cap release the surplus; it is re-split
        # among the still-capped strata.
        used = torch.minimum(alloc, counts)
        surplus = (alloc - used).sum(-1, keepdim=True)
        capped = active & (counts > alloc)
        n_capped = torch.clamp_min(capped.float().sum(-1, keepdim=True), 1.0)
        bump = torch.where(capped, torch.floor(surplus / n_capped), 0.0)
        alloc = torch.where(active, used + bump, 0.0)
    return _settle(alloc, counts, active, budget)


def stratified_priority_sample(key, stratum: torch.Tensor,
                               valid: torch.Tensor, reservoirs: torch.Tensor,
                               num_strata: int,
                               priorities: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Keep each stratum's top-``N_i`` items by priority (ties to the
    earlier position). bool[..., M]; one stable lexsort over
    (stratum, −priority) with invalid items in a sentinel stratum."""
    m = stratum.shape[-1]
    if priorities is None:
        priorities = prng.uniform(key, (m,))
    seg = torch.where(valid, stratum, num_strata).to(torch.int64)
    minor = torch.where(valid, -priorities, 0.5)
    o1 = torch.argsort(minor, dim=-1, stable=True)
    o2 = torch.argsort(torch.gather(seg, -1, o1), dim=-1, stable=True)
    order = torch.gather(o1, -1, o2)
    seg_sorted = torch.gather(seg, -1, order)
    counts_ext = segment_sum(torch.ones_like(seg, dtype=torch.int64), seg,
                             num_strata + 2)
    starts = torch.cumsum(counts_ext, -1) - counts_ext
    rank = (torch.arange(m, device=seg.device)
            - torch.gather(starts, -1, seg_sorted))
    res_ext = torch.cat([reservoirs.to(torch.int64),
                         reservoirs.new_zeros(reservoirs.shape[:-1] + (2,),
                                              dtype=torch.int64)], -1)
    keep_sorted = rank < torch.gather(res_ext, -1, seg_sorted)
    keep = torch.zeros_like(valid).scatter(-1, order, keep_sorted)
    return keep & valid


# --------------------------------------------------------------------------
# Pluggable sampler backends.
# --------------------------------------------------------------------------
@runtime_checkable
class SamplerBackend(Protocol):
    """The two operations WHSamp needs from a selection engine: exact
    per-stratum counts, and the per-stratum top-``N_i`` keep mask. Given
    identical priorities every backend returns identical masks."""

    name: str

    def counts(self, stratum, valid, num_strata): ...

    def select(self, key, stratum, valid, reservoirs, num_strata, *,
               priorities=None, max_reservoir=None, batch_hint=1): ...


class ArgsortBackend:
    """Reference backend: one stable lexsort and a rank test."""

    name = "argsort"

    def counts(self, stratum, valid, num_strata):
        return stratum_counts(stratum, valid, num_strata)

    def select(self, key, stratum, valid, reservoirs, num_strata, *,
               priorities=None, max_reservoir=None, batch_hint=1):
        return stratified_priority_sample(key, stratum, valid, reservoirs,
                                          num_strata, priorities=priorities)


class TopKBackend:
    """Threshold backend: τ_i from a dense per-stratum ``torch.topk``.

    Items with ``u > τ`` are kept; items with ``u == τ`` are kept in
    position order until the reservoir is full — the stable-lexsort law,
    so masks equal ``argsort``'s. The dense ``[X, M]`` matrix per batch
    row falls back to ``argsort`` beyond ``_DENSE_LIMIT`` elements or
    without a static ``max_reservoir``.
    """

    name = "topk"
    _DENSE_LIMIT = 1 << 22

    def counts(self, stratum, valid, num_strata):
        return stratum_counts(stratum, valid, num_strata)

    def select(self, key, stratum, valid, reservoirs, num_strata, *,
               priorities=None, max_reservoir=None, batch_hint=1):
        m = stratum.shape[-1]
        if priorities is None:
            priorities = prng.uniform(key, (m,))
        if (max_reservoir is None
                or max(int(batch_hint), 1) * num_strata * m
                > self._DENSE_LIMIT):
            return stratified_priority_sample(
                key, stratum, valid, reservoirs, num_strata,
                priorities=priorities)
        k = int(min(m, max(int(max_reservoir), 1)))
        p_eff = torch.where(valid, priorities, -1.0)
        rows = torch.arange(num_strata, device=stratum.device)[:, None]
        onrow = stratum[..., None, :] == rows                    # [..., X, M]
        dense = torch.where(onrow, p_eff[..., None, :], -1.0)
        topv = torch.topk(dense, k, dim=-1).values               # desc
        n_int = reservoirs.to(torch.int64)
        tau = torch.gather(topv, -1, (n_int - 1).clamp(0, k - 1)[..., None])
        # N_i ≤ 0 keeps nothing; τ == −1 (stratum below its reservoir)
        # keeps every valid item.
        tau = torch.where(n_int <= 0, 2.0, tau[..., 0])
        seg_tau = gather_last(tau, stratum)
        strict = valid & (priorities > seg_tau)
        m_strict = (onrow & strict[..., None, :]).sum(-1)
        slack = n_int - m_strict
        tie = valid & (priorities == seg_tau)
        tie_rank = torch.cumsum(onrow & tie[..., None, :], -1)
        ix = stratum.to(torch.int64).clamp(0, num_strata - 1)[..., None, :]
        rank_at = torch.gather(tie_rank, -2, ix)[..., 0, :]
        return strict | (tie & (rank_at <= gather_last(slack, stratum)))


class PallasBackend:
    """The reference's two-kernel backend, on Hopper: ``counts`` is the
    count column of ``kernels.stratified_stats``; ``select`` finds each
    stratum's threshold τ_i (the ``N_i``-th largest valid priority, plain
    PyTorch) and keeps ``u ≥ τ`` with the ``sample_mask`` kernel. Every
    item tied at τ is kept, so on exact f32 priority ties this backend
    may keep more than ``N_i`` (the reference's law for it, unlike
    ``argsort``'s). ``flatten_for_level``: a level runs as one
    composite-stratum problem (stratum' = node·X + stratum), one kernel
    pass over the level's items."""

    name = "pallas"
    flatten_for_level = True

    def counts(self, stratum, valid, num_strata):
        from repro_torch.kernels.stratified_stats import ops as ss_ops

        stats = ss_ops.stratified_stats(
            torch.zeros(stratum.shape, dtype=torch.float32,
                        device=stratum.device),
            stratum, valid, num_strata)
        return stats[:, 0]

    def select(self, key, stratum, valid, reservoirs, num_strata, *,
               priorities=None, max_reservoir=None, batch_hint=1):
        from repro_torch.kernels.sample_mask import ops as sm_ops

        if priorities is None:
            priorities = prng.uniform(key, (stratum.shape[0],))
        tau = sm_ops.thresholds_from_reservoirs(
            priorities, stratum, valid, reservoirs, num_strata)
        keep, _ = sm_ops.sample_mask(
            priorities, stratum, valid, tau,
            torch.ones((num_strata,), dtype=torch.float32,
                       device=stratum.device))
        return keep


class PallasFusedBackend:
    """The reference's single-kernel backend, on Hopper: ``counts`` is the
    count column of ``kernels.stratified_stats`` and ``select`` the
    ``fused_select`` kernel (τ by bisection on the priority bits, the
    tie law above, and the saturation law in-kernel). Through
    ``whs.level_tick`` whole level ticks run as one ``fused_level_tick``
    launch. The reference switches to ``argsort`` beyond ``1 << 22``
    one-hot elements, a cap on its kernel's dense ``[X, M]`` working set;
    ``fused_select`` has no such matrix and takes any ``M``, so the port
    always calls it (on the CPU its plain version is the argsort path)."""

    name = "pallas_fused"
    flatten_for_level = True
    fused_level_tick = True

    def counts(self, stratum, valid, num_strata):
        from repro_torch.kernels.stratified_stats import ops as ss_ops

        stats = ss_ops.stratified_stats(
            torch.zeros(stratum.shape, dtype=torch.float32,
                        device=stratum.device),
            stratum, valid, num_strata)
        return stats[:, 0]

    def select(self, key, stratum, valid, reservoirs, num_strata, *,
               priorities=None, max_reservoir=None, batch_hint=1):
        from repro_torch.kernels.fused_level_tick import ops as ft_ops

        m = stratum.shape[-1]
        if priorities is None:
            priorities = prng.uniform(key, (m,))
        return ft_ops.fused_select(priorities, stratum, valid, reservoirs,
                                   num_strata)


_BACKENDS: dict[str, SamplerBackend] = {
    b.name: b for b in (ArgsortBackend(), TopKBackend(), PallasBackend(),
                        PallasFusedBackend())
}

DEFAULT_BACKEND = "argsort"


def get_backend(backend: str | SamplerBackend) -> SamplerBackend:
    """Resolve a backend by name (or pass an instance through)."""
    if not isinstance(backend, str):
        return backend
    try:
        return _BACKENDS[backend]
    except KeyError:
        raise ValueError(f"unknown sampler backend {backend!r}; "
                         f"registered: {sorted(_BACKENDS)}") from None
