"""Mergeable sketch state for standing queries, in PyTorch.

The counterpart of ``repro.query.sketches``: fixed-shape ``NamedTuple``
states that ride along ``TreeState.qstate`` and fold in one root window
per call, with no read back to the host.

``QuantileSketch`` is the multi-level KLL compactor: ``L`` weighted
buffers of ``C`` slots (``kll_schedule``). A batch enters level 0; a
level whose live points overflow ``C`` compacts at randomized
equi-weight rank targets ``t_k = (k + u)·W/m`` and pushes ``m = C/2``
survivors up (the top level compacts in place to ``C``). The bound is
``2·√(Σ q²)/W`` over the compaction history. ``WindowedQuantileSketch``
is a ring of ``R`` per-window sub-sketches merged at query time.
``HeavyHitterSketch`` is a weighted count-min table plus a top-``k``
candidate set; ``hh_decayed_update`` decays the table by ``γ`` per
window.

How the reference's compiled program is reproduced bit for bit:

* **Randomness.** The reference draws each fold's offset ``u`` with
  ``jax.random.uniform(fold_in(key, h), ())``. Here every function
  takes those uniforms as a tensor ``u[h]`` (one per level), which the
  query compiler draws for a whole epoch up front
  (``CompiledQueryPlan.draws``), so nothing in the tick reads the
  device back.
* **Cumulative weights.** ``jnp.cumsum`` under ``jit`` is a blocked
  scan (``blocked_cumsum``), not a left-to-right sum; both cumulative
  sums of the quantile sketch use the same order here.
* **The overflow branch.** The reference's ``lax.cond(n_live <= cap,
  exact, compact)`` becomes a branch on the device: both the lossless
  pack and the compaction are computed at every level of every fold
  (so ``quantile_compact`` launches once per level), and ``torch.where``
  on ``n_live <= cap`` selects, with no host read.
* **Ties.** Argsorts are stable (``jnp.argsort`` is), and the top-``k``
  of ``_refresh_topk`` takes the lowest index first among equal scores,
  as ``jax.lax.top_k`` does (``topk_lowest_index``).
* **Contractions.** The decayed update ``γ·counts + delta`` is one FMA
  in the reference's compiled code (``sampling.fma``).

Two sums have no reproducible order and agree with the reference only
to rounding: ``QuantileSketch.total_weight`` and
``HeavyHitterSketch.total_weight`` (``torch.sum``). They feed only the
reported bounds.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.sampling import fma, sqrt_rn
from repro_torch.kernels.sketch_update import ops as sk_ops
from repro_torch.kernels.sketch_update.ref import hash_buckets

HH_EMPTY_KEY = 2**31 - 1   # sentinel: unoccupied top-k slot
_SCAN_BLOCK = 16
_F32 = torch.float32


# ------------------------------------------------------------- helpers --
def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along the last axis in the order of the
    reference's compiled ``jnp.cumsum``: XLA rewrites the scan into
    blocks of 16, each summed left to right; the block totals are scanned
    the same way, recursively, and each block's exclusive prefix is added
    to its sums. Built from elementwise adds, so it gives the same bits on
    the CPU and on a card."""
    n = x.shape[-1]
    b = _SCAN_BLOCK
    if n <= b:
        if n == 0:
            return x.clone()
        cols = [x[..., 0]]
        for j in range(1, n):
            cols.append(cols[-1] + x[..., j])
        return torch.stack(cols, dim=-1)
    nb = -(-n // b)
    blk = torch.nn.functional.pad(x, (0, nb * b - n)).reshape(
        x.shape[:-1] + (nb, b))
    cols = [blk[..., 0]]
    for j in range(1, b):
        cols.append(cols[-1] + blk[..., j])
    within = torch.stack(cols, dim=-1)
    totals = blocked_cumsum(within[..., -1])
    rest = within[..., 1:, :] + totals[..., :-1, None]
    out = torch.cat([within[..., :1, :], rest], dim=-2)
    return out.reshape(x.shape[:-1] + (nb * b,))[..., :n]


def topk_lowest_index(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values,
    equal values in ascending index order (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# --------------------------------------------------------------- quantile --
class QuantileSketch(NamedTuple):
    """``value``/``weight`` f32[L, C]: ``L`` level buffers of ``C`` slots
    (``kll_schedule``); weight 0 marks an empty slot. Each level's live
    slots are value-sorted and packed to the front. ``compactions`` f32[]
    counts lossy compactions; ``err_q2`` f32[] sums their squared weight
    quanta. A summary that never overflowed keeps a bound of exactly 0."""

    value: torch.Tensor
    weight: torch.Tensor
    compactions: torch.Tensor
    err_q2: torch.Tensor

    @property
    def levels(self) -> int:
        return self.value.shape[-2]

    @property
    def capacity(self) -> int:
        return self.value.shape[-1]

    @property
    def total_weight(self) -> torch.Tensor:
        return torch.sum(self.weight, dim=(-2, -1))

    @property
    def rank_error_bound(self) -> torch.Tensor:
        """The ±2σ rank-error bound ``2·√(Σ q²)/W`` as a fraction of the
        total weight; 0 for a lossless summary."""
        return torch.where(
            self.compactions > 0.0,
            2.0 * sqrt_rn(self.err_q2)
            / torch.clamp_min(self.total_weight, 1e-30),
            0.0)


def kll_schedule(capacity: int) -> tuple[int, ...]:
    """Per-level slot capacities of a ``capacity``-point sketch: uniform
    ``C`` slots per level, 1, 2 or 4 levels by capacity."""
    if capacity < 16:
        levels = 1
    elif capacity < 64:
        levels = 2
    else:
        levels = 4
    return (capacity,) * levels


def quantile_init(capacity: int, device=None) -> QuantileSketch:
    levels = len(kll_schedule(capacity))

    def z(shape):
        return torch.zeros(shape, dtype=_F32, device=device)

    return QuantileSketch(value=z((levels, capacity)),
                          weight=z((levels, capacity)),
                          compactions=z(()), err_q2=z(()))


def quantile_rank_error_bound(capacity: int, max_updates: int = 64) -> float:
    """Static planning bound: the worst ``2·√(Σq²)/W`` a ``capacity``
    sketch reaches over ``max_updates`` folds, over a grid of batch
    sizes from a quarter of to four times the capacity (host
    arithmetic, the reference's)."""
    ks = kll_schedule(capacity)
    top = len(ks) - 1
    worst = 0.0
    for batch in sorted({max(capacity // 4, 1), capacity, 4 * capacity}):
        n = [0.0] * len(ks)
        w = [0.0] * len(ks)
        var = 0.0
        for _ in range(int(max_updates)):
            cv, cw = float(batch), float(batch)
            for h, k in enumerate(ks):
                n[h] += cv
                w[h] += cw
                if n[h] <= k:
                    break
                m = k if h == top else k // 2
                q = w[h] / m
                var += q * q
                if h == top:
                    n[h] = float(k)   # in-place compact, no spill
                    break
                cv, cw = float(m), w[h]
                n[h] = 0.0
                w[h] = 0.0
        total = float(max_updates) * float(batch)
        worst = max(worst, 2.0 * math.sqrt(var) / total)
    return worst


def _fold_level(u: torch.Tensor, lvl_v, lvl_w, add_v, add_w, *, m_up: int):
    """Fold extra weighted points into one ``C``-slot level buffer.

    ``u`` is this fold's uniform offset (f32 scalar). Returns ``(value[C],
    weight[C], carry_v[m_up], carry_w[m_up], did_compact, q2)``. While
    the live points fit the fold is lossless (a stable pack of the
    value-sorted live slots) and the carry is empty; on overflow the
    compaction at ``(k + u)·W/m`` keeps ``m`` points of weight ``q =
    W/m``, pushed up as the carry (``m_up > 0``) or kept in place at the
    top level (``m_up == 0``). Both outcomes are computed and selected
    on the device."""
    cap = lvl_v.shape[-1]
    m = cap if m_up == 0 else m_up
    v = torch.cat([lvl_v, add_v])
    w = torch.cat([lvl_w, torch.clamp_min(add_w, 0.0)])
    order = torch.argsort(v, stable=True)
    v_s, w_s = v[order], w[order]
    cumw = blocked_cumsum(w_s)
    total = cumw[-1]
    live = w_s > 0.0
    fits = live.sum() <= cap

    # Lossless: live slots to the front, value order kept.
    pack = torch.argsort((~live).to(torch.int32), stable=True)[:cap]
    exact_v, exact_w = v_s[pack], w_s[pack]

    # Compaction at the randomized equi-weight rank targets.
    q = total / m
    t = (torch.arange(m, dtype=_F32, device=v.device) + u) * q
    cumw_prev = torch.cat([cumw.new_zeros(1), cumw[:-1]])
    picked = sk_ops.quantile_compact(v_s, cumw_prev, cumw, t)
    # f32 rounding can push the last target(s) to >= total; rank W is the
    # largest live value by definition.
    vmax = torch.where(live, v_s, -torch.inf).max()
    picked = torch.where(t >= total, vmax, picked)
    pw = q.expand(m)

    did = torch.where(fits, 0.0, 1.0)
    q2 = torch.where(fits, 0.0, q * q)
    if m_up == 0:
        return (torch.where(fits, exact_v, picked),
                torch.where(fits, exact_w, pw),
                v.new_zeros(0), v.new_zeros(0), did, q2)
    return (torch.where(fits, exact_v, 0.0), torch.where(fits, exact_w, 0.0),
            torch.where(fits, 0.0, picked), torch.where(fits, 0.0, pw),
            did, q2)


def _fold_all(u: torch.Tensor, sk: QuantileSketch, incoming
              ) -> QuantileSketch:
    """Cascade a per-level list of extra ``(value, weight)`` buffers (or
    ``None``) through the sketch, carrying each level's spill up. ``u``
    f32[≥ L]: one uniform per level."""
    levels, cap = sk.value.shape
    carry_v = sk.value.new_zeros(0)
    carry_w = sk.value.new_zeros(0)
    comp, err = sk.compactions, sk.err_q2
    rows_v, rows_w = [], []
    for h in range(levels):
        add_v, add_w = [carry_v], [carry_w]
        if incoming[h] is not None:
            add_v.append(incoming[h][0])
            add_w.append(incoming[h][1])
        m_up = 0 if h == levels - 1 else cap // 2
        nv, nw, carry_v, carry_w, did, q2 = _fold_level(
            u[h], sk.value[h], sk.weight[h], torch.cat(add_v),
            torch.cat(add_w), m_up=m_up)
        rows_v.append(nv)
        rows_w.append(nw)
        comp = comp + did
        err = err + q2
    return QuantileSketch(value=torch.stack(rows_v),
                          weight=torch.stack(rows_w), compactions=comp,
                          err_q2=err)


def quantile_update(u: torch.Tensor, sk: QuantileSketch,
                    values: torch.Tensor, weights: torch.Tensor
                    ) -> QuantileSketch:
    """Fold a weighted batch (weight 0 = excluded item) into the summary:
    the batch enters level 0 and overflow cascades up, one possible
    compaction per level."""
    incoming = [(values, weights)] + [None] * (sk.levels - 1)
    return _fold_all(u, sk, incoming)


def quantile_query(sk: QuantileSketch, qs: torch.Tensor) -> torch.Tensor:
    """f32[len(qs)] value estimates at quantiles ``qs`` (each in [0, 1])
    from the flattened ``[L·C]`` weighted point set."""
    flat_v = sk.value.reshape(-1)
    flat_w = sk.weight.reshape(-1)
    order = torch.argsort(flat_v, stable=True)
    v_s, w_s = flat_v[order], flat_w[order]
    cumw = blocked_cumsum(w_s)
    total = cumw[-1]
    t = torch.clamp(qs, 0.0, 1.0) * total
    # first live slot with cumw > t; q == 1.0 maps to the max live value
    n = flat_v.shape[0]
    idx = torch.searchsorted(cumw, t, right=True)
    vmax = torch.where(w_s > 0.0, v_s, -torch.inf).max()
    out = torch.where(idx < n, v_s[torch.clamp_max(idx, n - 1)], vmax)
    return torch.where(total > 0.0, out, 0.0)


def quantile_merge(u: torch.Tensor, a: QuantileSketch, b: QuantileSketch
                   ) -> QuantileSketch:
    """Merge two summaries into one with ``a``'s schedule: level-wise for
    the same schedule, ``b`` flattened into level 0 otherwise; both
    histories' compaction counts and squared quanta are added."""
    base = a._replace(compactions=a.compactions + b.compactions,
                      err_q2=a.err_q2 + b.err_q2)
    if b.value.shape == a.value.shape:
        incoming = [(b.value[h], b.weight[h]) for h in range(a.levels)]
    else:
        incoming = ([(b.value.reshape(-1), b.weight.reshape(-1))]
                    + [None] * (a.levels - 1))
    return _fold_all(u, base, incoming)


def _left_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the leading axis, left to right."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def quantile_merge_stacked(u: torch.Tensor, stacked: QuantileSketch
                           ) -> QuantileSketch:
    """Merge ``N`` stacked summaries (leaves ``[N, ...]``) in one
    level-wise pass: each level compacts at most once for the merge."""
    levels, cap = stacked.value.shape[-2:]
    base = QuantileSketch(
        value=stacked.value.new_zeros((levels, cap)),
        weight=stacked.value.new_zeros((levels, cap)),
        compactions=_left_sum(stacked.compactions.reshape(-1)),
        err_q2=_left_sum(stacked.err_q2.reshape(-1)))
    incoming = [(stacked.value[..., h, :].reshape(-1),
                 stacked.weight[..., h, :].reshape(-1))
                for h in range(levels)]
    return _fold_all(u, base, incoming)


# ------------------------------------------------- windowed quantiles --
class WindowedQuantileSketch(NamedTuple):
    """Ring of ``R`` per-window KLL sub-sketches: ``value``/``weight``
    f32[R, L, C], ``compactions``/``err_q2`` f32[R], ``head`` i32[] — the
    next slot to overwrite (it holds the oldest window)."""

    value: torch.Tensor
    weight: torch.Tensor
    compactions: torch.Tensor
    err_q2: torch.Tensor
    head: torch.Tensor

    @property
    def window(self) -> int:
        return self.value.shape[-3]

    @property
    def capacity(self) -> int:
        return self.value.shape[-1]


def windowed_quantile_init(capacity: int, window: int, device=None
                           ) -> WindowedQuantileSketch:
    levels = len(kll_schedule(capacity))
    r = int(window)

    def z(shape):
        return torch.zeros(shape, dtype=_F32, device=device)

    return WindowedQuantileSketch(
        value=z((r, levels, capacity)), weight=z((r, levels, capacity)),
        compactions=z((r,)), err_q2=z((r,)),
        head=torch.zeros((), dtype=torch.int32, device=device))


def windowed_quantile_update(u: torch.Tensor, sk: WindowedQuantileSketch,
                             values: torch.Tensor, weights: torch.Tensor
                             ) -> WindowedQuantileSketch:
    """Summarise one window's batch into a fresh sub-sketch at the head
    slot (the slot's previous window leaves the ring) and advance the
    head. The slot is selected on the device."""
    levels, cap = sk.value.shape[-2:]
    z = sk.value.new_zeros
    sub = quantile_update(u, QuantileSketch(z((levels, cap)),
                                            z((levels, cap)), z(()), z(())),
                          values, weights)
    at = torch.arange(sk.window, device=sk.head.device) == sk.head
    return WindowedQuantileSketch(
        value=torch.where(at[:, None, None], sub.value, sk.value),
        weight=torch.where(at[:, None, None], sub.weight, sk.weight),
        compactions=torch.where(at, sub.compactions, sk.compactions),
        err_q2=torch.where(at, sub.err_q2, sk.err_q2),
        head=(sk.head + 1) % sk.window)


def windowed_quantile_merged(u: torch.Tensor, sk: WindowedQuantileSketch
                             ) -> QuantileSketch:
    """The ring merged into one query-time summary
    (``quantile_merge_stacked`` over the ``[R, ...]`` sub-sketches)."""
    stacked = QuantileSketch(value=sk.value, weight=sk.weight,
                             compactions=sk.compactions, err_q2=sk.err_q2)
    return quantile_merge_stacked(u, stacked)


# ---------------------------------------------------------- heavy hitters --
class HeavyHitterSketch(NamedTuple):
    """``counts`` f32[depth, width] weighted count-min table; ``key``
    i32[k] / ``est`` f32[k] the tracked top-k candidates
    (``HH_EMPTY_KEY`` marks an unoccupied slot)."""

    counts: torch.Tensor
    key: torch.Tensor
    est: torch.Tensor

    @property
    def depth(self) -> int:
        return self.counts.shape[-2]

    @property
    def width(self) -> int:
        return self.counts.shape[-1]

    @property
    def total_weight(self) -> torch.Tensor:
        return torch.sum(self.counts[..., 0, :], dim=-1)


def hh_init(k: int, width: int, depth: int, device=None) -> HeavyHitterSketch:
    return HeavyHitterSketch(
        counts=torch.zeros((depth, width), dtype=_F32, device=device),
        key=torch.full((k,), HH_EMPTY_KEY, dtype=torch.int32, device=device),
        est=torch.zeros((k,), dtype=_F32, device=device))


def hh_error_bound(width: int, total_weight: torch.Tensor) -> torch.Tensor:
    """CM over-count bound: est − true ≤ (2/width)·W w.h.p."""
    return (2.0 / float(width)) * total_weight


def hh_point_estimate(counts: torch.Tensor, keys: torch.Tensor
                      ) -> torch.Tensor:
    """f32[M] count-min estimates (min over the depth rows) of ``keys``
    against the table ``counts`` f32[depth, width]."""
    depth, width = counts.shape
    buckets = hash_buckets(keys, depth, width)
    return torch.gather(counts, 1, buckets).min(dim=0).values


def _refresh_topk(counts: torch.Tensor, cand_key: torch.Tensor,
                  k_slots: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-estimate a candidate-key pool against a CM table and keep the
    best ``k_slots``: dedupe by a stable sort of the keys, then top-k by
    estimate with the lowest sorted position first among ties."""
    empty = cand_key == HH_EMPTY_KEY
    cand_est = torch.where(empty, -1.0, hh_point_estimate(counts, cand_key))
    order = torch.argsort(cand_key, stable=True)
    ks, es = cand_key[order], cand_est[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=ks.device),
                       ks[1:] != ks[:-1]])
    score = torch.where(first & (ks != HH_EMPTY_KEY), es, -1.0)
    top_est, top_ix = topk_lowest_index(score, k_slots)
    occupied = top_est >= 0.0
    return (torch.where(occupied, ks[top_ix], HH_EMPTY_KEY),
            torch.clamp_min(top_est, 0.0))


def _candidates(sk: HeavyHitterSketch, keys, w) -> torch.Tensor:
    return torch.cat([sk.key, torch.where(w > 0.0, keys.to(torch.int32),
                                          HH_EMPTY_KEY)])


def hh_update(sk: HeavyHitterSketch, keys: torch.Tensor,
              weights: torch.Tensor) -> HeavyHitterSketch:
    """Fold a weighted key batch in (one ``cms_update`` launch) and
    refresh the top-k candidate set."""
    w = torch.clamp_min(weights, 0.0)
    delta = sk_ops.cms_update(keys.to(torch.int32), w, sk.depth, sk.width)
    counts = sk.counts + delta
    key_out, est_out = _refresh_topk(counts, _candidates(sk, keys, w),
                                     sk.key.shape[0])
    return HeavyHitterSketch(counts=counts, key=key_out, est=est_out)


def hh_decayed_update(sk: HeavyHitterSketch, keys: torch.Tensor,
                      weights: torch.Tensor, decay: float
                      ) -> HeavyHitterSketch:
    """``counts ← decay·counts + batch`` (one FMA, as the reference's
    compiled code computes it), then refresh the top-k against the
    decayed counts."""
    w = torch.clamp_min(weights, 0.0)
    delta = sk_ops.cms_update(keys.to(torch.int32), w, sk.depth, sk.width)
    gamma = torch.tensor(decay, dtype=_F32, device=sk.counts.device)
    counts = fma(gamma, sk.counts, delta)
    key_out, est_out = _refresh_topk(counts, _candidates(sk, keys, w),
                                     sk.key.shape[0])
    return HeavyHitterSketch(counts=counts, key=key_out, est=est_out)


def hh_merge(a: HeavyHitterSketch, b: HeavyHitterSketch) -> HeavyHitterSketch:
    """Merge two sketches: the CM tables add, and the top-k re-merges as a
    candidate refresh over both key sets against the merged counts."""
    counts = a.counts + b.counts
    cand_key = torch.cat([a.key, b.key])
    key_out, est_out = _refresh_topk(counts, cand_key, a.key.shape[0])
    return HeavyHitterSketch(counts=counts, key=key_out, est=est_out)


def hh_merge_stacked(stacked: HeavyHitterSketch) -> HeavyHitterSketch:
    """Merge ``N`` stacked sketches (leaves ``[N, ...]``) with one
    candidate refresh; the tables are added left to right."""
    counts = _left_sum(stacked.counts)
    cand_key = stacked.key.reshape(-1)
    key_out, est_out = _refresh_topk(counts, cand_key,
                                     stacked.key.shape[-1])
    return HeavyHitterSketch(counts=counts, key=key_out, est=est_out)


def hh_item_key(values: torch.Tensor) -> torch.Tensor:
    """Default item→key map for value streams: round half to even to the
    nearest integer, as i32."""
    return torch.round(values).to(torch.int32)
