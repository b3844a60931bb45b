"""Weighted Hierarchical Sampling — Alg. 2 with the §III-C fix (Eq. 9).

The counterpart of ``repro.core.whs``. One ``whsamp`` call is one node ×
one interval; ``level_tick`` runs a whole stacked level. The
reference's saturation ``lax.cond``s are ``torch.where`` here: both
branches are computed and the saturated one is picked on the device, so
no call in this module reads a value back to the host.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng, sampling
from repro_torch.core.types import IntervalBatch, SampleResult, StratumMeta


def _whs_meta(c, reservoirs, w_in, c_in, async_calibration):
    """Alg. 2 lines 12–20 weight/count update, elementwise over any
    leading shape:

        w_i     = c_i / N_i                 if c_i > N_i else 1
        W_i^out = W_i^in · w_i · C_i^in / c_i         (Eq. 9)
        C_i^out = Y_i = min(c_i, N_i)

    A stratum absent this interval keeps its previous ``W``/``C``.
    """
    y = torch.minimum(c, torch.clamp_min(reservoirs, 0.0))
    safe_n = torch.clamp_min(reservoirs, 1.0)
    w_local = torch.where(c > reservoirs, c / safe_n, 1.0)
    if async_calibration:
        # C^in == 0 marks a source stream (no downstream node): factor 1.
        calib = torch.where((c_in > 0.0) & (c > 0.0),
                            c_in / torch.clamp_min(c, 1.0), 1.0)
        w_out = w_in * w_local * calib
    else:
        w_out = w_in * w_local
    w_out = torch.where(c > 0.0, w_out, w_in)
    c_out = torch.where(c > 0.0, y, c_in)
    return y, StratumMeta(weight=w_out, count=c_out)


def whsamp(key, batch: IntervalBatch, sample_size, num_strata: int, *,
           allocation: str = "fair", async_calibration: bool = True,
           backend=sampling.DEFAULT_BACKEND, max_reservoir: int | None = None,
           priorities: torch.Tensor | None = None) -> SampleResult:
    """WHSamp over one interval batch (Alg. 2). ``priorities`` may be
    passed in when the caller drew them already (the scan engine draws
    a whole epoch's at once); otherwise they are ``uniform(key)``."""
    be = sampling.get_backend(backend)
    c = be.counts(batch.stratum, batch.valid, num_strata)
    stds = None
    if allocation == "neyman":
        stds = sampling.stratum_stds(batch.value, batch.stratum, batch.valid,
                                     num_strata)
    reservoirs = sampling.allocate_reservoirs(sample_size, c,
                                              policy=allocation, stds=stds)
    if priorities is None:
        priorities = prng.uniform(key, (batch.capacity,))
    selected = be.select(key, batch.stratum, batch.valid, reservoirs,
                         num_strata, priorities=priorities,
                         max_reservoir=max_reservoir)
    # Saturation: N_i ≥ c_i everywhere makes every backend's mask exactly
    # ``valid``; picking it on the device keeps the reference's bits.
    selected = torch.where(torch.all(reservoirs >= c), batch.valid, selected)
    y, meta = _whs_meta(c, reservoirs, batch.meta.weight, batch.meta.count,
                        async_calibration)
    return SampleResult(selected=selected, meta=meta, c=c, y=y,
                        reservoir=reservoirs)


def level_whsamp(keys, values, strata, valid, w_in, c_in, sample_size,
                 num_strata: int, *, allocation: str = "fair",
                 async_calibration: bool = True,
                 backend=sampling.DEFAULT_BACKEND,
                 max_reservoir: int | None = None,
                 priorities: torch.Tensor | None = None) -> SampleResult:
    """WHSamp over a stacked level: ``[n, cap]`` buffers, ``[n, X]``
    metadata, one key per node (``[n, 2]``). Bit-identical to ``whsamp``
    per node with the same keys."""
    n_nodes, cap = values.shape
    be = sampling.get_backend(backend)
    node_ix = torch.arange(n_nodes, dtype=torch.int32,
                           device=values.device)[:, None]
    comp = (node_ix * num_strata + strata).reshape(-1)
    flat_valid = valid.reshape(-1)
    c = be.counts(comp, flat_valid, n_nodes * num_strata)
    c = c.reshape(n_nodes, num_strata)
    stds = None
    if allocation == "neyman":
        stds = sampling.stratum_stds(values, strata, valid, num_strata)
    reservoirs = sampling.allocate_reservoirs(sample_size, c,
                                              policy=allocation, stds=stds)
    if priorities is None:
        priorities = prng.uniform(keys, (cap,))
    if getattr(be, "flatten_for_level", False):
        key0 = None if keys is None else keys[0]
        selected = be.select(
            key0, comp, flat_valid, reservoirs.reshape(-1),
            n_nodes * num_strata, priorities=priorities.reshape(-1),
            max_reservoir=max_reservoir).reshape(n_nodes, cap)
    else:
        selected = be.select(keys, strata, valid, reservoirs, num_strata,
                             priorities=priorities,
                             max_reservoir=max_reservoir,
                             batch_hint=n_nodes)
    selected = torch.where(torch.all(reservoirs >= c), valid, selected)
    y, meta = _whs_meta(c, reservoirs, w_in, c_in, async_calibration)
    return SampleResult(selected=selected, meta=meta, c=c, y=y,
                        reservoir=reservoirs)


def pack_rows(values, strata, keep, out_capacity: int):
    """Row-wise compaction: each row's kept items packed to the front in
    buffer order, overflow dropped, zeros after. ``[n, cap]`` →
    ``[n, out_capacity]`` buffers plus the per-row kept count (not
    clipped to ``out_capacity``)."""
    n = values.shape[0]
    dest = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    row = torch.arange(n, dtype=torch.int64, device=values.device)[:, None]
    ok = keep & (dest < out_capacity)
    # Dropped items land in one spare slot past the end, then cut off.
    idx = torch.where(ok, row * out_capacity + dest, n * out_capacity)
    idx = idx.reshape(-1).to(torch.int64)
    values_c = values.new_zeros(n * out_capacity + 1)
    strata_c = strata.new_zeros(n * out_capacity + 1)
    values_c.scatter_(0, idx, values.reshape(-1))
    strata_c.scatter_(0, idx, strata.reshape(-1))
    return (values_c[:-1].reshape(n, out_capacity),
            strata_c[:-1].reshape(n, out_capacity),
            keep.sum(dim=1, dtype=torch.int32))


def _truncation_corrected_meta(slot_valid, result_y, meta: StratumMeta, seg,
                               num_segments: int) -> StratumMeta:
    """Re-derive (W^out, C^out) from what fits in the out buffer: a no-op
    when every selected item fits (``Y/Y == 1``); otherwise the extra
    thinning is folded into the weights (``W·Y/kept``) and ``C^out`` is
    the kept count."""
    kept = sampling.segment_count(
        torch.where(slot_valid, seg, num_segments).reshape(-1),
        num_segments).reshape(meta.weight.shape)
    factor = torch.where(kept > 0.0, result_y / torch.clamp_min(kept, 1.0),
                         1.0)
    return StratumMeta(weight=meta.weight * factor,
                       count=torch.where(kept > 0.0, kept, meta.count))


def apply_sample(batch: IntervalBatch, result: SampleResult) -> IntervalBatch:
    """Forward step (Alg. 1 line 13): the upstream-bound batch in place,
    its sampled-out slots invalid and its meta the sample's (sending is
    masking; ``compact_sample`` packs)."""
    return IntervalBatch(value=batch.value, stratum=batch.stratum,
                         valid=result.selected, meta=result.meta)


def compact_sample(batch: IntervalBatch, result: SampleResult,
                   out_capacity: int) -> IntervalBatch:
    """Pack the selected items of one node into ``out_capacity`` slots
    (the bandwidth saving of Fig. 8), weight-correcting any overflow."""
    num_strata = result.meta.weight.shape[0]
    out_capacity = min(out_capacity, batch.capacity)
    values_c, strata_c, n_sel = pack_rows(
        batch.value[None, :], batch.stratum[None, :],
        result.selected[None, :], out_capacity)
    slot_valid = (torch.arange(out_capacity, device=values_c.device)
                  < torch.clamp_max(n_sel[0], out_capacity))
    meta = _truncation_corrected_meta(slot_valid, result.y, result.meta,
                                      strata_c[0], num_strata)
    return IntervalBatch(value=values_c[0], stratum=strata_c[0],
                         valid=slot_valid, meta=meta)


def level_compact(values, strata, result: SampleResult, out_capacity: int):
    """``compact_sample`` over a stacked level → ``(values_c, strata_c,
    slot_valid, meta)`` with ``[n, out_capacity]`` buffers."""
    n_nodes, cap = values.shape
    num_strata = result.meta.weight.shape[-1]
    out_capacity = min(out_capacity, cap)
    values_c, strata_c, n_sel = pack_rows(values, strata, result.selected,
                                          out_capacity)
    slot_valid = _slot_valid(n_sel, out_capacity)
    meta = _truncation_corrected_meta(
        slot_valid, result.y, result.meta,
        _node_ix(n_nodes, values.device) * num_strata + strata_c,
        n_nodes * num_strata)
    return values_c, strata_c, slot_valid, meta


def _node_ix(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[:, None]


def _slot_valid(n_sel, out_cap: int) -> torch.Tensor:
    """bool[n, out_cap]: the first ``min(n_sel, out_cap)`` slots."""
    iota = torch.arange(out_cap, device=n_sel.device)[None, :]
    return iota < torch.clamp_max(n_sel, out_cap)[:, None]


def level_tick(keys, values, strata, valid, w_in, c_in, sample_size,
               num_strata: int, *, out_capacity: int,
               allocation: str = "fair", async_calibration: bool = True,
               backend=sampling.DEFAULT_BACKEND,
               priorities: torch.Tensor | None = None):
    """One whole WHS level tick: sample + weight update + compact.

    Bit-identical to ``level_whsamp`` followed by ``level_compact``.
    ``pallas_fused`` runs it as ONE ``fused_level_tick`` launch (only
    the truncation correction stays outside). Every other backend gets
    the saturation passthrough: when all reservoirs cover their counts
    and the buffers are front-packed, compaction is a truncating copy.

    Returns ``(values_c, strata_c, slot_valid, meta, result)``.
    """
    n_nodes, cap = values.shape
    out_cap = min(out_capacity, cap)
    be = sampling.get_backend(backend)
    if priorities is None:
        priorities = prng.uniform(keys, (cap,))
    node_seg = _node_ix(n_nodes, values.device) * num_strata

    if getattr(be, "fused_level_tick", False):
        from repro_torch.kernels.fused_level_tick import ops as ft_ops

        (keep, values_c, strata_c, n_sel, c, reservoirs, y, w_out,
         c_out) = ft_ops.fused_level_tick(
            values, strata, valid, priorities, w_in, c_in, sample_size,
            num_strata, out_cap, allocation=allocation,
            async_calibration=async_calibration)
        result = SampleResult(selected=keep,
                              meta=StratumMeta(weight=w_out, count=c_out),
                              c=c, y=y, reservoir=reservoirs)
        slot_valid = _slot_valid(n_sel, out_cap)
        meta = _truncation_corrected_meta(
            slot_valid, result.y, result.meta, node_seg + strata_c,
            n_nodes * num_strata)
        return values_c, strata_c, slot_valid, meta, result

    result = level_whsamp(keys, values, strata, valid, w_in, c_in,
                          sample_size, num_strata, allocation=allocation,
                          async_calibration=async_calibration,
                          backend=backend, max_reservoir=out_capacity,
                          priorities=priorities)
    n_valid = valid.sum(dim=1, dtype=torch.int32)
    iota = torch.arange(cap, dtype=torch.int32, device=values.device)[None, :]
    front_packed = torch.all(valid == (iota < n_valid[:, None]))
    passthrough = torch.all(result.reservoir >= result.c) & front_packed

    # Passthrough branch: keep == valid and valid is front-packed, so the
    # pack is a truncating copy, bit-identical to the scatter path.
    pt_valid = _slot_valid(n_valid, out_cap)
    pt_v = torch.where(pt_valid, values[:, :out_cap], 0.0)
    pt_s = torch.where(pt_valid, strata[:, :out_cap], 0)
    v_c, s_c, slot_valid, _ = level_compact(values, strata, result, out_cap)
    v_c = torch.where(passthrough, pt_v, v_c)
    s_c = torch.where(passthrough, pt_s, s_c)
    slot_valid = torch.where(passthrough, pt_valid, slot_valid)
    meta = _truncation_corrected_meta(slot_valid, result.y, result.meta,
                                      node_seg + s_c, n_nodes * num_strata)
    return v_c, s_c, slot_valid, meta, result
