"""The hierarchy's executors: the scan engine and ``HostTree``.

The counterpart of ``repro.core.tree``. ``HostTree`` drives the paper's
edge tree tick by tick on host buffers, one step per level (``level``)
or per node (``loop``) per tick, or as epochs of the scan engine
(``scan``); every engine folds (tick, level, node) into the seed for its
keys and runs the same level and root math, so all three agree bitwise
on identical ingest.

The scan engine: ingest → per
level flush, sample, compact and route to the parent → metadata fold →
root query, for every level in one tick function, and an epoch function
that runs ``T`` ticks. The reference's ``lax.scan`` is a Python loop
here; nothing inside it reads a device value back to the host (the tick
counter is read once per epoch by the caller, so interval gates are
host integers). An epoch draws all its priorities up front: one batched
threefry pass per level over ``[T, nodes, capacity]``, bitwise the
draws the reference makes tick by tick from the same keys; the tenant
plan's sketch uniforms are drawn the same way, from the root's keys.
With a plan, the root also answers every tenant's standing queries from
the window sample, its sketch state carried in ``TreeState.qstate``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import error as err
from repro_torch.core import prng, queries, sampling, srs, whs
from repro_torch.core.types import IntervalBatch, StratumMeta
from repro_torch.core.window import LevelState, TreeState, Window
from repro_torch.device import resolve_device


# --------------------------------------------------------------------------
# Deterministic per-node keys: fold (tick, level, node) into the base key.
# --------------------------------------------------------------------------
def _node_key(key, t, lvl: int, ix):
    return prng.fold_in(prng.fold_in(prng.fold_in(key, t), lvl), ix)


def _level_keys(key, t, lvl: int, n_nodes: int):
    """``[..., n_nodes, 2]``: node ``i``'s key at tick(s) ``t``."""
    k = prng.fold_in(prng.fold_in(key, t), lvl)
    return prng.fold_in(k[..., None, :],
                        torch.arange(n_nodes, device=k.device))


def epoch_priorities(key, ts: torch.Tensor, lvl: int, n_nodes: int,
                     cap: int) -> torch.Tensor:
    """f32 ``[T, n_nodes, cap]``: the uniforms every node of level ``lvl``
    draws at each tick of ``ts`` (``uniform(_level_keys(key, t, lvl,
    n)[i], (cap,))``), in one batched pass."""
    return prng.uniform(_level_keys(key, ts, lvl, n_nodes), (cap,))


def derive_capacities(fanin, capacity: int, max_sample_sizes,
                      interval_ticks) -> list[int]:
    """Per-level buffer capacities: level ``l+1`` holds every child's
    budget ceiling times the arrival bound (children per parent ×
    flushes per interval), so a parent buffer never truncates."""
    capacities: list[int] = []
    cap = int(capacity)
    for lvl, n_nodes in enumerate(fanin):
        capacities.append(cap)
        if lvl + 1 < len(fanin):
            children_per_parent = -(-n_nodes // fanin[lvl + 1])
            flushes = -(-interval_ticks[lvl + 1] // interval_ticks[lvl])
            cap = max(int(max_sample_sizes[lvl]) * children_per_parent
                      * flushes, 64)
    return capacities


def _child_routing(n_nodes: int, n_parents: int) -> np.ndarray:
    """``child_of[p, j]`` = parent ``p``'s ``j``-th child (ascending),
    padded with the sentinel ``n_nodes``; children map by ``ix %
    n_parents`` (the testbed wiring)."""
    cpp = -(-n_nodes // n_parents)
    child_of = np.full((n_parents, cpp), n_nodes, np.int64)
    for j in range(n_nodes):
        child_of[j % n_parents, j // n_parents] = j
    return child_of


def _present_strata(strata_c, valid_c, num_strata: int):
    """bool[n, X]: strata each node forwards items for (a message with no
    items for a stratum contributes no metadata)."""
    n = strata_c.shape[0]
    seg = torch.where(valid_c, whs._node_ix(n, strata_c.device) * num_strata
                      + strata_c, n * num_strata)
    cnt = sampling.segment_count(seg.reshape(-1), n * num_strata)
    return (cnt > 0).reshape(n, num_strata)


def _route_pack(values_c, strata_c, valid_c, child_of: torch.Tensor):
    """Gather each parent's children and pack their valid items to the
    front of the parent row: children in index order, items in compacted
    order. → ``(values[P, D], strata[P, D], n_delivered[P])``."""
    n, oc = values_c.shape
    p, cpp = child_of.shape
    d = cpp * oc

    def pad(a):
        return torch.cat([a, a.new_zeros((1, oc))])

    gv = pad(values_c)[child_of].reshape(p, d)
    gs = pad(strata_c)[child_of].reshape(p, d)
    gm = pad(valid_c)[child_of].reshape(p, d)
    return whs.pack_rows(gv, gs, gm, d)


def _linspace(start, stop, num: int):
    """``jnp.linspace(start, stop, num)`` bit for bit: ``start·(1 − s) +
    stop·s`` with ``s = i/(num−1)``, which the reference's compiled code
    contracts to ``fma(stop, s, start·(1 − s))``; the last edge is
    ``stop``."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=start.device) / div
    out = sampling.fma(stop, step, start * (1.0 - step))
    return torch.cat([out, stop.reshape(1)])


def _histogram_edges(values, selected, hist_bins: int):
    lo = torch.where(selected, values, torch.inf).min()
    hi = torch.where(selected, values, -torch.inf).max()
    return _linspace(lo, hi + 1e-6, hist_bins + 1)


# --------------------------------------------------------------------------
# Node, level and root math.
# --------------------------------------------------------------------------
def _whs_root_core(values, strata, valid, w_in, c_in, sample_size,
                   priorities, *, num_strata, allocation, backend, budget,
                   hist_bins=64, plan=None, qstate=(), draws=None,
                   telemetry=False):
    """Root = sampling + the paper's query workload: windowed SUM and MEAN
    with CLT bounds and a value histogram (§III-A lines 16-20). ``plan``
    (a tenant plan, with this window's ``draws``) adds every standing
    query's answers and bounds from the same sample; it draws nothing
    from the sampler's stream. Returns ``(outs, qstate')``."""
    batch = IntervalBatch(values, strata, valid, StratumMeta(w_in, c_in))
    res = whs.whsamp(None, batch, sample_size, num_strata,
                     allocation=allocation, backend=backend,
                     max_reservoir=budget, priorities=priorities)
    s = err.approx_sum(values, strata, res.selected, res.meta, num_strata)
    m = err.approx_mean(values, strata, res.selected, res.meta, num_strata)
    edges = _histogram_edges(values, res.selected, hist_bins)
    h = queries.weighted_histogram(batch, res, num_strata, edges)
    outs = (s.estimate, s.variance, m.estimate, m.variance,
            res.selected.sum(dtype=torch.int32), h.estimate)
    qstate2 = qstate
    if plan is not None:
        qstate2, answers, bounds = plan.evaluate(draws, batch, res, qstate)
        outs = outs + (answers, bounds)
    if telemetry:
        outs = outs + (res.c.float(), res.y.float())
    return outs, qstate2


def _srs_root_core(values, strata, valid, p_keep, f_total, priorities, *,
                   num_strata, hist_bins=64):
    """The same workload under SRS, with Horvitz–Thompson 1/f weights."""
    batch = IntervalBatch(values, strata, valid,
                          StratumMeta.identity(num_strata, values.device))
    selected = srs.srs_select(None, batch, p_keep, priorities=priorities)
    s = srs.srs_sum(batch, selected, f_total)
    m = srs.srs_mean(batch, selected, f_total)
    edges = _histogram_edges(values, selected, hist_bins)
    bin_ix = torch.clamp(torch.searchsorted(edges, values, right=True) - 1,
                         0, hist_bins - 1)
    hist = sampling.segment_sum(
        torch.where(selected, 1.0 / f_total, 0.0),
        torch.where(selected, bin_ix, hist_bins - 1), hist_bins)
    return (s.estimate, s.variance, m.estimate, m.variance,
            selected.sum(dtype=torch.int32), hist)


def _whs_level_core(values, strata, valid, w_in, c_in, sample_size,
                    priorities, *, num_strata, out_capacity, child_of,
                    allocation, backend):
    """One WHS level: ``whs.level_tick`` (one fused kernel launch for
    ``pallas_fused``), then routing to the parents."""
    v_c, s_c, valid_c, meta, _ = whs.level_tick(
        None, values, strata, valid, w_in, c_in, sample_size, num_strata,
        out_capacity=out_capacity, allocation=allocation, backend=backend,
        priorities=priorities)
    present = _present_strata(s_c, valid_c, num_strata)
    packed_v, packed_s, n_deliv = _route_pack(v_c, s_c, valid_c, child_of)
    n_fwd = valid_c.sum(dim=1, dtype=torch.int32)
    return (packed_v, packed_s, n_deliv, meta.weight, meta.count, present,
            n_fwd)


def _srs_level_core(values, strata, valid, w_in, c_in, p_keep, priorities,
                    *, num_strata, out_capacity, child_of):
    """One SRS level: coin-flip keep, compact, route to the parents."""
    out_cap = min(out_capacity, values.shape[1])
    selected = srs.level_srs_select(None, valid, p_keep,
                                    priorities=priorities)
    v_c, s_c, n_sel = whs.pack_rows(values, strata, selected, out_cap)
    n_keep = torch.clamp_max(n_sel, out_cap)
    valid_c = whs._slot_valid(n_sel, out_cap)
    present = _present_strata(s_c, valid_c, num_strata)
    packed_v, packed_s, n_deliv = _route_pack(v_c, s_c, valid_c, child_of)
    # SRS carries no sampler metadata: W/C sets pass through unchanged.
    return packed_v, packed_s, n_deliv, w_in, c_in, present, n_keep


# --------------------------------------------------------------------------
# Scan engine.
# --------------------------------------------------------------------------
def _append_rows(values, strata, fill, dropped, add_v, add_s, add_n,
                 empty: bool = False):
    """Append each row's first ``add_n[r]`` incoming items at the row's
    fill offset, truncating at capacity (the prefix backpressure rule).
    ``empty=True`` is the all-1-interval case: the receiving buffer is
    empty, so the buffer becomes the (zero-padded, cut) message."""
    n, cap = values.shape
    k = add_v.shape[1]
    add_n = add_n.to(torch.int32)
    if empty:
        take = torch.clamp_max(add_n, cap)
        if k < cap:
            add_v = torch.cat([add_v, add_v.new_zeros((n, cap - k))], dim=1)
            add_s = torch.cat([add_s, add_s.new_zeros((n, cap - k))], dim=1)
        else:
            add_v = add_v[:, :cap].contiguous().clone()
            add_s = add_s[:, :cap].contiguous().clone()
        return add_v, add_s, take, dropped + (add_n - take)
    take = torch.minimum(add_n, cap - fill)
    j = torch.arange(k, dtype=torch.int32, device=values.device)[None, :]
    ok = j < take[:, None]
    row = torch.arange(n, dtype=torch.int64, device=values.device)[:, None]
    idx = torch.where(ok, row * cap + fill[:, None] + j, n * cap)
    idx = idx.reshape(-1).to(torch.int64)
    values = torch.cat([values.reshape(-1), values.new_zeros(1)])
    strata = torch.cat([strata.reshape(-1), strata.new_zeros(1)])
    values = values.scatter_(0, idx, add_v.reshape(-1))[:-1].reshape(n, cap)
    strata = strata.scatter_(0, idx, add_s.reshape(-1))[:-1].reshape(n, cap)
    return values, strata, fill + take, dropped + (add_n - take)


def _fold_meta_graph(wc_acc, c_acc, seen, child_of: torch.Tensor, present,
                     w_out, c_out):
    """Fold each child's (W^out, C^out) message into its parent's interval
    accumulators, child slots in ascending order (the reference's f32
    accumulation order)."""
    x = w_out.shape[1]

    def pad(a):
        return torch.cat([a, a.new_zeros((1, x))])

    wp, cp, prp = pad(w_out), pad(c_out), pad(present)
    for k in range(child_of.shape[1]):
        ch = child_of[:, k]
        pr = prp[ch]
        wc_acc = wc_acc + torch.where(pr, wp[ch] * cp[ch], 0.0)
        c_acc = c_acc + torch.where(pr, cp[ch], 0.0)
        seen = seen | pr
    return wc_acc, c_acc, seen


def _flush_meta(wc_acc, c_acc, seen, w_in, c_in):
    """Fresh count-weighted-mean sets where metadata arrived this
    interval, sticky values elsewhere."""
    w_merged = wc_acc / torch.clamp_min(c_acc, 1.0)
    return (torch.where(seen, w_merged, w_in),
            torch.where(seen, c_acc, c_in))


def _build_scan_tick(fanin, capacities, sample_sizes, interval_ticks,
                     num_strata, allocation, backend, mode, p_level,
                     fraction, device, telemetry=False, hist_bins=64,
                     plan=None):
    """The fused whole-tree tick: ``(state, t, budgets, ing_v, ing_s,
    ing_n, priorities, draws) → (state', per-tick outputs)``.

    Levels chain as in the reference: level ``l``'s packed forwards are
    appended to level ``l+1`` before level ``l+1`` flushes, so one tick
    pushes data through the whole hierarchy. ``t`` is a host integer,
    so a level whose interval has not elapsed is skipped on the host.
    ``sample_sizes`` are the static per-level ceilings (they size the
    forwarding buffers); ``budgets`` f32[n_levels] on the device are the
    budgets applied. ``priorities`` holds one f32 ``[n, cap]`` per level.
    ``plan`` is the tenant plan's traced core (or ``None``); ``draws``
    is its sketch uniforms for this tick's root key.
    """
    n_levels = len(fanin)
    child_tables = [torch.as_tensor(_child_routing(fanin[l], fanin[l + 1]),
                                    device=device)
                    for l in range(n_levels - 1)]
    p_keep = torch.tensor(p_level, dtype=torch.float32, device=device)
    f_total = (torch.tensor(fraction, dtype=torch.float32, device=device)
               if fraction is not None else None)

    def f32_zero(shape=()):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def tick(state: TreeState, t: int, budgets, ing_v, ing_s, ing_n,
             priorities, draws=None):
        lv = {f: list(getattr(state, f)) for f in TreeState.LEVEL_FIELDS}
        if not isinstance(state.route, tuple):
            ing_s = state.route[ing_s.to(torch.int64)
                                .clamp(0, state.route.shape[0] - 1)]

        (lv["values"][0], lv["strata"][0], lv["fill"][0],
         lv["dropped"][0]) = _append_rows(
            lv["values"][0], lv["strata"][0], lv["fill"][0],
            lv["dropped"][0], ing_v, ing_s, ing_n,
            empty=int(interval_ticks[0]) == 1)

        n_fwd_levels, tel_in, tel_kept = [], [], []
        root_out = root_strat = None
        q_out = state.qstate
        for l in range(n_levels):
            iv = int(interval_ticks[l])
            is_root = l == n_levels - 1
            fill = lv["fill"][l]
            due = t % iv == 0
            if telemetry:
                tel_in.append(fill.sum().float() if due else f32_zero())
            if not due:
                # Not-due tick: every leaf unchanged, null outputs.
                if is_root:
                    root_out = (torch.zeros((), dtype=torch.bool,
                                            device=device),
                                f32_zero(), f32_zero(), f32_zero(),
                                f32_zero(),
                                torch.zeros((), dtype=torch.int32,
                                            device=device),
                                f32_zero((hist_bins,)))
                    if plan is not None:
                        root_out = root_out + (f32_zero((plan.n_out,)),) * 2
                    if telemetry and mode != "srs":
                        root_strat = (f32_zero((num_strata,)),) * 2
                    if telemetry:
                        tel_kept.append(f32_zero())
                else:
                    n_fwd_levels.append(torch.zeros((), dtype=torch.int32,
                                                    device=device))
                    if telemetry:
                        tel_kept.append(f32_zero())
                continue

            cap = capacities[l]
            valid = (torch.arange(cap, dtype=torch.int32,
                                  device=device)[None, :] < fill[:, None])
            w_eff, c_eff = _flush_meta(lv["wc_acc"][l], lv["c_acc"][l],
                                       lv["seen"][l], lv["w_in"][l],
                                       lv["c_in"][l])
            values, strata = lv["values"][l], lv["strata"][l]
            prio = priorities[l]
            if is_root:
                if mode == "srs":
                    outs = _srs_root_core(
                        values[0], strata[0], valid[0], p_keep, f_total,
                        prio[0], num_strata=num_strata, hist_bins=hist_bins)
                else:
                    outs, q_out = _whs_root_core(
                        values[0], strata[0], valid[0], w_eff[0], c_eff[0],
                        budgets[l], prio[0], num_strata=num_strata,
                        allocation=allocation, backend=backend,
                        budget=int(sample_sizes[l]), hist_bins=hist_bins,
                        plan=plan, qstate=state.qstate, draws=draws,
                        telemetry=telemetry)
                    if telemetry:
                        root_strat, outs = outs[-2:], outs[:-2]
                root_out = (fill.sum() > 0,) + outs
                if telemetry:
                    tel_kept.append(root_out[5].float())
            else:
                if mode == "srs":
                    (packed_v, packed_s, n_deliv, w_out, c_out, present,
                     n_fwd) = _srs_level_core(
                        values, strata, valid, w_eff, c_eff, p_keep, prio,
                        num_strata=num_strata,
                        out_capacity=int(sample_sizes[l]),
                        child_of=child_tables[l])
                else:
                    (packed_v, packed_s, n_deliv, w_out, c_out, present,
                     n_fwd) = _whs_level_core(
                        values, strata, valid, w_eff, c_eff, budgets[l],
                        prio, num_strata=num_strata,
                        out_capacity=int(sample_sizes[l]),
                        child_of=child_tables[l], allocation=allocation,
                        backend=backend)
                (lv["values"][l + 1], lv["strata"][l + 1], lv["fill"][l + 1],
                 lv["dropped"][l + 1]) = _append_rows(
                    lv["values"][l + 1], lv["strata"][l + 1],
                    lv["fill"][l + 1], lv["dropped"][l + 1],
                    packed_v, packed_s, n_deliv,
                    empty=(iv == 1 and int(interval_ticks[l + 1]) == 1))
                (lv["wc_acc"][l + 1], lv["c_acc"][l + 1],
                 lv["seen"][l + 1]) = _fold_meta_graph(
                    lv["wc_acc"][l + 1], lv["c_acc"][l + 1],
                    lv["seen"][l + 1], child_tables[l], present, w_out,
                    c_out)
                n_fwd_levels.append(n_fwd.sum(dtype=torch.int32))
                if telemetry:
                    tel_kept.append(n_fwd_levels[-1].float())
            # Interval reset (``flush``): occupancy and accumulators
            # cleared, sticky sets refreshed; stale slots stay masked.
            lv["fill"][l] = torch.zeros_like(fill)
            lv["wc_acc"][l] = torch.zeros_like(lv["wc_acc"][l])
            lv["c_acc"][l] = torch.zeros_like(lv["c_acc"][l])
            lv["seen"][l] = torch.zeros_like(lv["seen"][l])
            lv["w_in"][l], lv["c_in"][l] = w_eff, c_eff

        new_tel = state.telemetry
        if telemetry:
            tel = state.telemetry
            d_in = torch.stack(tel_in)
            d_kept = torch.stack(tel_kept)
            flushed = d_in > 0
            root_ok, se, sv = root_out[0], root_out[1], root_out[2]
            new_tel = tel._replace(
                items_in=tel.items_in + d_in,
                items_kept=tel.items_kept + d_kept,
                flushes=tel.flushes + flushed.to(torch.int32),
                saturation_hits=tel.saturation_hits
                + (flushed & (d_kept >= d_in)).to(torch.int32),
                windows=tel.windows + root_ok.to(torch.int32),
                root_sum=tel.root_sum + torch.where(root_ok, se, 0.0),
                root_sum_var=tel.root_sum_var
                + torch.where(root_ok, sv, 0.0))
            if root_strat is not None:
                new_tel = new_tel._replace(
                    stratum_in=new_tel.stratum_in + root_strat[0],
                    stratum_kept=new_tel.stratum_kept + root_strat[1])
            if plan is not None:
                ans, bnd = root_out[7], root_out[8]
                rel = bnd / torch.clamp_min(ans.abs(), 1e-9)
                new_tel = new_tel._replace(
                    slot_rel_bound_sum=new_tel.slot_rel_bound_sum
                    + torch.where(root_ok, rel, 0.0))

        new_state = TreeState(
            **{f: tuple(lv[f]) for f in TreeState.LEVEL_FIELDS},
            qstate=q_out, telemetry=new_tel, route=state.route)
        n_fwd = (torch.stack(n_fwd_levels) if n_fwd_levels else
                 torch.zeros((0,), dtype=torch.int32, device=device))
        return new_state, root_out + (n_fwd,)

    return tick


def _build_epoch_fn(tick_fn, fanin, capacities, plan=None):
    """An epoch: ``(state, key, t0, budgets, ing_v, ing_s, ing_n) →
    (state', (ticks, *stacked per-tick outputs))``. ``t0`` is the host
    value of the first tick; ingest is ``[T, fanin[0], width]``. The
    priorities of every level and the ``plan``'s sketch uniforms (from
    the root node's key at each tick) are drawn for the whole epoch up
    front."""

    def epoch(state: TreeState, key, t0: int, budgets, ing_v, ing_s, ing_n):
        epoch_ticks = ing_v.shape[0]
        ts = torch.arange(epoch_ticks, dtype=torch.int64,
                          device=ing_v.device) + t0
        prio = [epoch_priorities(key, ts, l, fanin[l], capacities[l])
                for l in range(len(fanin))]
        draws = None
        if plan is not None:
            draws = plan.draws(_node_key(key, ts, len(fanin) - 1, 0))
        rows = []
        for i in range(epoch_ticks):
            state, out = tick_fn(
                state, t0 + i, budgets, ing_v[i], ing_s[i], ing_n[i],
                [p[i] for p in prio],
                None if draws is None else
                tuple(None if d is None else d[i] for d in draws))
            rows.append(out)
        stacked = tuple(torch.stack(col) for col in zip(*rows))
        return state, (ts.to(torch.int32),) + stacked

    return epoch


# --------------------------------------------------------------------------
# Per-tick steps of the ``level`` and ``loop`` engines. Each runs the same
# core as the scan engine with the same (tick, level, node) keys, on
# device tensors, and returns device tensors; the engine reads back what
# the host needs. ``t`` and ``ix`` are host integers.
# --------------------------------------------------------------------------
def _node_step(capacity: int, num_strata: int, out_capacity: int,
               allocation: str, backend: str, lvl: int):
    """Loop engine, one WHS node: sample, compact (with the truncation
    correction) → ``(values, strata, valid, W^out, C^out, y)``."""

    def step(key, t, ix, values, strata, valid, w_in, c_in, sample_size):
        k = _node_key(key, t, lvl, ix)
        batch = IntervalBatch(values, strata, valid, StratumMeta(w_in, c_in))
        res = whs.whsamp(k, batch, sample_size, num_strata,
                         allocation=allocation, backend=backend,
                         max_reservoir=out_capacity)
        out = whs.compact_sample(batch, res, out_capacity)
        return (out.value, out.stratum, out.valid, out.meta.weight,
                out.meta.count, res.y)

    return step


def _root_step(capacity: int, num_strata: int, allocation: str, backend: str,
               lvl: int, budget: int, hist_bins: int = 64):
    """The WHS root without tenants → the root core's outputs."""

    def step(key, t, values, strata, valid, w_in, c_in, sample_size):
        prio = prng.uniform(_node_key(key, t, lvl, 0), (capacity,))
        outs, _ = _whs_root_core(values, strata, valid, w_in, c_in,
                                 sample_size, prio, num_strata=num_strata,
                                 allocation=allocation, backend=backend,
                                 budget=budget, hist_bins=hist_bins)
        return outs

    return step


def _plan_root_step(plan, num_strata: int, allocation: str, backend: str,
                    lvl: int, budget: int):
    """The WHS root with a tenant plan: the host threads the sketch state
    through → ``(outs, qstate')``. The sketch uniforms come from the
    root's key, as the scan engine draws them."""

    def step(key, t, values, strata, valid, w_in, c_in, qstate,
             sample_size):
        k = _node_key(key, t, lvl, 0)
        prio = prng.uniform(k, (values.shape[0],))
        draws = tuple(None if d is None else d[0]
                      for d in plan.draws(k[None]))
        return _whs_root_core(values, strata, valid, w_in, c_in,
                              sample_size, prio, num_strata=num_strata,
                              allocation=allocation, backend=backend,
                              budget=budget, plan=plan, qstate=qstate,
                              draws=draws)

    return step


def _srs_node_step(capacity: int, num_strata: int, out_capacity: int,
                   lvl: int):
    """Loop engine, one SRS node: coin flips, compaction without weight
    bookkeeping (SRS carries no metadata)."""
    out_cap = min(out_capacity, capacity)

    def step(key, t, ix, values, strata, valid, w_in, c_in, p_keep):
        batch = IntervalBatch(values, strata, valid, StratumMeta(w_in, c_in))
        selected = srs.srs_select(_node_key(key, t, lvl, ix), batch, p_keep)
        v_c, s_c, n_sel = whs.pack_rows(values[None], strata[None],
                                        selected[None], out_cap)
        slot_valid = whs._slot_valid(n_sel, out_cap)[0]
        return v_c[0], s_c[0], slot_valid, w_in, c_in, n_sel[0]

    return step


def _srs_root_step(capacity: int, num_strata: int, lvl: int,
                   hist_bins: int = 64):
    def step(key, t, values, strata, valid, w_in, c_in, p_keep, f_total):
        prio = prng.uniform(_node_key(key, t, lvl, 0), (capacity,))
        return _srs_root_core(values, strata, valid, p_keep, f_total, prio,
                              num_strata=num_strata, hist_bins=hist_bins)

    return step


def _whs_level_step(n_nodes: int, capacity: int, num_strata: int,
                    out_capacity: int, n_parents: int, allocation: str,
                    backend: str, lvl: int, device):
    """Level engine, one WHS level → ``_whs_level_core``'s outputs."""
    child_of = torch.as_tensor(_child_routing(n_nodes, n_parents),
                               device=device)

    def step(key, t, values, strata, valid, w_in, c_in, sample_size):
        prio = prng.uniform(_level_keys(key, t, lvl, n_nodes), (capacity,))
        return _whs_level_core(values, strata, valid, w_in, c_in,
                               sample_size, prio, num_strata=num_strata,
                               out_capacity=out_capacity, child_of=child_of,
                               allocation=allocation, backend=backend)

    return step


def _srs_level_step(n_nodes: int, capacity: int, num_strata: int,
                    out_capacity: int, n_parents: int, lvl: int, device):
    child_of = torch.as_tensor(_child_routing(n_nodes, n_parents),
                               device=device)

    def step(key, t, values, strata, valid, w_in, c_in, p_keep):
        prio = prng.uniform(_level_keys(key, t, lvl, n_nodes), (capacity,))
        return _srs_level_core(values, strata, valid, w_in, c_in, p_keep,
                               prio, num_strata=num_strata,
                               out_capacity=out_capacity, child_of=child_of)

    return step


def accumulate_epoch_accounting(tree, wall: float, counts, offered,
                                n_fwd) -> None:
    """Per-epoch accounting of ``HostTree.run_epoch`` and of
    ``launch.analytics._CompiledDriver``: one dispatch; the epoch's wall time
    attributed to levels in proportion to their buffer slots
    (``n_nodes × capacity``, a static model: the epoch cannot see time
    per level); ``offered`` (default ``counts``) the pre-truncation ingest
    count; ``n_fwd`` the per-(tick, level) forwarded counts."""
    tree.dispatch_count += 1
    slots = [n * c for n, c in zip(tree.fanin, tree.capacities)]
    total = float(sum(slots))
    for lvl, s in enumerate(slots):
        tree.level_time_s[lvl] += wall * s / total
    tree.items_ingested += int(
        np.asarray(counts if offered is None else offered).sum())
    for lvl in range(len(tree.fanin) - 1):
        tree.items_forwarded[lvl] += int(n_fwd[:, lvl].sum())


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class HostTree:
    """The emulated edge topology driven tick by tick (default geometry:
    the paper's testbed, 8 sources → 4 → 2 → 1 root), the counterpart of
    ``repro.core.tree.HostTree``.

    ``mode="whs"`` runs the weighted hierarchical sampler; ``mode="srs"``
    the coin-flip baseline (per-level keep probability ``p_level`` so the
    end-to-end fraction is ``fraction``). ``engine``:

    * ``"level"`` — one step per level per tick over host ``LevelState``
      buffers (a level's nodes stacked, selection flattened for the
      ``pallas`` backends);
    * ``"loop"``  — one step per node per tick over host ``Window``s;
    * ``"scan"``  — the whole tree on the device, one epoch of ``T`` ticks
      per ``run_epoch`` call.

    All three draw priorities from the same ``(tick, level, node)`` keys
    and run the same level and root math, so they agree bitwise on
    identical ingest. ``dispatch_count`` counts step calls (epochs for
    the scan engine); ``level_time_s`` the host-measured time of each
    level's steps (the scan engine apportions an epoch by buffer slots).
    The steps run on ``device`` (``"cuda"`` by default; raises without a
    card unless ``"cpu"`` is asked for).
    """

    def __init__(self, fanin: list[int], num_strata: int, capacity: int,
                 sample_sizes: list[int],
                 interval_ticks: list[int] | None = None,
                 allocation: str = "fair", seed: int = 0, mode: str = "whs",
                 fraction: float | None = None, engine: str = "level",
                 sampler_backend: str = "topk", queries=None,
                 max_sample_sizes: list[int] | None = None,
                 route_keys: int | None = None, device="cuda"):
        if fanin[-1] != 1:
            raise ValueError("the last level must be the single root")
        if mode not in ("whs", "srs"):
            raise ValueError(f"mode must be 'whs' or 'srs', got {mode!r}")
        if engine not in ("level", "loop", "scan"):
            raise ValueError(f"engine must be level, loop or scan, got "
                             f"{engine!r}")
        if route_keys is not None and engine != "scan":
            raise ValueError("adaptive stratum routing needs the scan "
                             "engine")
        self.device = resolve_device(device)
        self.fanin = list(fanin)
        self.num_strata = num_strata
        self.allocation = allocation
        self.sample_sizes = list(sample_sizes)
        self.max_sample_sizes = list(max_sample_sizes or sample_sizes)
        if not all(m >= s for m, s in zip(self.max_sample_sizes,
                                          self.sample_sizes)):
            raise ValueError("max_sample_sizes must dominate the initial "
                             "sample_sizes")
        self.mode = mode
        self.engine = engine
        self.sampler_backend = sampler_backend
        sampling.get_backend(sampler_backend)     # an unknown name raises
        self.fraction = fraction
        if queries is not None and not hasattr(queries, "evaluate"):
            # A raw QueryRegistry becomes the single-tenant slotted plan
            # the API compiles, so both front doors run the same plan.
            from repro_torch.query.compiler import build_slotted_plan

            queries = build_slotted_plan((("default", queries.specs),),
                                         num_strata)
        self.plan = queries
        self._traced_plan = getattr(queries, "core", queries)
        if self.plan is not None and mode != "whs":
            raise ValueError("the query plane needs WHS stratum metadata "
                             "(mode='whs')")
        self.p_level = (float(fraction) ** (1.0 / len(fanin))
                        if fraction is not None else 1.0)
        interval_ticks = interval_ticks or [1] * len(fanin)
        self.capacities = derive_capacities(fanin, capacity,
                                            self.max_sample_sizes,
                                            interval_ticks)
        dev = self.device
        if engine == "loop":
            self.levels = [
                [Window(self.capacities[lvl], num_strata, interval_ticks[lvl])
                 for _ in range(n_nodes)]
                for lvl, n_nodes in enumerate(fanin)]
        elif engine == "level":
            self.levels = [
                LevelState(n_nodes, self.capacities[lvl], num_strata,
                           interval_ticks[lvl])
                for lvl, n_nodes in enumerate(fanin)]
        else:
            self.levels = None
            self._state = TreeState.create(
                fanin, self.capacities, num_strata, device=dev,
                qstate=(self.plan.init_state(dev) if self.plan is not None
                        else ()),
                route=(torch.arange(int(route_keys), dtype=torch.int32,
                                    device=dev) if route_keys else ()))
            tick_fn = _build_scan_tick(
                fanin, self.capacities, self.max_sample_sizes,
                interval_ticks, num_strata, allocation, sampler_backend,
                mode, self.p_level, fraction, dev, plan=self._traced_plan)
            self._epoch_fn = _build_epoch_fn(tick_fn, fanin,
                                             self.capacities,
                                             plan=self._traced_plan)
        if engine != "scan" and self.plan is not None:
            self._qstate = self.plan.init_state(dev)
            self._plan_step = _plan_root_step(
                self.plan, num_strata, allocation, sampler_backend,
                len(fanin) - 1, int(self.max_sample_sizes[-1]))
        self._steps: dict = {}
        self._key = prng.PRNGKey(seed, device=dev)
        self.items_forwarded = [0] * len(fanin)
        self.items_ingested = 0
        self.level_time_s = [0.0] * len(fanin)
        self.dispatch_count = 0
        self.results: list[dict] = []

    @classmethod
    def from_spec(cls, spec, engine: str = "level",
                  device="cuda") -> "HostTree":
        """A ``HostTree`` from a ``repro_torch.api.PipelineSpec``, resolved
        as ``compile`` resolves it (sample sizes, ceilings, intervals,
        the tenant plan), so the two front doors agree bitwise."""
        from repro_torch.api.spec import resolve

        r = resolve(spec)
        return cls(
            fanin=list(spec.topology.fanin),
            num_strata=spec.topology.num_strata,
            capacity=spec.topology.capacity,
            sample_sizes=list(r.sample_sizes),
            interval_ticks=list(r.interval_ticks),
            allocation=spec.sampler.allocation, seed=spec.seed,
            mode=spec.sampler.mode, fraction=spec.sampler.fraction,
            engine=engine, sampler_backend=spec.sampler.backend,
            queries=r.plan, max_sample_sizes=list(r.max_sample_sizes),
            route_keys=((spec.strata.num_keys or None)
                        if engine == "scan" else None),
            device=device)

    def ingest(self, node: int, values: np.ndarray,
               strata: np.ndarray) -> None:
        """Source → level-0 node delivery."""
        if self.engine == "scan":
            raise RuntimeError("engine='scan' ingests per epoch: use "
                               "run_epoch(t0, values, strata, counts)")
        self.items_ingested += len(values)
        if self.engine == "loop":
            self.levels[0][node].deliver(values, strata)
        else:
            self.levels[0].deliver(node, values, strata)

    def tick(self, t: int) -> None:
        """Advance one global tick: flush every due window, push upstream."""
        if self.engine == "scan":
            raise RuntimeError("engine='scan' advances per epoch: use "
                               "run_epoch(t0, values, strata, counts)")
        if self.engine == "loop":
            self._tick_loop(t)
        else:
            self._tick_level(t)

    # ------------------------------------------------------------- scan --
    def run_epoch(self, t0: int, values: np.ndarray, strata: np.ndarray,
                  counts: np.ndarray,
                  offered: np.ndarray | None = None) -> None:
        """Advance ``T`` ticks (``t0 .. t0+T-1``) in one epoch.

        ``values``/``strata`` are ``[T, fanin[0], width]`` tick-major
        padded ingest (``data.stream.batch_ingest``), ``counts`` the
        per-(tick, node) item counts; ``offered`` the pre-truncation
        counts for ``items_ingested`` (default ``counts``). The ingest
        moves to the device in one copy; the stacked root results come
        back in one read."""
        if self.engine != "scan":
            raise RuntimeError("run_epoch requires engine='scan'")
        epoch_ticks, n0, _ = np.shape(values)
        if n0 != self.fanin[0]:
            raise ValueError("ingest rows must match level-0 nodes")
        dev = self.device
        budgets = torch.tensor([float(s) for s in self.sample_sizes],
                               dtype=torch.float32, device=dev)
        t_start = time.perf_counter()
        self._state, outs = self._epoch_fn(
            self._state, self._key, int(t0), budgets,
            torch.as_tensor(values, dtype=torch.float32, device=dev),
            torch.as_tensor(strata, dtype=torch.int32, device=dev),
            torch.as_tensor(counts, dtype=torch.int32, device=dev))
        outs = [_host(o) for o in outs[1:]]       # one device→host sync
        if self.plan is not None:
            root_ok, se, sv, me, mv, nsel, hist, ans, bnd, n_fwd = outs
            ans, bnd = self.plan.compact(ans), self.plan.compact(bnd)
        else:
            root_ok, se, sv, me, mv, nsel, hist, n_fwd = outs
            ans = bnd = None
        wall = time.perf_counter() - t_start
        accumulate_epoch_accounting(self, wall, counts, offered, n_fwd)
        for i in range(epoch_ticks):
            if root_ok[i]:
                row = dict(tick=t0 + i, sum=float(se[i]),
                           sum_var=float(sv[i]), mean=float(me[i]),
                           mean_var=float(mv[i]), n_sampled=int(nsel[i]),
                           histogram=hist[i])
                if ans is not None:
                    row["answers"], row["bounds"] = ans[i], bnd[i]
                self.results.append(row)

    def reset_query_state(self) -> None:
        """Empty the standing queries' sketch state (drivers call this
        after warmup, so continuous answers cover the measured ticks)."""
        if self.plan is None:
            return
        if self.engine == "scan":
            self._state = self._state._replace(
                qstate=self.plan.init_state(self.device))
        else:
            self._qstate = self.plan.init_state(self.device)

    def set_route(self, route) -> None:
        """Install a new key→stratum table (adaptive stratification): a
        same-shape edit of the scan state, read by the next epoch."""
        if self.engine != "scan":
            raise RuntimeError("routing lives in the scan state")
        if isinstance(self._state.route, tuple):
            raise RuntimeError("tree was built without route_keys")
        r = torch.as_tensor(np.asarray(route), dtype=torch.int32,
                            device=self.device)
        if r.shape != self._state.route.shape:
            raise ValueError("the route table's shape is fixed")
        self._state = self._state._replace(route=r)

    def set_sample_sizes(self, sizes) -> None:
        """Move the applied per-level budgets (the controller's knob),
        clamped to ``[1, max_sample_sizes]``: the buffers upstream were
        sized for the ceilings."""
        if len(sizes) != len(self.fanin):
            raise ValueError("sizes must have one entry per level")
        self.sample_sizes = [min(max(float(s), 1.0), float(m))
                             for s, m in zip(sizes, self.max_sample_sizes)]

    # --------------------------------------------------------- helpers --
    def _step(self, factory, *args):
        """The step of ``factory`` for these static arguments, built once."""
        key = (factory.__name__,) + args
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = factory(*args)
        return step

    def _on_device(self, values, strata, valid, w_in, c_in):
        dev = self.device
        return (torch.as_tensor(values, dtype=torch.float32, device=dev),
                torch.as_tensor(strata, dtype=torch.int32, device=dev),
                torch.as_tensor(valid, dtype=torch.bool, device=dev),
                torch.as_tensor(w_in, dtype=torch.float32, device=dev),
                torch.as_tensor(c_in, dtype=torch.float32, device=dev))

    def _f32(self, x) -> torch.Tensor:
        return torch.tensor(float(x), dtype=torch.float32,
                            device=self.device)

    def _root_result(self, t: int, outs) -> dict:
        """Host-side result row from a root step's outputs."""
        se, sv, me, mv, nsel, hist = (_host(o) for o in outs[:6])
        row = dict(tick=t, sum=float(se), sum_var=float(sv), mean=float(me),
                   mean_var=float(mv), n_sampled=int(nsel), histogram=hist)
        if len(outs) > 6:
            ans, bnd = _host(outs[6]), _host(outs[7])
            ans, bnd = self.plan.compact(ans), self.plan.compact(bnd)
            row["answers"], row["bounds"] = ans, bnd
        return row

    def _run_root(self, lvl: int, t: int, values, strata, valid, w_in, c_in,
                  capacity: int):
        if self.mode == "srs":
            step = self._step(_srs_root_step, capacity, self.num_strata, lvl)
            return step(self._key, t, values, strata, valid, w_in, c_in,
                        self._f32(self.p_level), self._f32(self.fraction))
        size = self._f32(self.sample_sizes[lvl])
        if self.plan is not None:
            outs, self._qstate = self._plan_step(
                self._key, t, values, strata, valid, w_in, c_in,
                self._qstate, size)
            return outs
        step = self._step(_root_step, capacity, self.num_strata,
                          self.allocation, self.sampler_backend, lvl,
                          int(self.max_sample_sizes[lvl]))
        return step(self._key, t, values, strata, valid, w_in, c_in, size)

    # ------------------------------------------------------------- loop --
    def _tick_loop(self, t: int) -> None:
        for lvl, nodes in enumerate(self.levels):
            is_root = lvl == len(self.levels) - 1
            n_parents = self.fanin[lvl + 1] if not is_root else 1
            for ix, win in enumerate(nodes):
                if not win.due(t) or win.fill == 0:
                    continue
                flushed = win.flush()
                t0 = time.perf_counter()
                args = self._on_device(*flushed)
                if is_root:
                    outs = self._run_root(lvl, t, *args, win.capacity)
                    self.dispatch_count += 1
                    row = self._root_result(t, outs)     # reads back: syncs
                    self.level_time_s[lvl] += time.perf_counter() - t0
                    self.results.append(row)
                    continue
                out_cap = self.max_sample_sizes[lvl]
                if self.mode == "srs":
                    step = self._step(_srs_node_step, win.capacity,
                                      self.num_strata, out_cap, lvl)
                    outs = step(self._key, t, ix, *args,
                                self._f32(self.p_level))
                else:
                    step = self._step(_node_step, win.capacity,
                                      self.num_strata, out_cap,
                                      self.allocation, self.sampler_backend,
                                      lvl)
                    outs = step(self._key, t, ix, *args,
                                self._f32(self.sample_sizes[lvl]))
                self.dispatch_count += 1
                ov, os_, oval, w_out, c_out = (_host(o) for o in outs[:5])
                self.level_time_s[lvl] += time.perf_counter() - t0
                n = int(oval.sum())
                self.items_forwarded[lvl] += n
                parent = self.levels[lvl + 1][ix % n_parents]
                parent.deliver(ov[:n], os_[:n], w_out, c_out)

    # ------------------------------------------------------------ level --
    def _tick_level(self, t: int) -> None:
        for lvl, state in enumerate(self.levels):
            is_root = lvl == len(self.levels) - 1
            if not state.due(t) or int(state.fill.sum()) == 0:
                continue
            flushed = state.flush_all()
            t0 = time.perf_counter()
            values, strata, valid, w_in, c_in = self._on_device(*flushed)
            if is_root:
                # The root is a single node: the root step on its row.
                outs = self._run_root(lvl, t, values[0], strata[0], valid[0],
                                      w_in[0], c_in[0], state.capacity)
                self.dispatch_count += 1
                row = self._root_result(t, outs)         # reads back: syncs
                self.level_time_s[lvl] += time.perf_counter() - t0
                self.results.append(row)
                continue
            n_parents = self.fanin[lvl + 1]
            out_cap = self.max_sample_sizes[lvl]
            if self.mode == "srs":
                step = self._step(_srs_level_step, state.n_nodes,
                                  state.capacity, self.num_strata, out_cap,
                                  n_parents, lvl, self.device)
                outs = step(self._key, t, values, strata, valid, w_in, c_in,
                            self._f32(self.p_level))
            else:
                step = self._step(_whs_level_step, state.n_nodes,
                                  state.capacity, self.num_strata, out_cap,
                                  n_parents, self.allocation,
                                  self.sampler_backend, lvl, self.device)
                outs = step(self._key, t, values, strata, valid, w_in, c_in,
                            self._f32(self.sample_sizes[lvl]))
            self.dispatch_count += 1
            (packed_v, packed_s, n_deliv, w_out, c_out, present,
             n_fwd) = (_host(o) for o in outs)
            self.level_time_s[lvl] += time.perf_counter() - t0
            self.items_forwarded[lvl] += int(n_fwd.sum())
            parent = self.levels[lvl + 1]
            parent.deliver_packed(packed_v, packed_s, n_deliv)
            parent.fold_meta(np.arange(state.n_nodes) % n_parents, present,
                             w_out, c_out)
