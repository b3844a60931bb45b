"""Query-plan compiler: K standing queries answered from one window sample.

The counterpart of ``repro.query.compiler``. ``CompiledQueryPlan`` turns
a tuple of ``QuerySpec``s into what the scan engine calls at the root:

* ``init_state(device)`` — sketch state, one entry per spec (``()`` for
  the stateless CLT queries), carried in ``TreeState.qstate``.
* ``draws(keys)`` — the uniforms the quantile sketches draw, for any
  number of root keys at once. The reference draws them inside each
  fold from ``fold_in(fold_in(node_key, 0x51C7), i)``, ``fold_in(·, h)``
  per level and ``fold_in(·, 0x574D)`` for the windowed merge; the scan
  engine here draws a whole epoch's in one batched threefry pass, so the
  tick loop reads nothing back to the host.
* ``evaluate(draws, batch, res, state)`` — ``(state', answers f32[n_out],
  bounds f32[n_out])`` for one window: one shared ``stratum_moments``
  pass feeds every CLT query, histograms scatter once each, sketches
  fold the window in and answer from the result.
* ``exact_answers(values)`` — NumPy ground truth in the same layout.

The evaluation draws nothing from the sampler's key stream, so
registering queries leaves every sample and state buffer bitwise as it
was.

Tenants: ``SlotPlanCore`` evaluates each group of tenants that share a
name-free signature as a slot dimension of stacked sketch state with an
active mask (the reference's ``vmap`` over slots is a loop over slots
here, with the same masking law: an active slot's answers and state are
untouched, an inactive one freezes and answers zeros).
``SlottedTenantPlan`` maps tenant names onto slots and the padded
answer vector onto the public one; its ``admit``/``retire`` return a new
plan and a qstate transform (tenant churn as a state edit; on the mesh
the state carries a leading rank axis, ``slot_axis=1``) and
``slot_manifest`` describes the slots for checkpoints.

The mesh path (``evaluate_spmd``, with ``draws_spmd``): every rank folds
its shard's sample into its own sketches, and the window is answered
from summaries merged across the ranks of a ``launch.mesh.DataMesh``:
CLT moments and histogram bins summed, counts summed as exact integers,
quantile buffers and count-min tables gathered and merged with merge
randomness every rank draws alike.

``MultiTenantPlan`` is the reference's first multi-tenant plan: one
``CompiledQueryPlan`` per tenant evaluated in one root step, the public
vector the tenants' blocks in registration order. The slot plan
replaced it on every path with the same public layout; it stays a
public name of both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import error as err
from repro_torch.core import prng
from repro_torch.core.queries import weighted_histogram
from repro_torch.core.sampling import fma, fma_dot, seq_sum, sqrt_rn
from repro_torch.core.types import IntervalBatch, SampleResult
from repro_torch.query import sketches
from repro_torch.query.registry import QuerySpec

# fold_in tag separating the query plane's PRNG stream from the sampler's
_QUERY_KEY_TAG = 0x51C7
# fold_in tag of the merge randomness every rank draws alike (mesh path)
_MERGE_KEY_TAG = 0x4D52
# fold_in tag for the windowed-quantile ring's query-time merge randomness
_WINDOW_MERGE_TAG = 0x574D
_SKETCH_KINDS = ("quantile", "windowed_quantile")


def stratum_stats(batch: IntervalBatch, num_strata: int):
    """Pre-sampling per-stratum ``(count, mean, std)`` of one window,
    from the same ``stratum_moments`` pass that feeds the CLT queries.
    ``s2/safe − mean·mean`` is one FMA in the reference's compiled
    code."""
    y, s1, s2 = err.stratum_moments(batch.value, batch.stratum,
                                    batch.valid, num_strata)
    safe = torch.clamp_min(y, 1.0)
    mean = s1 / safe
    var = torch.clamp_min(fma(-mean, mean, s2 / safe), 0.0)
    return y, mean, sqrt_rn(var)


def _linspace_const(lo: float, hi: float, num: int) -> np.ndarray:
    """``jnp.linspace(lo, hi, num)`` of Python floats, bit for bit: the
    reference's compiler folds it as a constant, which evaluates
    ``lo·(1 − s) + hi·s`` in f32 with no FMA."""
    div = num - 1
    s = np.arange(div, dtype=np.float32) / np.float32(div)
    out = (np.float32(lo) * (np.float32(1.0) - s)
           + np.float32(hi) * s).astype(np.float32)
    return np.concatenate([out, np.asarray([hi], np.float32)])


class CompiledQueryPlan:
    """Static plan of K specs (see the module doc)."""

    def __init__(self, specs: tuple[QuerySpec, ...], num_strata: int):
        if not specs:
            raise ValueError("cannot compile an empty query registry")
        self.specs = tuple(specs)
        self.num_strata = int(num_strata)
        off = 0
        self._layout: dict[str, tuple[int, int, str]] = {}
        for sp in self.specs:
            self._layout[sp.name] = (off, sp.out_width, sp.kind)
            off += sp.out_width
        self.n_out = off
        self._levels = max((len(sketches.kll_schedule(sp.capacity))
                            for sp in self.specs if sp.kind in _SKETCH_KINDS),
                           default=0)
        kinds = {sp.kind for sp in self.specs}
        self._shared_ht_total = {"count", "mean"} <= kinds
        self._consts: dict = {}

    @property
    def k(self) -> int:
        return len(self.specs)

    def layout(self) -> dict[str, tuple[int, int, str]]:
        """name → (offset, width, kind) into the flat answer vector."""
        return dict(self._layout)

    def answer(self, vec, name: str) -> np.ndarray:
        """Slice one query's answers out of a flat (host) answer vector."""
        o, w, _ = self._layout[name]
        return _host(vec)[..., o:o + w]

    def init_state(self, device=None) -> tuple:
        state = []
        for sp in self.specs:
            if sp.kind == "quantile":
                state.append(sketches.quantile_init(sp.capacity, device))
            elif sp.kind in ("heavy_hitters", "decayed_heavy_hitters"):
                state.append(sketches.hh_init(sp.k, sp.width, sp.depth,
                                              device))
            elif sp.kind == "windowed_quantile":
                state.append(sketches.windowed_quantile_init(
                    sp.capacity, sp.window, device))
            else:
                state.append(())
        return tuple(state)

    def draws(self, keys: torch.Tensor) -> torch.Tensor | None:
        """f32 ``[..., 2, K, L]`` for root keys ``[..., 2]``: the uniform
        of spec ``i``'s fold at level ``h``, for the update (row 0) and
        the windowed merge (row 1). ``None`` when no spec draws."""
        if not self._levels:
            return None
        dev = keys.device
        kq = prng.fold_in(prng.fold_in(keys, _QUERY_KEY_TAG)[..., None, :],
                          torch.arange(self.k, device=dev))
        km = prng.fold_in(kq, _WINDOW_MERGE_TAG)
        lv = torch.arange(self._levels, device=dev)
        both = torch.stack([kq, km], dim=-3)[..., None, :]
        return prng.uniform(prng.fold_in(both, lv), ())

    def draws_spmd(self, keys: torch.Tensor, rank: int
                   ) -> torch.Tensor | None:
        """f32 ``[..., 3, K, L]``: the mesh path's uniforms for root keys
        ``[..., 2]`` on rank ``rank`` — this rank's sketch update (row 0,
        from ``fold_in(kq, rank)``), the merge of the gathered quantile
        summaries (row 1, from ``fold_in(kq, 0x4D52)``) and of the
        gathered windowed rings (row 2, that key folded with
        ``0x574D``), as the reference's ``evaluate_spmd`` draws them.
        ``None`` when no spec draws."""
        if not self._levels:
            return None
        dev = keys.device
        kq = prng.fold_in(prng.fold_in(keys, _QUERY_KEY_TAG)[..., None, :],
                          torch.arange(self.k, device=dev))
        k_merge = prng.fold_in(kq, _MERGE_KEY_TAG)
        rows = [prng.fold_in(kq, rank), k_merge,
                prng.fold_in(k_merge, _WINDOW_MERGE_TAG)]
        lv = torch.arange(self._levels, device=dev)
        both = torch.stack(rows, dim=-3)[..., None, :]
        return prng.uniform(prng.fold_in(both, lv), ())

    def _const(self, name: str, make, device) -> torch.Tensor:
        key = (name, str(device))
        if key not in self._consts:
            self._consts[key] = torch.as_tensor(make(), device=device)
        return self._consts[key]

    def shared(self, batch: IntervalBatch, res: SampleResult):
        """The slot-independent part of ``evaluate``: each item's HT
        weight and the one moments pass of the CLT queries."""
        sel = res.selected
        x = self.num_strata
        w_item = (res.meta.weight[batch.stratum.to(torch.int64)
                                  .clamp(0, x - 1)] * sel.float())
        return (w_item,) + err.stratum_moments(batch.value, batch.stratum,
                                               sel, x)

    def evaluate(self, draws, batch: IntervalBatch, res: SampleResult,
                 state: tuple, shared=None) -> tuple:
        """(state', answers f32[n_out], bounds f32[n_out]) for one window;
        ``draws`` is ``self.draws(key)`` for this window's root key."""
        if shared is None:
            shared = self.shared(batch, res)
        w_item, y, s1, s2 = shared
        dev = batch.value.device
        x = self.num_strata
        # Σ Y_i·W_i: where a count and a mean share it, the reference's
        # compiled program computes the products once and adds them
        # without contraction; alone, each takes it with FMAs.
        ht_total = (seq_sum(y * res.meta.weight)[..., 0]
                    if self._shared_ht_total else None)
        outs, bnds, new_state = [], [], []
        for i, sp in enumerate(self.specs):
            st = state[i]
            if sp.kind == "sum":
                q = err.approx_sum_from_moments(y, s1, s2, res.meta)
                a, b, st2 = q.estimate[None], q.bound(2.0)[None], ()
            elif sp.kind == "count":
                # The HT count is exact per stratum given the metadata.
                a = (fma_dot(y, res.meta.weight) if ht_total is None
                     else ht_total)[None]
                b, st2 = torch.zeros(1, dtype=torch.float32, device=dev), ()
            elif sp.kind == "mean":
                q = err.approx_mean_from_moments(y, s1, s2, res.meta,
                                                 ht_total)
                a, b, st2 = q.estimate[None], q.bound(2.0)[None], ()
            elif sp.kind == "histogram":
                edges = self._const(
                    sp.name, lambda sp=sp: _linspace_const(sp.lo, sp.hi,
                                                           sp.bins + 1), dev)
                q = weighted_histogram(batch, res, x, edges)
                a, b, st2 = q.estimate, q.bound(2.0), ()
            elif sp.kind == "quantile":
                qs = self._const(sp.name, lambda sp=sp: np.asarray(
                    sp.qs, np.float32), dev)
                st2 = sketches.quantile_update(draws[0, i], st, batch.value,
                                               w_item)
                a = sketches.quantile_query(st2, qs)
                b = torch.ones_like(qs) * st2.rank_error_bound
            elif sp.kind in ("heavy_hitters", "decayed_heavy_hitters"):
                keys = sketches.hh_item_key(batch.value)
                if sp.kind == "heavy_hitters":
                    st2 = sketches.hh_update(st, keys, w_item)
                else:
                    st2 = sketches.hh_decayed_update(st, keys, w_item,
                                                     sp.decay)
                eps_w = sketches.hh_error_bound(sp.width, st2.total_weight)
                a = torch.cat([st2.key.float(), st2.est])
                b = torch.cat([st2.est.new_zeros(sp.k),
                               st2.est.new_ones(sp.k) * eps_w])
            elif sp.kind == "windowed_quantile":
                # one window → one ring slot; the query-time merge over
                # the last `window` slots answers "last N windows".
                qs = self._const(sp.name, lambda sp=sp: np.asarray(
                    sp.qs, np.float32), dev)
                st2 = sketches.windowed_quantile_update(
                    draws[0, i], st, batch.value, w_item)
                merged = sketches.windowed_quantile_merged(draws[1, i], st2)
                a = sketches.quantile_query(merged, qs)
                b = torch.ones_like(qs) * merged.rank_error_bound
            else:  # pragma: no cover — the registry validates kinds
                raise AssertionError(sp.kind)
            outs.append(a.float())
            bnds.append(b.float())
            new_state.append(st2)
        return tuple(new_state), torch.cat(outs), torch.cat(bnds)

    def spmd_share(self, res: SampleResult, y, mesh):
        """This shard's share ``Σc_src / Σ_ranks Σc_src`` of the window's
        estimated population: the MEAN's merge weight."""
        total_local = seq_sum(y * res.meta.weight)[..., 0]
        return total_local / torch.clamp_min(mesh.psum(total_local), 1.0)

    def evaluate_spmd(self, draws, batch: IntervalBatch, res: SampleResult,
                      state: tuple, mesh, shared=None, share=None) -> tuple:
        """``evaluate`` on the mesh: ``batch``/``res`` are this rank's
        shard and sample, ``state`` its own sketches, ``draws``
        ``self.draws_spmd(key, mesh.rank)`` for the window's root key.
        Returns ``(state', answers, bounds)``: the state is this rank's,
        the answers and bounds the same bits on every rank, from merged
        summaries only:

        * sum/mean: per-rank estimate and variance summed over ranks (the
          mean re-weighted by each shard's population ``share``);
        * count: the pre-sampling counts ``Σ c_i·W^in_i``, exact integers,
          so the answer is the same at every rank count;
        * histogram: per-bin estimates and variances summed;
        * sketches: updated locally, then gathered and merged
          (``quantile_merge_stacked``; count-min tables summed and the
          candidate keys gathered for one top-k refresh)."""
        if shared is None:
            shared = self.shared(batch, res)
        w_item, y, s1, s2 = shared
        if share is None:
            share = self.spmd_share(res, y, mesh)
        dev = batch.value.device
        x = self.num_strata
        psum = mesh.psum
        # Σ Y_i·W_i feeds the mean and, unrounded by FMAs, the share
        ht_total = seq_sum(y * res.meta.weight)[..., 0]
        outs, bnds, new_state = [], [], []
        for i, sp in enumerate(self.specs):
            st = state[i]
            if sp.kind == "sum":
                q = err.approx_sum_from_moments(y, s1, s2, res.meta)
                a = psum(q.estimate)[None]
                b, st2 = 2.0 * sqrt_rn(psum(q.variance))[None], ()
            elif sp.kind == "count":
                # exact: C_i·W^in_i needs no sample, and sums of integer
                # f32s are the same in every order and split
                a = psum((res.c * batch.meta.weight).sum())[None]
                b, st2 = torch.zeros(1, dtype=torch.float32, device=dev), ()
            elif sp.kind == "mean":
                q = err.approx_mean_from_moments(y, s1, s2, res.meta,
                                                 ht_total)
                a = psum(q.estimate * share)[None]
                b = 2.0 * sqrt_rn(psum(q.variance * share * share))[None]
                st2 = ()
            elif sp.kind == "histogram":
                edges = self._const(
                    sp.name, lambda sp=sp: _linspace_const(sp.lo, sp.hi,
                                                           sp.bins + 1), dev)
                q = weighted_histogram(batch, res, x, edges)
                a = psum(q.estimate)
                b, st2 = 2.0 * sqrt_rn(psum(q.variance)), ()
            elif sp.kind == "quantile":
                qs = self._const(sp.name, lambda sp=sp: np.asarray(
                    sp.qs, np.float32), dev)
                st2 = sketches.quantile_update(draws[0, i], st, batch.value,
                                               w_item)
                g = sketches.QuantileSketch(
                    *(mesh.all_gather(v) for v in st2))
                merged = sketches.quantile_merge_stacked(draws[1, i], g)
                a = sketches.quantile_query(merged, qs)
                b = torch.ones_like(qs) * merged.rank_error_bound
            elif sp.kind in ("heavy_hitters", "decayed_heavy_hitters"):
                keys = sketches.hh_item_key(batch.value)
                if sp.kind == "heavy_hitters":
                    st2 = sketches.hh_update(st, keys, w_item)
                else:
                    # decay is linear: Σ of decayed tables = decayed Σ
                    st2 = sketches.hh_decayed_update(st, keys, w_item,
                                                     sp.decay)
                # counts are linear: summed; only the k candidate keys
                # are gathered
                g_counts = psum(st2.counts)
                g_keys = mesh.all_gather(st2.key, tiled=True)
                mk, me = sketches._refresh_topk(g_counts, g_keys, sp.k)
                eps_w = sketches.hh_error_bound(sp.width,
                                                torch.sum(g_counts[0]))
                a = torch.cat([mk.float(), me])
                b = torch.cat([me.new_zeros(sp.k), me.new_ones(sp.k) * eps_w])
            elif sp.kind == "windowed_quantile":
                qs = self._const(sp.name, lambda sp=sp: np.asarray(
                    sp.qs, np.float32), dev)
                st2 = sketches.windowed_quantile_update(
                    draws[0, i], st, batch.value, w_item)
                # every rank's ring, rank × slot flattened into one stack
                g = [mesh.all_gather(v) for v in st2[:4]]
                stacked = sketches.QuantileSketch(
                    value=g[0].reshape((-1,) + g[0].shape[-2:]),
                    weight=g[1].reshape((-1,) + g[1].shape[-2:]),
                    compactions=g[2].reshape(-1), err_q2=g[3].reshape(-1))
                merged = sketches.quantile_merge_stacked(draws[2, i],
                                                         stacked)
                a = sketches.quantile_query(merged, qs)
                b = torch.ones_like(qs) * merged.rank_error_bound
            else:  # pragma: no cover — the registry validates kinds
                raise AssertionError(sp.kind)
            outs.append(a.float())
            bnds.append(b.float())
            new_state.append(st2)
        return tuple(new_state), torch.cat(outs), torch.cat(bnds)

    def exact_answers(self, values: np.ndarray,
                      strata: np.ndarray | None = None) -> np.ndarray:
        """Host-side exact answers over the full stream, layout-aligned:
        quantile slots hold the ``inverted_cdf`` order statistics (the
        sketch's "first value whose rank exceeds q·W" rule); heavy-hitter
        and windowed/decayed slots are NaN (their truth is relative to
        the sketch's own keys or to the recent stream)."""
        values = np.asarray(values, np.float64)
        out = np.zeros((self.n_out,), np.float64)
        for sp in self.specs:
            o, w, _ = self._layout[sp.name]
            if sp.kind == "sum":
                out[o] = values.sum()
            elif sp.kind == "count":
                out[o] = len(values)
            elif sp.kind == "mean":
                out[o] = values.mean() if len(values) else 0.0
            elif sp.kind == "histogram":
                edges = np.linspace(sp.lo, sp.hi, sp.bins + 1)
                ix = np.clip(np.searchsorted(edges, values, side="right") - 1,
                             0, sp.bins - 1)
                out[o:o + w] = np.bincount(ix, minlength=sp.bins)
            elif sp.kind == "quantile":
                out[o:o + w] = np.quantile(values, np.asarray(sp.qs),
                                           method="inverted_cdf")
            else:
                out[o:o + w] = np.nan
        return out


class MultiTenantPlan:
    """K tenants' registries answered from one window sample in one root
    step. Each tenant keeps its own ``CompiledQueryPlan`` and draws from
    the same root key, so its answers, bounds and sketch state are those
    of a single-tenant plan of its registry; the flat vector is the
    tenants' vectors concatenated in registration order, and ``layout()``
    names its slots ``"tenant/query"``. It has the plan protocol
    (``draws``, ``evaluate``, ``init_state``, ``layout``, ``answer``, and
    on the mesh ``draws_spmd``, ``evaluate_spmd``)."""

    def __init__(self, tenants, num_strata: int):
        """``tenants``: ordered ``(name, (QuerySpec, ...))`` pairs."""
        tenants = tuple((str(n), tuple(specs)) for n, specs in tenants)
        if not tenants:
            raise ValueError("cannot compile an empty tenant list")
        names = [n for n, _ in tenants]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate tenant names: {dup}")
        self.tenant_names = tuple(names)
        self.num_strata = int(num_strata)
        self.plans = tuple(CompiledQueryPlan(specs, num_strata)
                           for _, specs in tenants)
        self._offsets = {}
        off = 0
        for name, plan in zip(self.tenant_names, self.plans):
            self._offsets[name] = off
            off += plan.n_out
        self.n_out = off

    @property
    def k(self) -> int:
        return sum(p.k for p in self.plans)

    def plan_for(self, tenant: str) -> CompiledQueryPlan:
        if tenant not in self._offsets:
            raise KeyError(f"unknown tenant {tenant!r}; "
                           f"registered: {list(self.tenant_names)}")
        return self.plans[self.tenant_names.index(tenant)]

    def tenant_slice(self, tenant: str) -> tuple[int, int]:
        """(offset, width) of one tenant's block in the flat vector."""
        return self._offsets[tenant], self.plan_for(tenant).n_out

    def layout(self) -> dict[str, tuple[int, int, str]]:
        """``"tenant/query"`` → (absolute offset, width, kind)."""
        out = {}
        for name, plan in zip(self.tenant_names, self.plans):
            base = self._offsets[name]
            for q, (o, w, kind) in plan.layout().items():
                out[f"{name}/{q}"] = (base + o, w, kind)
        return out

    def answer(self, vec, name: str) -> np.ndarray:
        """One ``"tenant/query"`` answer out of a flat (host) vector."""
        o, w, _ = self.layout()[name]
        return _host(vec)[..., o:o + w]

    def tenant_answers(self, vec, tenant: str) -> np.ndarray:
        o, w = self.tenant_slice(tenant)
        return _host(vec)[..., o:o + w]

    def init_state(self, device=None) -> tuple:
        return tuple(p.init_state(device) for p in self.plans)

    def draws(self, keys: torch.Tensor) -> tuple:
        """Per tenant, its plan's ``draws`` for the same root keys."""
        return tuple(p.draws(keys) for p in self.plans)

    def draws_spmd(self, keys: torch.Tensor, rank: int) -> tuple:
        return tuple(p.draws_spmd(keys, rank) for p in self.plans)

    def evaluate(self, draws, batch: IntervalBatch, res: SampleResult,
                 state: tuple) -> tuple:
        """(state', answers f32[n_out], bounds f32[n_out]): every tenant's
        plan on the same window sample and root key."""
        return self._concat([p.evaluate(dr, batch, res, st) for p, dr, st
                             in zip(self.plans, draws, state)])

    def evaluate_spmd(self, draws, batch: IntervalBatch, res: SampleResult,
                      state: tuple, mesh, share=None) -> tuple:
        """``evaluate`` on the mesh: every tenant's plan's
        ``evaluate_spmd`` on the same root key (``share`` the mean's merge
        weight when the caller has it)."""
        return self._concat([p.evaluate_spmd(dr, batch, res, st, mesh,
                                             share=share)
                             for p, dr, st in zip(self.plans, draws, state)])

    @staticmethod
    def _concat(parts) -> tuple:
        states, outs, bnds = zip(*parts)
        return tuple(states), torch.cat(outs), torch.cat(bnds)

    def exact_answers(self, values: np.ndarray,
                      strata: np.ndarray | None = None) -> np.ndarray:
        return np.concatenate([p.exact_answers(values, strata)
                               for p in self.plans])


def _host(vec) -> np.ndarray:
    if torch.is_tensor(vec):
        return vec.detach().cpu().numpy()
    return np.asarray(vec)


def _tree_map(fn, *trees):
    """Map ``fn`` over the tensor leaves of nested tuples/NamedTuples."""
    first = trees[0]
    if torch.is_tensor(first):
        return fn(*trees)
    out = [_tree_map(fn, *parts) for parts in zip(*trees)]
    return type(first)(*out) if hasattr(first, "_fields") else tuple(out)


def slot_bucket(n: int) -> int:
    """Smallest power-of-two slot count ≥ n (no floor)."""
    n = max(int(n), 1)
    b = 1
    while b < n:
        b *= 2
    return b


def canonical_signature(specs) -> tuple[QuerySpec, ...]:
    """Name-free shape signature of a registry: the specs with names
    canonicalized to ``q0, q1, ...``. Tenants with one signature share
    one slot group."""
    return tuple(dataclasses.replace(sp, name=f"q{i}")
                 for i, sp in enumerate(specs))


class SlotPlanCore:
    """Per shape-signature group, one canonical template
    ``CompiledQueryPlan`` evaluated over ``n_slots`` rows of stacked
    sketch state plus a per-slot active mask. Tenant names never enter
    this object; routing lives on ``SlottedTenantPlan``.

    The slot-independent work (HT weights, the moments pass) runs once
    per group and window; each slot then folds its sketches. An active
    slot's answers and state are those of an unslotted plan; an inactive
    slot freezes at its state and answers zeros."""

    def __init__(self, groups, num_strata: int):
        """``groups``: ordered ``(canonical_specs, n_slots)`` pairs."""
        self.num_strata = int(num_strata)
        self.groups = tuple((CompiledQueryPlan(sig, num_strata), int(n))
                            for sig, n in groups)
        self._offsets = []
        off = 0
        for tmpl, n in self.groups:
            self._offsets.append(off)
            off += n * tmpl.n_out
        self.n_out = off

    def group_offset(self, gi: int) -> int:
        return self._offsets[gi]

    def init_state(self, device=None) -> tuple:
        """All slots inactive, all rows at the template's init state."""
        out = []
        for tmpl, n in self.groups:
            row = tmpl.init_state(device)
            stacked = _tree_map(
                lambda v, n=n: v.expand((n,) + v.shape).clone(), row)
            out.append((torch.zeros(n, dtype=torch.bool, device=device),
                        stacked))
        return tuple(out)

    def draws(self, keys: torch.Tensor) -> tuple:
        """Per group, ``template.draws(keys)``."""
        return tuple(tmpl.draws(keys) for tmpl, _ in self.groups)

    def draws_spmd(self, keys: torch.Tensor, rank: int) -> tuple:
        """Per group, ``template.draws_spmd(keys, rank)``."""
        return tuple(tmpl.draws_spmd(keys, rank) for tmpl, _ in self.groups)

    def evaluate(self, draws, batch: IntervalBatch, res: SampleResult,
                 state: tuple) -> tuple:
        """(state', padded answers f32[n_out], padded bounds f32[n_out])."""
        return self._eval(draws, batch, res, state,
                          lambda tmpl, dr, st, shared: tmpl.evaluate(
                              dr, batch, res, st, shared))

    def evaluate_spmd(self, draws, batch: IntervalBatch, res: SampleResult,
                      state: tuple, mesh, share=None) -> tuple:
        """``evaluate`` on the mesh (``CompiledQueryPlan.evaluate_spmd``
        per slot, ``share`` the mean's merge weight when the caller has
        it). Every slot, active or not, runs the same collectives on
        every rank, so the ranks stay in step."""
        return self._eval(draws, batch, res, state,
                          lambda tmpl, dr, st, shared: tmpl.evaluate_spmd(
                              dr, batch, res, st, mesh, shared, share))

    def _eval(self, draws, batch, res, state, eval_one) -> tuple:
        states, outs, bnds = [], [], []
        for (tmpl, n), (mask, st), dr in zip(self.groups, state, draws):
            shared = tmpl.shared(batch, res)
            rows, ans, bnd = [], [], []
            for s in range(n):
                old = _tree_map(lambda v, s=s: v[s], st)
                new, a, b = eval_one(tmpl, dr, old, shared)
                m = mask[s]
                rows.append(_tree_map(
                    lambda nw, od, m=m: torch.where(m, nw, od), new, old))
                ans.append(torch.where(m, a, 0.0))
                bnd.append(torch.where(m, b, 0.0))
            states.append((mask, _tree_map(lambda *r: torch.stack(r),
                                           *rows)))
            outs.extend(ans)
            bnds.extend(bnd)
        return tuple(states), torch.cat(outs), torch.cat(bnds)


# Canonical SlotPlanCore per (num_strata, ((signature, n_slots), ...)):
# the size-bucketed plan cache, as in the reference.
_CORE_CACHE: dict = {}
_CORE_STATS = {"builds": 0, "hits": 0}


def slot_plan_core(groups, num_strata: int) -> SlotPlanCore:
    key = (int(num_strata), tuple((tuple(sig), int(n)) for sig, n in groups))
    core = _CORE_CACHE.get(key)
    if core is None:
        core = SlotPlanCore(groups, num_strata)
        _CORE_CACHE[key] = core
        _CORE_STATS["builds"] += 1
    else:
        _CORE_STATS["hits"] += 1
    return core


def plan_cache_stats() -> dict:
    """{"builds": distinct plan shapes built, "hits": cache reuses}."""
    return dict(_CORE_STATS)


class SlottedTenantPlan:
    """Host-side routing over a cached ``SlotPlanCore``: maps live tenant
    names to (group, slot) and answers layout and slicing questions.

    The core answers the PADDED vector (``core.n_out``, every slot,
    inactive ones zero); the PUBLIC vector is the live tenants' blocks in
    admission order (``n_out``, ``layout()``, ``tenant_slice``).
    ``compact(arr)`` maps padded → public with one gather. With a single
    live tenant ``layout()`` uses plain query names; with several,
    ``"tenant/query"``."""

    def __init__(self, core: SlotPlanCore, entries):
        """``entries``: ordered ``(name, specs, group_idx, slot_idx)``."""
        self.core = core
        self.entries = tuple(entries)
        self.num_strata = core.num_strata
        self.tenant_names = tuple(e[0] for e in self.entries)
        if len(set(self.tenant_names)) != len(self.tenant_names):
            ns = list(self.tenant_names)
            dup = sorted({n for n in ns if ns.count(n) > 1})
            raise ValueError(f"duplicate tenant names: {dup}")
        self._by_name = {e[0]: e for e in self.entries}
        self._plan_cache: dict = {}
        self._slices = {}
        off = 0
        for name, _, gi, _si in self.entries:
            w = core.groups[gi][0].n_out
            self._slices[name] = (off, w)
            off += w
        self.n_out = off            # PUBLIC (compacted) width
        self._cols = None           # lazy padded→public column map

    @property
    def k(self) -> int:
        """Standing queries over the live tenants."""
        return sum(len(e[1]) for e in self.entries)

    @property
    def plans(self) -> tuple:
        """Per-live-tenant template plans (host-side views)."""
        return tuple(self.plan_for(t) for t in self.tenant_names)

    def plan_for(self, tenant: str) -> CompiledQueryPlan:
        if tenant not in self._by_name:
            raise KeyError(f"unknown tenant {tenant!r}; "
                           f"registered: {list(self.tenant_names)}")
        if tenant not in self._plan_cache:
            self._plan_cache[tenant] = CompiledQueryPlan(
                self._by_name[tenant][1], self.num_strata)
        return self._plan_cache[tenant]

    def padded_slice(self, tenant: str) -> tuple[int, int]:
        """(offset, width) of one tenant's slot block in the PADDED
        answer vector."""
        _, _, gi, si = self._by_name[tenant]
        tmpl, _n = self.core.groups[gi]
        return self.core.group_offset(gi) + si * tmpl.n_out, tmpl.n_out

    def tenant_slice(self, tenant: str) -> tuple[int, int]:
        """(offset, width) of one tenant's block in the PUBLIC vector."""
        if tenant not in self._slices:
            raise KeyError(f"unknown tenant {tenant!r}; "
                           f"registered: {list(self.tenant_names)}")
        return self._slices[tenant]

    def live_columns(self) -> np.ndarray:
        """Padded-vector column index of every public-vector slot."""
        if self._cols is None:
            cols = []
            for name in self.tenant_names:
                o, w = self.padded_slice(name)
                cols.extend(range(o, o + w))
            self._cols = np.asarray(cols, np.int64)
        return self._cols

    def compact(self, arr):
        """Gather a padded answers/bounds array (tensor or array) down to
        the public vector along the last axis."""
        if arr is None:
            return None
        cols = self.live_columns()
        if torch.is_tensor(arr):
            return arr[..., torch.as_tensor(cols, device=arr.device)]
        return np.asarray(arr)[..., cols]

    def layout(self) -> dict[str, tuple[int, int, str]]:
        out = {}
        single = len(self.tenant_names) == 1
        for name in self.tenant_names:
            base, _ = self.tenant_slice(name)
            for q, (o, w, kind) in self.plan_for(name).layout().items():
                label = q if single else f"{name}/{q}"
                out[label] = (base + o, w, kind)
        return out

    def answer(self, vec, name: str) -> np.ndarray:
        """One query's answer (``layout()``'s name) out of a flat PUBLIC
        (host) vector."""
        o, w, _ = self.layout()[name]
        return _host(vec)[..., o:o + w]

    def tenant_answers(self, vec, tenant: str) -> np.ndarray:
        """One tenant's block of a flat PUBLIC (host) vector."""
        o, w = self.tenant_slice(tenant)
        return _host(vec)[..., o:o + w]

    def init_state(self, device=None) -> tuple:
        """Core init state with this plan's live slots activated."""
        state = list(self.core.init_state(device))
        for _, _, gi, si in self.entries:
            state[gi][0][si] = True
        return tuple(state)

    def draws(self, keys):
        return self.core.draws(keys)

    def draws_spmd(self, keys, rank: int):
        return self.core.draws_spmd(keys, rank)

    def evaluate(self, draws, batch, res, state):
        return self.core.evaluate(draws, batch, res, state)

    def evaluate_spmd(self, draws, batch, res, state, mesh, share=None):
        return self.core.evaluate_spmd(draws, batch, res, state, mesh,
                                       share)

    def exact_answers(self, values, strata=None) -> np.ndarray:
        """Host-side exact answers in the PUBLIC layout."""
        return np.concatenate([self.plan_for(t).exact_answers(values, strata)
                               for t in self.tenant_names])

    def slot_manifest(self) -> dict:
        """JSON-able description of the slot configuration, which the
        checkpoint manifest records so that a restore into a differently
        churned pipeline fails loudly instead of mis-routing answers."""
        groups = []
        for gi, (tmpl, n) in enumerate(self.core.groups):
            sig = [f"{sp.kind}:{sp.out_width}" for sp in tmpl.specs]
            slots = {name: si for name, _, g, si in self.entries if g == gi}
            groups.append({"signature": sig, "n_slots": int(n),
                           "slots": slots})
        return {"groups": groups}

    def admit(self, name: str, specs) -> tuple:
        """→ ``(new_plan, transform)``: ``transform(qstate, slot_axis=0)``
        activates the new tenant's slot with its row reset to the
        template's init state (the slot may hold a retired tenant's frozen
        sketch); ``slot_axis=1`` edits a mesh rank's rows, whose leaves
        carry a leading rank axis. A tenant of
        a new signature opens a group of one slot; into a full group it
        doubles the group's slot bucket. The qstate given is left as it
        was."""
        name = str(name)
        specs = tuple(specs)
        if name in self._by_name:
            raise ValueError(f"tenant {name!r} already admitted")
        if not specs:
            raise ValueError(f"tenant {name!r} has an empty registry")
        sig = canonical_signature(specs)
        groups = [(tuple(t.specs), n) for t, n in self.core.groups]
        gi = next((i for i, (s, _) in enumerate(groups) if s == sig), None)
        if gi is None:
            gi, si, grow = len(groups), 0, 0
            groups.append((sig, slot_bucket(1)))
            core = slot_plan_core(groups, self.num_strata)
        else:
            used = {e[3] for e in self.entries if e[2] == gi}
            n_now = groups[gi][1]
            free = [s for s in range(n_now) if s not in used]
            if free:
                si, core, grow = free[0], self.core, 0
            else:
                si, grow = n_now, n_now   # the first slot of the padding
                groups[gi] = (sig, n_now * 2)
                core = slot_plan_core(groups, self.num_strata)
        tmpl, n = core.groups[gi]

        def transform(qstate, slot_axis: int = 0):
            dev = qstate[0][0].device
            row = tmpl.init_state(dev)
            # leading (rank) axes: () locally, (1,) for a mesh rank's rows
            lead = tuple(qstate[0][0].shape[:slot_axis])
            idx = (slice(None),) * slot_axis + (si,)
            qstate = list(qstate)
            if gi == len(qstate):
                mask = torch.zeros(lead + (n,), dtype=torch.bool, device=dev)
                st = _tree_map(
                    lambda v: v.expand(lead + (n,) + v.shape).clone(), row)
            else:
                mask, st = qstate[gi]
                if grow:
                    mask = torch.cat([mask, mask.new_zeros(lead + (grow,))],
                                     dim=slot_axis)
                    st = _tree_map(lambda a, v: torch.cat(
                        [a, v.expand(lead + (grow,) + v.shape)],
                        dim=slot_axis), st, row)
                else:
                    mask, st = mask.clone(), _tree_map(torch.clone, st)
                # reset the slot's row: admission must match a fresh compile
                _tree_map(lambda a, v: a[idx].copy_(v), st, row)
            mask[idx] = True
            qstate[gi:gi + 1] = [(mask, st)]
            return tuple(qstate)

        entries = self.entries + ((name, specs, gi, si),)
        return SlottedTenantPlan(core, entries), transform

    def retire(self, name: str) -> tuple:
        """→ ``(new_plan, transform)``: ``transform(qstate, slot_axis=0)``
        flips the slot's mask bit off. The row's state freezes in place (a bucket
        never shrinks; a later ``admit`` reuses the slot)."""
        if name not in self._by_name:
            raise KeyError(f"unknown tenant {name!r}; "
                           f"registered: {list(self.tenant_names)}")
        if len(self.entries) == 1:
            raise ValueError(
                f"cannot retire {name!r}: it is the last live tenant")
        _, _, gi, si = self._by_name[name]
        entries = tuple(e for e in self.entries if e[0] != name)

        def transform(qstate, slot_axis: int = 0):
            qstate = list(qstate)
            mask, st = qstate[gi]
            mask = mask.clone()
            mask[(slice(None),) * slot_axis + (si,)] = False
            qstate[gi] = (mask, st)
            return tuple(qstate)

        return SlottedTenantPlan(self.core, entries), transform


def build_slotted_plan(tenants, num_strata: int) -> SlottedTenantPlan:
    """Group tenants by canonical shape signature, pad each group to its
    slot bucket, and wrap the cached core with name routing. Slots are
    assigned in admission order within each group."""
    tenants = tuple((str(n), tuple(specs)) for n, specs in tenants)
    if not tenants:
        raise ValueError("cannot compile an empty tenant list")
    sigs: list = []
    members: list = []
    for name, specs in tenants:
        sig = canonical_signature(specs)
        try:
            gi = sigs.index(sig)
        except ValueError:
            gi = len(sigs)
            sigs.append(sig)
            members.append([])
        members[gi].append(name)
    groups = tuple((sig, slot_bucket(len(m)))
                   for sig, m in zip(sigs, members))
    core = slot_plan_core(groups, num_strata)
    slot_of = {name: (gi, si)
               for gi, m in enumerate(members) for si, name in enumerate(m)}
    entries = [(name, specs) + slot_of[name] for name, specs in tenants]
    return SlottedTenantPlan(core, tuple(entries))


def tenant_rel_errors(plan, answers_row, bounds_row,
                      default_tenant: str = "default") -> dict[str, float]:
    """Per-tenant measured relative error of one window: the worst
    relative ±2σ bound over each tenant's CLT queries (sum/mean).
    Sketch queries do not vote; a tenant with no CLT query reports 0.0.
    A plain ``CompiledQueryPlan`` attributes everything to
    ``default_tenant``."""
    answers_row = _host(answers_row)
    bounds_row = _host(bounds_row)
    out = {t: 0.0 for t in
           (plan.tenant_names if hasattr(plan, "tenant_names")
            else (default_tenant,))}
    for tenant, off in tenant_clt_slots(plan, default_tenant):
        est = abs(float(answers_row[..., off]))
        rel = float(bounds_row[..., off]) / max(est, 1e-9)
        out[tenant] = max(out[tenant], rel)
    return out


def tenant_clt_slots(plan, default_tenant: str = "default"):
    """Yield ``(tenant, public_offset)`` for every CLT (sum/mean) query
    slot — the tenant-attribution rule."""
    multi = hasattr(plan, "tenant_names")
    names = plan.tenant_names if multi else (default_tenant,)
    for name, (off, _, kind) in plan.layout().items():
        if kind not in ("sum", "mean"):
            continue
        tenant = name.split("/", 1)[0] if (multi and "/" in name) \
            else names[0]
        yield tenant, off
