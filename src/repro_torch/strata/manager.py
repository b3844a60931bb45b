"""Online stratum split/merge — adaptive stratification under drift.

Static strata starve under heavy-tailed key skew (Fig. 11c): when one
key carries 80% of the arrivals and another 0.01%, a fixed key→stratum
map wastes reservoir rows on near-empty strata while hot strata
saturate. Following the decentralized-stratified-sampling line of work
(PAPERS.md), the ``StratumManager`` watches per-key arrival rates and,
at epoch boundaries, *splits* slots hotter than ``split_occupancy``×
their fair share (moving a subset of their keys onto a spare slot) and
*merges* slots starved below ``merge_occupancy``× of it.

The port's own copy of ``repro.strata.manager``. Everything is a state
edit at a fixed shape:

* the key→stratum **routing table** is an i32 ``[num_keys]`` leaf of the
  ``TreeState`` (``core.window.TreeState.route``) — the scan tick
  gathers ingest keys through it, so a new table needs no new program;
* the Eq. 9 calibration metadata (sticky ``W^in``/``C^in`` sets and the
  in-flight interval accumulators) is **remapped** with the table
  (:func:`remap_tree_state`), so published bounds stay honest across a
  remap: a split hands the child slot its proportional share of the
  parent's counts (same ``C^in/c`` ratio on both sides), a merge
  combines counts by sum and weights by count-weighted mean — the same
  merge law ``core.window`` applies to multi-message intervals.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StratumOp:
    """One committed routing edit. ``split`` moves ``keys`` (a strict
    subset of ``src``'s keys, carrying ``share`` of its observed mass)
    onto the spare slot ``dst``; ``merge`` folds ALL of ``src``'s keys
    into ``dst`` (``share`` == 1)."""

    kind: str          # "split" | "merge"
    src: int
    dst: int
    keys: tuple
    share: float


class StratumManager:
    """Occupancy-driven split/merge planner over a key→slot table.

    ``observe(key_counts)`` feeds one epoch's per-key arrival counts
    (an EMA with factor ``decay`` smooths noisy epochs);
    ``maybe_adapt()`` plans and commits routing edits, returning the
    committed :class:`StratumOp` list (empty = table unchanged). The
    caller then installs ``manager.route`` into the running state —
    via :func:`remap_tree_state` to keep Eq. 9 metadata honest."""

    def __init__(self, route, num_slots: int, *,
                 split_occupancy: float = 2.0,
                 merge_occupancy: float = 0.05,
                 decay: float = 0.5):
        self.route = np.asarray(route, np.int32).copy()
        if self.route.ndim != 1 or len(self.route) < 1:
            raise ValueError("route must be a non-empty 1-D table")
        self.num_keys = int(len(self.route))
        self.num_slots = int(num_slots)
        if not np.all((self.route >= 0) & (self.route < self.num_slots)):
            raise ValueError(f"route entries must lie in [0, {num_slots})")
        self.split_occupancy = float(split_occupancy)
        self.merge_occupancy = float(merge_occupancy)
        self.decay = float(decay)
        self.key_rate = np.zeros((self.num_keys,), np.float64)
        self.key_mass = np.zeros((self.num_keys,), np.float64)
        self.epochs_observed = 0
        self.ops_log: list[StratumOp] = []

    # ----------------------------------------------------------- inputs --
    def observe(self, key_counts, key_mass=None) -> None:
        """Fold one epoch's per-key arrival counts (and optionally the
        per-key Σ|value| mass) into the rate EMAs. Arrays shorter than
        ``num_keys`` are zero-padded (hosts typically produce both with
        ``np.bincount(keys, ...)``). Mass is the merge guard's signal:
        a key can be rare by count yet carry most of the window's value
        mass — folding it into another stratum would put its huge items
        behind a shared (possibly large) sampling weight, a variance
        cliff the count view cannot see."""
        def _pad(x):
            out = np.zeros((self.num_keys,), np.float64)
            src = np.asarray(x, np.float64).reshape(-1)[:self.num_keys]
            out[:len(src)] = src
            return out

        kc = _pad(key_counts)
        km = _pad(key_mass) if key_mass is not None else None
        if self.epochs_observed == 0:
            self.key_rate = kc
            self.key_mass = km if km is not None else self.key_mass
        else:
            self.key_rate = self.decay * self.key_rate + (1 - self.decay) * kc
            if km is not None:
                self.key_mass = (self.decay * self.key_mass
                                 + (1 - self.decay) * km)
        self.epochs_observed += 1

    def slot_occupancy(self) -> np.ndarray:
        """Observed arrival count mass per slot under the current table."""
        return np.bincount(self.route, weights=self.key_rate,
                           minlength=self.num_slots)[:self.num_slots]

    def slot_mass(self) -> np.ndarray:
        """Observed Σ|value| per slot (zeros when mass was never fed)."""
        return np.bincount(self.route, weights=self.key_mass,
                           minlength=self.num_slots)[:self.num_slots]

    # --------------------------------------------------------- planning --
    def plan(self) -> list[StratumOp]:
        """Plan (without committing) this epoch's split/merge ops."""
        occ = self.slot_occupancy().astype(np.float64)
        route = self.route.copy()
        total = float(occ.sum())
        if total <= 0.0:
            return []
        ops: list[StratumOp] = []

        # Merges first: starved slots fold into the lightest other active
        # slot, freeing capacity for the splits below. A slot is starved
        # only if BOTH its count occupancy AND its value-mass share are
        # negligible — a one-item stratum carrying most of the window's
        # mass is the stratification payoff, not overhead.
        n_active = max(int(np.sum(occ > 0)), 1)
        fair = total / n_active
        mass = self.slot_mass()
        mass_total = float(mass.sum())
        for s in np.argsort(occ):
            s = int(s)
            if occ[s] <= 0.0 or occ[s] >= self.merge_occupancy * fair:
                continue
            if (mass_total > 0.0
                    and mass[s] / mass_total >= self.merge_occupancy):
                continue
            others = [t for t in range(self.num_slots)
                      if t != s and occ[t] > 0.0]
            if not others:
                break
            dst = int(min(others, key=lambda t: occ[t]))
            keys = tuple(int(k) for k in np.nonzero(route == s)[0])
            if not keys:
                continue
            ops.append(StratumOp("merge", src=s, dst=dst, keys=keys,
                                 share=1.0))
            route[list(keys)] = dst
            occ[dst] += occ[s]
            occ[s] = 0.0
            mass[dst] += mass[s]
            mass[s] = 0.0

        # Splits: hottest multi-key slots shed their lighter keys onto a
        # spare slot (a slot no key routes to), aiming at a ~50/50 mass
        # split. Single-key slots cannot split — key granularity is the
        # floor of what routing can separate.
        spare = [t for t in range(self.num_slots)
                 if not np.any(route == t)]
        for s in np.argsort(-occ):
            s = int(s)
            if occ[s] < self.split_occupancy * fair:
                break
            keys = np.nonzero(route == s)[0]
            if len(keys) < 2 or not spare:
                continue
            order = keys[np.argsort(self.key_rate[keys])]
            moved, mass = [], 0.0
            for k in order[:-1]:                 # heaviest key stays put
                if mass >= occ[s] / 2.0:
                    break
                moved.append(int(k))
                mass += float(self.key_rate[k])
            if not moved:
                continue
            dst = spare.pop(0)
            share = mass / max(occ[s], 1e-12)
            ops.append(StratumOp("split", src=s, dst=dst,
                                 keys=tuple(moved), share=float(share)))
            route[moved] = dst
            occ[dst] = mass
            occ[s] -= mass
        return ops

    def maybe_adapt(self) -> list[StratumOp]:
        """Plan AND commit: applies the planned ops to ``self.route`` and
        returns them (empty list = the table is already balanced)."""
        ops = self.plan()
        for op in ops:
            self.route[list(op.keys)] = op.dst
        self.ops_log.extend(ops)
        return ops


def remap_tree_state(state, ops, route):
    """Apply committed ops to a ``TreeState`` as a same-shape edit.

    Installs the new routing table and remaps every level's Eq. 9
    metadata leaves (sticky ``w_in``/``c_in``, interval ``wc_acc``/
    ``c_acc``/``seen``) so the next flush's ``C^in/c`` calibration stays
    consistent with the remapped arrivals:

    * split ``s → d`` (share σ): slot ``d`` inherits ``W_s`` and σ of
      every count accumulator; slot ``s`` keeps ``1 − σ``.
    * merge ``s → d``: counts sum; ``W_d`` becomes the count-weighted
      mean (the merge law of ``core.window``); slot ``s`` resets to the
      identity metadata (W=1, C=0).

    The edit runs on the host in numpy f32, as the reference's does, and
    the new leaves go back to the state's device.
    """
    import torch

    dev = state.w_in[0].device
    new_route = torch.as_tensor(np.asarray(route, np.int32), device=dev)
    if not ops:
        return state._replace(route=new_route)

    def host(leaves, dtype):
        return [np.array(a.detach().cpu().numpy(), dtype) for a in leaves]

    n_levels = len(state.w_in)
    w_l = host(state.w_in, np.float32)
    c_l = host(state.c_in, np.float32)
    wc_l = host(state.wc_acc, np.float32)
    ca_l = host(state.c_acc, np.float32)
    sn_l = host(state.seen, bool)
    for op in ops:
        s, d = op.src, op.dst
        for lvl in range(n_levels):
            w, c, wc, ca, sn = (w_l[lvl], c_l[lvl], wc_l[lvl], ca_l[lvl],
                                sn_l[lvl])
            if op.kind == "split":
                sh = np.float32(op.share)
                w[:, d] = w[:, s]
                c[:, d] = c[:, s] * sh
                c[:, s] *= np.float32(1.0) - sh
                wc[:, d] = wc[:, s] * sh
                wc[:, s] *= np.float32(1.0) - sh
                ca[:, d] = ca[:, s] * sh
                ca[:, s] *= np.float32(1.0) - sh
                sn[:, d] = sn[:, s]
            else:                                   # merge s → d
                den = c[:, d] + c[:, s]
                merged = np.where(
                    den > 0,
                    (w[:, d] * c[:, d] + w[:, s] * c[:, s])
                    / np.maximum(den, np.float32(1e-30)),
                    w[:, d]).astype(np.float32)
                w[:, d] = merged
                c[:, d] = den
                wc[:, d] += wc[:, s]
                ca[:, d] += ca[:, s]
                sn[:, d] |= sn[:, s]
                w[:, s] = 1.0
                c[:, s] = 0.0
                wc[:, s] = 0.0
                ca[:, s] = 0.0
                sn[:, s] = False

    def dev_leaves(arrs):
        return tuple(torch.as_tensor(a, device=dev) for a in arrs)

    return state._replace(
        route=new_route, w_in=dev_leaves(w_l), c_in=dev_leaves(c_l),
        wc_acc=dev_leaves(wc_l), c_acc=dev_leaves(ca_l),
        seen=dev_leaves(sn_l))
