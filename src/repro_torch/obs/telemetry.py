"""In-graph epoch telemetry: cumulative counters carried in the state.

The counterpart of the ``EpochTelemetry`` leaf of
``repro.obs.telemetry``: the scan tick fills the counters from
quantities it computes anyway (flush sizes, forwarded counts, the root
sampler's per-stratum ``c``/``y``), draws no randomness, and so leaves
samples and answers bitwise the same with telemetry on or off.
``snapshot`` reads them back with the derived signals,
``tenant_rel_bounds`` attributes them per tenant and ``reset`` zeroes
them. Host-side counters the device cannot see (the serve plane's
straggler deadlines, ``runtime.straggler``) fold into the same leaves
between epochs through ``fold_stragglers`` and ``StragglerMonitor``: a
state edit of two int32 scalars on the state's device.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.runtime.straggler import (DeadlineTracker, StragglerConfig,
                                           calibrate_weights)


class EpochTelemetry(NamedTuple):
    """Cumulative counters, the reference's fields:

    ``items_in``/``items_kept`` f32[n_levels] — items offered at each
        level's flush vs. items forwarded (root: selected).
    ``flushes``/``saturation_hits`` i32[n_levels] — non-empty flushes,
        and those where the level kept every offered item.
    ``stratum_in``/``stratum_kept`` f32[X] — the root's ``c`` and ``y``.
    ``windows`` i32[] — flushed root windows.
    ``root_sum``/``root_sum_var`` f32[] — Σ window SUM estimates and
        variances; ``2·√(Σ var)`` is the realized ±2σ bound.
    ``slot_rel_bound_sum`` f32[n_slots] — Σ over flushed windows of each
        slot's relative bound ``bound/max(|answer|, 1e-9)``, one slot per
        column of the tenant plan's padded answer vector (``n_out`` of its
        core; empty without tenants).
    ``merge_bytes`` f32[] — sketch-summary bytes shipped across the mesh
        (``api.spmd``: windows × ``summary_bytes_per_window``); zero on a
        single device.
    ``late_shards``/``widened_windows`` i32[] — host-folded straggler
        accounting (see ``StragglerMonitor``).
    """

    items_in: Any
    items_kept: Any
    flushes: Any
    saturation_hits: Any
    stratum_in: Any
    stratum_kept: Any
    windows: Any
    root_sum: Any
    root_sum_var: Any
    slot_rel_bound_sum: Any
    merge_bytes: Any
    late_shards: Any
    widened_windows: Any

    @staticmethod
    def create(n_levels: int, num_strata: int, n_slots: int = 0,
               device=None) -> "EpochTelemetry":
        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        f32, i32 = torch.float32, torch.int32
        return EpochTelemetry(
            items_in=z((n_levels,), f32), items_kept=z((n_levels,), f32),
            flushes=z((n_levels,), i32), saturation_hits=z((n_levels,), i32),
            stratum_in=z((num_strata,), f32),
            stratum_kept=z((num_strata,), f32),
            windows=z((), i32), root_sum=z((), f32), root_sum_var=z((), f32),
            slot_rel_bound_sum=z((n_slots,), f32), merge_bytes=z((), f32),
            late_shards=z((), i32), widened_windows=z((), i32))


def _leaf(state) -> "EpochTelemetry | None":
    """The telemetry leaf of a ``PipelineState``, a ``TreeState`` or a
    bare ``EpochTelemetry``."""
    if isinstance(state, EpochTelemetry):
        return state
    tree = getattr(state, "tree", None)
    if tree is not None:
        state = tree
    tel = getattr(state, "telemetry", ())
    return tel if isinstance(tel, EpochTelemetry) else None


def snapshot(state) -> dict | None:
    """Host-readable counters plus per-level and per-stratum effective
    fractions and the realized ±2σ SUM bound; ``None`` when telemetry is
    off."""
    tel = _leaf(state)
    if tel is None:
        return None
    h = {f: np.asarray(v.detach().cpu())
         for f, v in zip(EpochTelemetry._fields, tel)}
    eps = 1e-9
    levels = []
    for l in range(h["items_in"].shape[0]):
        i_in, i_kept = float(h["items_in"][l]), float(h["items_kept"][l])
        levels.append({
            "items_in": i_in, "items_kept": i_kept,
            "flushes": int(h["flushes"][l]),
            "saturation_hits": int(h["saturation_hits"][l]),
            "effective_fraction": i_kept / max(i_in, eps),
        })
    strata = []
    for s in range(h["stratum_in"].shape[0]):
        s_in, s_kept = float(h["stratum_in"][s]), float(h["stratum_kept"][s])
        strata.append({"items_in": s_in, "items_kept": s_kept,
                       "effective_fraction": s_kept / max(s_in, eps)})
    windows = int(h["windows"])
    total = float(h["root_sum"])
    bound = 2.0 * float(np.sqrt(max(float(h["root_sum_var"]), 0.0)))
    return {
        "levels": levels,
        "strata": strata,
        "windows": windows,
        "sum_estimate": total,
        "bound_2sigma": bound,
        "rel_bound_2sigma": bound / max(abs(total), eps),
        "slot_rel_bound_mean": h["slot_rel_bound_sum"] / max(windows, 1),
        "merge_bytes": float(h["merge_bytes"]),
        "late_shards": int(h["late_shards"]),
        "widened_windows": int(h["widened_windows"]),
    }


def tenant_rel_bounds(pipeline, state) -> dict[str, float]:
    """Per-tenant realized error bound from the telemetry leaves: each
    tenant's worst CLT (sum/mean) slot of the window-mean relative bounds
    (the attribution rule of ``query.compiler.tenant_rel_errors``, over
    the cumulative trajectory instead of one window)."""
    from repro_torch.query.compiler import tenant_clt_slots

    snap = snapshot(state)
    plan = getattr(pipeline, "plan", None)
    if snap is None or plan is None:
        return {}
    public = plan.compact(np.asarray(snap["slot_rel_bound_mean"]))
    out = {t: 0.0 for t in plan.tenant_names}
    for tenant, off in tenant_clt_slots(plan):
        out[tenant] = max(out[tenant], float(public[off]))
    return out


def reset(state):
    """Zero a state's telemetry counters (same shapes, a new leaf):
    drivers call this after warmup so the counters cover only the
    measured stream. No-op when telemetry is off."""
    tel = _leaf(state)
    if tel is None:
        return state
    return _replace_leaf(state,
                         EpochTelemetry(*(torch.zeros_like(v) for v in tel)))


def _replace_leaf(state, tel: EpochTelemetry):
    tree = getattr(state, "tree", None)
    if tree is not None:
        return state._replace(tree=tree._replace(telemetry=tel))
    return state._replace(telemetry=tel)


def fold_stragglers(state, late_shards: int, widened_windows: int):
    """Fold host-side straggler accounting into the telemetry leaves: an
    add to two int32 scalars on the state's device, the leaves keeping
    their shapes. No-op when telemetry is off or there is nothing to
    add."""
    tel = _leaf(state)
    if tel is None or (not late_shards and not widened_windows):
        return state
    tel = tel._replace(
        late_shards=tel.late_shards + int(late_shards),
        widened_windows=tel.widened_windows + int(widened_windows))
    return _replace_leaf(state, tel)


class StragglerMonitor:
    """``runtime.straggler``'s deadline accounting wired into the
    telemetry plane.

    :meth:`observe` takes one window's per-shard arrival latencies and
    returns ``DeadlineTracker``'s present-mask; it accumulates a
    late-shard count and a widened-window count (a window published with
    absent shards has its bounds widened by Eq. 9's ``1/α``).
    :meth:`fold_into` moves the deltas since the last fold into a state's
    telemetry leaves; the running totals serve the metrics either way."""

    def __init__(self, num_shards: int, cfg=None):
        self.cfg = cfg or StragglerConfig()
        self.tracker = DeadlineTracker(int(num_shards), self.cfg)
        self.late_shards_total = 0
        self.widened_windows_total = 0
        self._pending_late = 0
        self._pending_widened = 0

    def observe(self, shard_latencies) -> np.ndarray:
        """Record one window's per-shard latencies; returns the
        present-mask (all true below quorum)."""
        present = self.tracker.observe(
            np.asarray(shard_latencies, np.float64))
        late = int((~present).sum())
        self.late_shards_total += late
        self._pending_late += late
        if late > 0:
            self.widened_windows_total += 1
            self._pending_widened += 1
        return present

    def calibrate(self, weight: np.ndarray,
                  present: np.ndarray) -> np.ndarray:
        """Eq. 9 recalibration of the arrived shards' weights
        (``straggler.calibrate_weights``)."""
        return calibrate_weights(weight, present)

    def fold_into(self, state):
        """Apply the deltas accumulated since the last fold to a state's
        telemetry leaves; returns the (possibly unchanged) state."""
        late, widened = self._pending_late, self._pending_widened
        self._pending_late = self._pending_widened = 0
        return fold_stragglers(state, late, widened)
