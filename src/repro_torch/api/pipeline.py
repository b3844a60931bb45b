"""``compile(spec, device=...) → CompiledPipeline`` — the port's runtime.

The counterpart of ``repro.api.pipeline`` for the tenant-free pipeline:

* ``init()`` → ``PipelineState``: every level's buffers on the device
  plus the next global tick.
* ``run_epoch(state, key, values, strata, counts, budgets)`` →
  ``(state', WindowAnswers)``: ``T`` ticks of the scan engine
  (``core.tree``). The tick counter is read back once per epoch and
  nothing inside the tick loop waits for the device.
* ``step(...)``: ``run_epoch`` with ``T = 1``.

The pipeline runs on a CUDA device unless ``device="cpu"`` is asked for
(see ``repro_torch.device``). ``budgets`` are per-level sample sizes,
clamped to the provisioned ceilings.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.api import spec as specmod
from repro_torch.api.spec import PipelineSpec, SpecError
from repro_torch.core import prng, sampling
from repro_torch.core import tree as T
from repro_torch.core.window import TreeState
from repro_torch.device import resolve_device


class PipelineState(NamedTuple):
    """The hierarchy's buffers (``core.window.TreeState``) plus the next
    global tick (i32 scalar on the device)."""

    tree: TreeState
    tick: Any


class WindowAnswers(NamedTuple):
    """One epoch's stacked per-window outputs (leading axis = tick).
    ``ok`` masks ticks whose root window flushed items; ``answers`` and
    ``bounds`` are ``None`` (no standing queries in this port);
    ``n_forwarded`` is the per-(tick, level) forwarded-item count."""

    tick: Any
    ok: Any
    sum: Any
    sum_var: Any
    mean: Any
    mean_var: Any
    n_sampled: Any
    histogram: Any
    answers: Any
    bounds: Any
    n_forwarded: Any


class CompiledPipeline:
    """One ``PipelineSpec`` bound to one device (see the module doc)."""

    def __init__(self, spec: PipelineSpec, device: torch.device):
        r = specmod.resolve(spec)
        if spec.sampler.mode == "whs":
            sampling.get_backend(spec.sampler.backend)  # unported → raises
        self.spec = spec
        self.device = device
        self.fanin = list(spec.topology.fanin)
        self.num_strata = spec.topology.num_strata
        self.capacities = list(r.capacities)
        self.sample_sizes = list(r.sample_sizes)
        self.max_sample_sizes = list(r.max_sample_sizes)
        self.interval_ticks = list(r.interval_ticks)
        self.telemetry_enabled = spec.telemetry.enabled
        self.route_keys = spec.strata.num_keys
        self._tick_fn = T._build_scan_tick(
            self.fanin, self.capacities, self.max_sample_sizes,
            self.interval_ticks, self.num_strata, spec.sampler.allocation,
            spec.sampler.backend, spec.sampler.mode, r.p_level,
            spec.sampler.fraction, device, telemetry=self.telemetry_enabled)
        self._epoch_fn = T._build_epoch_fn(self._tick_fn, self.fanin,
                                           self.capacities)

    @property
    def default_key(self) -> torch.Tensor:
        """The spec-seeded key (``PRNGKey(spec.seed)``) on the device."""
        return prng.PRNGKey(self.spec.seed, device=self.device)

    def init(self, key=None) -> PipelineState:
        """Fresh state: empty buffers, identity metadata, tick 1. ``key``
        is accepted for symmetry with the reference (initialisation is
        deterministic)."""
        del key
        tel = ()
        if self.telemetry_enabled:
            from repro_torch.obs.telemetry import EpochTelemetry

            tel = EpochTelemetry.create(len(self.fanin), self.num_strata, 0,
                                        device=self.device)
        route = ()
        if self.route_keys:
            route = (torch.arange(self.route_keys, dtype=torch.int32,
                                  device=self.device) % self.num_strata)
        st = TreeState.create(self.fanin, self.capacities, self.num_strata,
                              device=self.device, telemetry=tel, route=route)
        return PipelineState(tree=st, tick=torch.tensor(
            1, dtype=torch.int32, device=self.device))

    def telemetry_snapshot(self, state: PipelineState) -> dict | None:
        """Host-readable telemetry (``None`` when telemetry is off)."""
        from repro_torch.obs.telemetry import snapshot

        return snapshot(state)

    def clamp_budgets(self, budgets) -> list[float]:
        """Per-level budgets clamped to [1, ceiling]: the buffers upstream
        were sized for the ceilings."""
        if budgets is None:
            budgets = self.sample_sizes
        budgets = list(budgets)
        if len(budgets) != len(self.fanin):
            raise SpecError(
                f"budgets must have one entry per level: got "
                f"{len(budgets)} for {len(self.fanin)} levels")
        return [min(max(float(s), 1.0), float(m))
                for s, m in zip(budgets, self.max_sample_sizes)]

    def run_epoch(self, state: PipelineState, key, values, strata, counts,
                  budgets=None) -> tuple[PipelineState, WindowAnswers]:
        """Advance ``T = values.shape[0]`` ticks.

        ``values``/``strata`` are ``[T, fanin[0], width]`` tick-major
        padded ingest (``data.stream.batch_ingest`` builds it), ``counts``
        the ``[T, fanin[0]]`` item counts; numpy arrays or tensors, moved
        to the device in one copy each. As the reference's epoch is
        donated, ``state`` is consumed: its buffers may be reused for the
        returned state, so do not use the argument after the call.
        """
        dev = self.device
        values = torch.as_tensor(values, dtype=torch.float32, device=dev)
        strata = torch.as_tensor(strata, dtype=torch.int32, device=dev)
        counts = torch.as_tensor(counts, dtype=torch.int32, device=dev)
        epoch_ticks, n0 = counts.shape
        if n0 != self.fanin[0]:
            raise SpecError(f"ingest rows must match level-0 nodes: got "
                            f"{n0} for fanin {tuple(self.fanin)}")
        b = torch.tensor(self.clamp_budgets(budgets), dtype=torch.float32,
                         device=dev)
        key = torch.as_tensor(key, dtype=torch.int64, device=dev)
        t0 = int(state.tick)  # the one host read of the epoch
        tree, outs = self._epoch_fn(state.tree, key, t0, b, values, strata,
                                    counts)
        ts, ok, se, sv, me, mv, nsel, hist, n_fwd = outs
        wa = WindowAnswers(tick=ts, ok=ok, sum=se, sum_var=sv, mean=me,
                           mean_var=mv, n_sampled=nsel, histogram=hist,
                           answers=None, bounds=None, n_forwarded=n_fwd)
        return PipelineState(tree=tree, tick=state.tick + epoch_ticks), wa

    def step(self, state: PipelineState, key, values, strata, counts,
             budgets=None) -> tuple[PipelineState, WindowAnswers]:
        """One tick (``values`` ``[fanin[0], width]``)."""
        return self.run_epoch(state, key, torch.as_tensor(values)[None],
                              torch.as_tensor(strata)[None],
                              torch.as_tensor(counts)[None], budgets)

    def rows(self, wa: WindowAnswers) -> list[dict]:
        """Host-side result rows, one dict per flushed root window."""
        ts, ok, se, sv, me, mv, nsel, hist = (
            np.asarray(x.detach().cpu()) for x in
            (wa.tick, wa.ok, wa.sum, wa.sum_var, wa.mean, wa.mean_var,
             wa.n_sampled, wa.histogram))
        return [dict(tick=int(ts[i]), sum=float(se[i]),
                     sum_var=float(sv[i]), mean=float(me[i]),
                     mean_var=float(mv[i]), n_sampled=int(nsel[i]),
                     histogram=hist[i])
                for i in range(len(ts)) if ok[i]]


def compile(spec: PipelineSpec, *, device="cuda") -> CompiledPipeline:
    """The front door: ``PipelineSpec → CompiledPipeline`` on ``device``
    (``"cuda"`` by default; it raises where there is no CUDA device,
    and ``device="cpu"`` runs the plain PyTorch path)."""
    if not isinstance(spec, PipelineSpec):
        raise SpecError(f"compile() takes a repro_torch PipelineSpec, got "
                        f"{type(spec).__name__} — build one with "
                        f"PipelineSpec(...) or PipelineSpec.from_dict(...)")
    return CompiledPipeline(spec, resolve_device(device))
