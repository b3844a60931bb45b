"""Adaptive budget controller — the paper's ``costFunction(budget)``
(Alg. 1 line 3) plus the "adaptive feedback mechanism" of §IV-B, which
the paper leaves as future work: the loop is closed with a PI controller.
The port's own copy of ``repro.runtime.budget`` (host Python, no tensor).

Two constraints, both expressible as a sample-size budget:
  * latency: keep measured interval processing time ≤ target,
  * accuracy: keep the root's relative ±2σ bound ≤ target (grow the
    sample when the error budget is violated).
The controller is per-node and uses only local measurements — no
cross-node coordination, preserving the paper's scalability property.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class BudgetConfig:
    min_size: int
    max_size: int
    target_latency_s: float | None = None
    target_rel_error: float | None = None   # relative ±2σ / estimate
    kp: float = 0.5
    ki: float = 0.1


class BudgetController:
    def __init__(self, cfg: BudgetConfig, initial_size: int):
        self.cfg = cfg
        self.size = float(initial_size)
        self._i_lat = 0.0
        self._i_err = 0.0
        # last observed inputs, surfaced by repro_torch.obs.metrics
        self.last_latency_s: float | None = None
        self.last_rel_error: float | None = None

    def update(self, *, latency_s: float | None = None,
               rel_error: float | None = None) -> int:
        c = self.cfg
        if latency_s is not None:
            self.last_latency_s = float(latency_s)
        if rel_error is not None:
            self.last_rel_error = float(rel_error)
        scale = 0.0
        if c.target_latency_s is not None and latency_s is not None:
            # positive err → too slow → shrink the sample
            err = (latency_s - c.target_latency_s) / c.target_latency_s
            self._i_lat = max(min(self._i_lat + err, 5.0), -5.0)
            scale -= c.kp * err + c.ki * self._i_lat
        if c.target_rel_error is not None and rel_error is not None:
            # positive err → too inaccurate → grow the sample
            err = (rel_error - c.target_rel_error) / max(c.target_rel_error, 1e-9)
            self._i_err = max(min(self._i_err + err, 5.0), -5.0)
            scale += c.kp * err + c.ki * self._i_err
        self.size = self.size * (1.0 + max(min(scale, 1.0), -0.5))
        self.size = max(min(self.size, c.max_size), c.min_size)
        return int(self.size)


def level_error_shares(items_in, items_kept) -> list[float]:
    """Per-level share of the pipeline's sampling-induced variance.

    A sampling stage that keeps fraction ``f`` of its input inflates
    estimator variance by ~``(1-f)/f`` (the HT/SRS second-moment
    scaling), so a level's share of the end-to-end error is its
    normalized ``(1-f)/f``. Levels that forward everything (``f=1``)
    contribute 0; with no subsampling anywhere (or no traffic yet) the
    shares are uniform — there is nothing to attribute, so the arbiter
    degenerates to the legacy all-levels-together behaviour."""
    contrib = []
    for n_in, n_kept in zip(items_in, items_kept):
        n_in = max(float(n_in), 0.0)
        if n_in <= 0.0:
            contrib.append(0.0)
            continue
        f = min(max(float(n_kept) / n_in, 1e-9), 1.0)
        contrib.append((1.0 - f) / f)
    total = sum(contrib)
    if total <= 0.0:
        return [1.0 / max(len(contrib), 1)] * len(contrib)
    return [c / total for c in contrib]


class WorstTenantArbiter:
    """Fairness for N query tenants sharing one tree's error budget:
    **worst-tenant-first**. Each epoch the tenant with the largest
    measured relative error drives the shared ``BudgetController`` —
    the sample budget moves to satisfy the worst-off tenant, so no
    tenant can be starved by a neighbour whose queries are already
    comfortably inside the target (min-max fairness on the shared
    knob; the budget only shrinks when *every* tenant is under
    target). ``last_tenant`` records who drove each move for
    attribution/telemetry.

    Two feedback grains share the same fairness rule:

    * :meth:`update` — legacy single knob, every level moves together;
    * :meth:`update_levels` — per-level attribution: the worst tenant's
      error is split across tree levels by measured variance shares
      (:func:`level_error_shares`), and each level's own controller sees
      the error scaled by ``share x n_levels``. A level that dominates
      the tenant's error sees an amplified error and grows; a level that
      contributes nothing sees ~0 error (below target) and is free to
      shrink, releasing budget instead of riding along. The shares are
      self-correcting: shrinking a level lowers its keep-fraction, which
      raises its ``(1-f)/f`` share next epoch."""

    def __init__(self, cfg: BudgetConfig, initial_size: int):
        self.controller = BudgetController(cfg, initial_size)
        self.last_tenant: str | None = None
        self.last_shares: list[float] | None = None
        self._level_controllers: list[BudgetController] | None = None

    @property
    def size(self) -> float:
        return self.controller.size

    def update(self, tenant_rel_errors: dict) -> int:
        """``{tenant: measured relative ±2σ error}`` → new budget."""
        finite = {t: e for t, e in tenant_rel_errors.items()
                  if e == e and e != float("inf")}
        if not finite:
            return int(self.controller.size)
        worst = max(finite, key=lambda t: finite[t])
        self.last_tenant = worst
        return self.controller.update(rel_error=finite[worst])

    def update_levels(self, tenant_rel_errors: dict,
                      level_shares) -> list[int]:
        """``{tenant: rel error}`` + per-level variance shares → new
        per-level budgets (see class docstring). Lazily instantiates one
        ``BudgetController`` per level, seeded from the shared knob so
        the first per-level move continues where :meth:`update` left
        off."""
        n = len(level_shares)
        if (self._level_controllers is None
                or len(self._level_controllers) != n):
            self._level_controllers = [
                BudgetController(self.controller.cfg,
                                 int(self.controller.size))
                for _ in range(n)]
        finite = {t: e for t, e in tenant_rel_errors.items()
                  if e == e and e != float("inf")}
        if not finite:
            return [int(c.size) for c in self._level_controllers]
        worst = max(finite, key=lambda t: finite[t])
        self.last_tenant = worst
        self.last_shares = [float(s) for s in level_shares]
        return [ctl.update(rel_error=finite[worst] * float(s) * n)
                for ctl, s in zip(self._level_controllers, level_shares)]

    def update_from_windows(self, plan, windows) -> tuple[int, dict]:
        """One epoch's result rows → (new budget, per-tenant errors).

        Convenience over :func:`aggregate_tenant_rel_errors` +
        :meth:`update`, for a driver that moves one shared budget at
        each epoch boundary."""
        per = aggregate_tenant_rel_errors(plan, windows)
        return self.update(per), per


def aggregate_tenant_rel_errors(plan, windows) -> dict[str, float]:
    """Aggregate per-tenant measured relative ±2σ errors over an epoch.

    ``windows`` are result rows carrying flat ``answers``/``bounds``
    vectors (``HostTree.results`` / ``CompiledPipeline.rows`` layout).
    Per window the attribution rule is ``query.compiler.
    tenant_rel_errors`` (worst CLT bound per tenant); across the epoch
    each tenant reports the mean of its finite per-window errors."""
    import numpy as np

    from repro_torch.query.compiler import tenant_rel_errors

    acc: dict[str, list] = {}
    for w in windows:
        if "answers" not in w:
            continue
        for t, r in tenant_rel_errors(plan, w["answers"],
                                      w["bounds"]).items():
            acc.setdefault(t, []).append(r)
    return {t: float(np.mean([r for r in rs if np.isfinite(r)] or [0.0]))
            for t, rs in acc.items()}
