"""Straggler-tolerant window publication.

The port's own copy of ``repro.serve.windows``.

A window whose edge shards all met their deadline publishes the
pipeline's answers untouched — bit-for-bit what a fully synchronous run
produces (pinned in tests). A window with late shards or shed load
publishes a *partial* answer instead of waiting: the arrived-weight
fraction α from the executor's Eq. 9 accounting (``runtime.straggler.
calibrate_weights`` — scale what arrived by 1/α so the estimator still
targets the full stream) rescales the linear estimates and widens every
bound by 1/α ≥ 1. Late data is never dropped: it stays queued and folds
into the next window, so Σ(raw window counts) over a run still equals
every item that entered the tree.

Per-slot widening rules (slot kinds from the compiled plan's layout):

    sum / count / histogram   answer × 1/α,  bound × 1/α   (linear — Eq. 9
                              rescaling keeps the estimate unbiased)
    mean                      answer as-is,  bound × 1/α   (ratio — α
                              cancels in the estimate, not the spread)
    quantile / windowed_      answer as-is,  bound × 1/α   (rank error
        quantile                             grows with the missing mass)
    heavy_hitters / decayed_  key half as-is, estimate half × 1/α,
        heavy_hitters                        bound × 1/α

The built-in workload follows the same rules (SUM × 1/α with variance
× 1/α², MEAN untouched with variance × 1/α², histogram × 1/α).
``PublishedWindow.raw`` keeps the untouched row for conservation
accounting.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np

_SCALE_ANSWER_KINDS = ("sum", "count", "histogram")
_KEYED_KINDS = ("heavy_hitters", "decayed_heavy_hitters")


class PublishedWindow(NamedTuple):
    """One published root window: the (possibly widened) serve answer
    plus its straggler/latency provenance."""

    tick: int
    partial: bool
    alpha: float              # arrived-weight fraction (1.0 when complete)
    publish_time: float
    first_arrival: float      # earliest staged arrival (inf if none)
    latency: float            # publish_time - first_arrival (0.0 if none)
    sum: float
    sum_var: float
    mean: float
    mean_var: float
    n_sampled: int
    histogram: np.ndarray
    answers: Any              # widened flat query answers (None w/o tenants)
    bounds: Any
    raw: dict                 # the untouched pipeline row


class WindowPublisher:
    """Applies the per-kind widening rules of one compiled pipeline's
    query layout (see module doc)."""

    def __init__(self, pipeline):
        self._layout = (pipeline.query_layout()
                        if pipeline.plan is not None else {})

    def publish(self, row: dict, *, alpha: float, partial: bool,
                publish_time: float, first_arrival: float
                ) -> PublishedWindow:
        alpha = float(alpha)
        latency = (publish_time - first_arrival
                   if math.isfinite(first_arrival) else 0.0)
        common = dict(tick=int(row["tick"]), partial=bool(partial),
                      alpha=alpha, publish_time=float(publish_time),
                      first_arrival=float(first_arrival), latency=latency,
                      raw=row)
        if not partial:
            # Complete window: pass every array through untouched so the
            # on-time path stays bitwise identical to a synchronous run.
            return PublishedWindow(
                sum=row["sum"], sum_var=row["sum_var"], mean=row["mean"],
                mean_var=row["mean_var"], n_sampled=row["n_sampled"],
                histogram=row["histogram"], answers=row.get("answers"),
                bounds=row.get("bounds"), **common)
        inv = 1.0 / alpha if alpha > 0.0 else 1.0
        answers = bounds = None
        if "answers" in row:
            answers = np.array(row["answers"], np.float32, copy=True)
            bounds = np.array(row["bounds"], np.float32, copy=True) * inv
            for _, (o, w, kind) in self._layout.items():
                if kind in _SCALE_ANSWER_KINDS:
                    answers[o:o + w] *= inv
                elif kind in _KEYED_KINDS:
                    answers[o + w // 2:o + w] *= inv
        return PublishedWindow(
            sum=row["sum"] * inv, sum_var=row["sum_var"] * inv * inv,
            mean=row["mean"], mean_var=row["mean_var"] * inv * inv,
            n_sampled=row["n_sampled"],
            histogram=np.asarray(row["histogram"]) * np.float32(inv),
            answers=answers, bounds=bounds, **common)
