"""Linear queries over weighted samples.

The counterpart of ``repro.core.queries``: any query of the form
``Σ_k f(item_k)`` is estimated from the weighted sample as
``Σ_i W_i^out · Σ_{k∈sample_i} f(item_k)`` — SUM, COUNT, MEAN, the
histogram, and ``map_query``'s user functions — each a ``QueryResult``
with its CLT variance (§III-D). The histogram's bin sums are segment sums
in item order on every device (the ``segment_sum`` kernel on the card).
``weighted_loss`` is the training plane's query.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import error as err
from repro_torch.core.sampling import segment_sum
from repro_torch.core.types import (IntervalBatch, QueryResult, SampleResult,
                                    StratumMeta)


def weighted_sum(batch: IntervalBatch, res: SampleResult,
                 num_strata: int) -> QueryResult:
    return err.approx_sum(batch.value, batch.stratum, res.selected, res.meta,
                          num_strata)


def weighted_mean(batch: IntervalBatch, res: SampleResult,
                  num_strata: int) -> QueryResult:
    return err.approx_mean(batch.value, batch.stratum, res.selected,
                           res.meta, num_strata)


def weighted_count(batch: IntervalBatch, res: SampleResult,
                   num_strata: int) -> QueryResult:
    """Estimated number of items in the original stream (f = 1)."""
    return err.approx_sum(torch.ones_like(batch.value), batch.stratum,
                          res.selected, res.meta, num_strata)


def map_query(f: Callable[[torch.Tensor], torch.Tensor],
              batch: IntervalBatch, res: SampleResult,
              num_strata: int) -> QueryResult:
    """Generic linear query ``Σ f(item)`` — the extension point for users."""
    return err.approx_sum(f(batch.value), batch.stratum, res.selected,
                          res.meta, num_strata)


def weighted_histogram(batch: IntervalBatch, res: SampleResult,
                       num_strata: int, edges: torch.Tensor) -> QueryResult:
    """``edges`` f32[B+1] monotone → estimate and variance f32[B]."""
    nbins = edges.shape[0] - 1
    bin_ix = torch.clamp(
        torch.searchsorted(edges, batch.value, right=True) - 1, 0, nbins - 1)
    w_item = res.meta.weight[batch.stratum.to(torch.int64)
                             .clamp(0, num_strata - 1)]
    sel = res.selected
    seg = torch.where(sel, bin_ix, nbins - 1)
    est = segment_sum(torch.where(sel, w_item, 0.0), seg, nbins)
    # Bernoulli-in-stratum plug-in variance Σ w·(w−1) over the bin's items.
    contrib = torch.where(sel, w_item * torch.clamp_min(w_item - 1.0, 0.0),
                          0.0)
    var = segment_sum(contrib, seg, nbins)
    return QueryResult(estimate=est, variance=var)


def weighted_loss(per_example_loss: torch.Tensor, stratum: torch.Tensor,
                  selected: torch.Tensor, meta: StratumMeta) -> torch.Tensor:
    """Training-plane query: unbiased mean loss of the *full* stream.

    ``E[Σ_sel w·loss / Σ_sel w·1] ≈ full-stream mean loss`` — the ratio
    estimator the approximate-training pipeline feeds to the gradient.
    """
    w = meta.weight[stratum.to(torch.int64)] * selected.to(torch.float32)
    return (torch.sum(w * per_example_loss)
            / torch.clamp(torch.sum(w), min=1e-9))
