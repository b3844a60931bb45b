"""Linear queries over weighted samples: the root's histogram.

The counterpart of ``repro.core.queries.weighted_histogram``: the
estimated item count per value bin, a vector of linear queries, each
with its plug-in variance. The bin sums are segment sums in item order
on every device (the ``segment_sum`` kernel on the card).
"""
from __future__ import annotations

import torch

from repro_torch.core.sampling import segment_sum
from repro_torch.core.types import IntervalBatch, QueryResult, SampleResult


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
