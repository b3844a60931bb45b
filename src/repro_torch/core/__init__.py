"""Core math of the port: PRNG, sampling, WHS, SRS, errors, scan engine.

Public surface, as the reference's ``repro.core``:
    types     — IntervalBatch / StratumMeta / SampleResult / QueryResult
    sampling  — priority sampling, reservoir allocation, the backends
    whs       — WHSamp (Alg. 2 + Eq. 9), a node and a stacked level
    srs       — the simple-random-sampling baseline
    error     — CLT error estimation (Eq. 11/14)
    queries   — linear queries (sum/mean/count/histogram/loss)
    tree      — the scan engine and ``HostTree``
    window    — per-node interval buffers and the tree state
"""
from repro_torch.core import (  # noqa: F401
    error, queries, sampling, srs, tree, whs, window)
from repro_torch.core.types import (IntervalBatch, QueryResult,  # noqa: F401
                                    SampleResult, StratumMeta)
