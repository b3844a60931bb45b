"""Approximate training data pipeline: ApproxIoT sampling in front of SGD.

The port of ``repro/data/pipeline.py``. Each interval, a shard's
arriving examples are stratified by domain and reservoir-sampled within
the interval budget (``whsamp``, on the pipeline's device); the
surviving examples carry ``W^out`` weights so the weighted loss is an
unbiased estimate of the full-stream loss. This is the paper's
edge-sampling tree with data-parallel shards as the edge nodes and the
train step as the root query. Keys come from ``core.prng``, so the
selection, the weights and every field of ``next_batch()`` are the
reference's, bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng, whs
from repro_torch.core.types import IntervalBatch, StratumMeta
from repro_torch.data.stream import TokenStream
from repro_torch.device import resolve_device


@dataclasses.dataclass
class PipelineConfig:
    batch_size: int          # examples per step fed to the model
    interval_size: int       # examples arriving per interval (pre-sampling)
    num_strata: int
    sampling_fraction: float = 0.5
    allocation: str = "fair"
    seed: int = 0


class ApproxTrainPipeline:
    """Host-side loop: stream → stratified sample (on ``device``, CUDA
    unless asked otherwise) → weighted numpy batches."""

    def __init__(self, cfg: PipelineConfig, stream: TokenStream,
                 device="cuda"):
        self.cfg = cfg
        self.stream = stream
        self.device = resolve_device(device)
        self._key = prng.PRNGKey(cfg.seed, device=self.device)
        self.stats = {"arrived": 0, "sampled": 0}

    def _sample(self, key, strata: torch.Tensor):
        m = strata.shape[0]
        x = self.cfg.num_strata
        dev = self.device
        batch = IntervalBatch(
            value=torch.zeros((m,), dtype=torch.float32, device=dev),
            stratum=strata,
            valid=torch.ones((m,), dtype=torch.bool, device=dev),
            meta=StratumMeta.identity(x, device=dev))
        size = torch.tensor(self.cfg.sampling_fraction * m,
                            dtype=torch.float32, device=dev)
        res = whs.whsamp(key, batch, size, x,
                         allocation=self.cfg.allocation)
        return res.selected, res.meta.weight

    def next_batch(self) -> dict:
        cfg = self.cfg
        ex = self.stream.examples(cfg.interval_size)
        keys = prng.split(self._key)
        self._key, sub = keys[0], keys[1]
        sel, w = self._sample(sub, torch.as_tensor(ex["stratum"],
                                                   device=self.device))
        sel = sel.cpu().numpy()
        w = w.cpu().numpy()
        idx = np.nonzero(sel)[0]
        self.stats["arrived"] += cfg.interval_size
        self.stats["sampled"] += len(idx)
        # pack into a fixed batch (repeat-pad if the sample is short; the
        # pad examples keep their true weights so the estimate stays valid)
        if len(idx) == 0:
            idx = np.arange(min(cfg.batch_size, cfg.interval_size))
            w = np.ones((cfg.num_strata,), np.float32)
        take = np.resize(idx, cfg.batch_size)
        dup = np.bincount(take, minlength=cfg.interval_size).astype(
            np.float32)
        strat = ex["stratum"][take]
        weight = w[strat] / dup[take]       # split weight across duplicates
        return {
            "tokens": ex["tokens"][take],
            "labels": ex["labels"][take],
            "stratum": strat,
            "weight": weight.astype(np.float32),
        }
