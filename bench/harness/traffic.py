"""The traffic generator: a pool of epochs of level-0 ingest from a seed.

One general generator for every mix. The configuration gives the
stream (items a tick, sources, each sub-stream's distribution and share
of the items) and the tree's level-0 shape; the mix gives the ticks an
epoch, the epochs in the pool and where the ingest sits. Per tick every
source draws a Poisson count of each sub-stream (mean: items a tick ×
share / sources); source ``i`` feeds level-0 node ``i mod fanin[0]``,
and a node's row holds its sources' items in source order, each source's
sub-streams in order, prefix-truncated at the row's width (the level-0
capacity). Values are drawn on ``device`` from one ``torch.Generator``
seeded with the seed, in a few large calls, and the pool is then copied
once to host memory (``ingest: host_pageable``) or kept on the device
(``ingest: device``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

INGEST = ("host_pageable", "device")


@dataclasses.dataclass
class Pool:
    """``values``/``strata``/``counts`` per epoch: ``[T, n0, width]`` f32
    and i32, ``[T, n0]`` i32 (numpy arrays on the host, or tensors on the
    device)."""

    values: list
    strata: list
    counts: list

    def counts_host(self, e: int) -> np.ndarray:
        c = self.counts[e]
        return c.cpu().numpy() if torch.is_tensor(c) else np.asarray(c)

    def epoch_host(self, e: int):
        """Epoch ``e`` as numpy arrays."""
        return tuple(a.cpu().numpy() if torch.is_tensor(a) else a
                     for a in (self.values[e], self.strata[e],
                               self.counts[e]))

    def __len__(self) -> int:
        return len(self.values)


def _draw_values(dist: str, params, z_shape, gen, device):
    if dist == "gaussian":
        mu, sigma = params
        z = torch.randn(z_shape, generator=gen, device=device)
        return z * float(sigma) + float(mu)
    if dist == "poisson":
        lam = torch.full(z_shape, float(params[0]), device=device)
        return torch.poisson(lam, generator=gen)
    raise ValueError(f"unknown sub-stream distribution {dist!r}")


def make_pool(config: dict, mix: dict, seed: int, device) -> Pool:
    stream, topo = config["stream"], config["topology"]
    subs = stream["substreams"]
    n_src, n0 = int(topo["num_sources"]), int(topo["fanin"][0])
    width = int(topo["capacity"])
    ticks, epochs = int(mix["ticks_per_epoch"]), int(mix["pool_epochs"])
    where = mix.get("ingest", "host_pageable")
    if where not in INGEST:
        raise ValueError(f"unknown ingest {where!r}; known: {INGEST}")
    if n_src % n0:
        raise ValueError("sources must divide evenly over level-0 nodes")
    x = len(subs)
    per_node = n_src // n0
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    rate = torch.tensor([float(stream["items_per_tick"]) * float(s["share"])
                         / n_src for s in subs], dtype=torch.float64,
                        device=device)
    # [E, T, sources, X] Poisson counts, drawn in one call.
    counts = torch.poisson(rate.expand(epochs, ticks, n_src, x).contiguous(),
                           generator=gen).long()
    # Node k's segments: its sources (k, k + n0, ...), each's sub-streams.
    seg = counts.reshape(epochs, ticks, per_node, n0, x).transpose(2, 3)
    seg = seg.reshape(epochs, ticks, n0, per_node * x)
    ends = torch.cumsum(seg, -1)
    total = torch.clamp_max(ends[..., -1], width)
    pool = Pool([], [], [])
    j = torch.arange(width, device=device)
    for e in range(epochs):
        # Slot j of a row belongs to the first segment that ends past j.
        ix = torch.searchsorted(ends[e].reshape(-1, per_node * x),
                                j.expand(ticks * n0, width).contiguous(),
                                right=True).reshape(ticks, n0, width)
        stratum = (ix % x).to(torch.int32)
        valid = j[None, None, :] < total[e][..., None]
        values = torch.zeros((ticks, n0, width), dtype=torch.float32,
                             device=device)
        for s, sub in enumerate(subs):
            v = _draw_values(sub["dist"], sub["params"], (ticks, n0, width),
                             gen, device)
            values = torch.where(stratum == s, v, values)
        values = torch.where(valid, values, 0.0)
        stratum = torch.where(valid, stratum, 0)
        c = total[e].to(torch.int32)
        if where == "host_pageable":
            pool.values.append(values.cpu().numpy())
            pool.strata.append(stratum.cpu().numpy())
            pool.counts.append(c.cpu().numpy())
        else:
            pool.values.append(values)
            pool.strata.append(stratum)
            pool.counts.append(c)
    return pool
