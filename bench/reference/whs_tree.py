"""Plain reference of the weighted hierarchical sampling tree.

ApproxIoT (ICDCS 2018), Alg. 1 and 2 with the §III-C weight fix (Eq. 9)
and the §III-D estimators (Eq. 3, 11-14), written from the paper for
the benchmark's check and sharing no code with the program under test.
It works out one tick of the edge tree from the tick's ingest and the
pipeline key:

* each node's priorities: Threefry-2x32 (Salmon et al., SC'11) in JAX's
  key conventions, ``uniform(fold_in(fold_in(fold_in(key, t), level),
  node), capacity)``;
* each node's per-stratum budget (``fair`` water-filling or ``neyman``
  ∝ c·σ), conserving ``min(size, Σ c)`` exactly;
* each stratum's top-N items by priority, ties to the earlier slot;
* Eq. 9's weights, the children's messages routed to parent ``i mod
  P``, and the count-weighted metadata merge at the parent;
* at the root: SUM and MEAN with their CLT variances and the weighted
  64-bin histogram of the sampled values.

The configuration states float32. Every decision (counts, budgets,
thresholds) and every estimate is computed in float32 with the order of
additions the configuration fixes: per-stratum sums in item order, sums
over the strata left to right, ``a·b + c`` rounded once where the
estimators contract it. ``precision="bfloat16"`` holds the stream's
values and the priorities in bfloat16 (the comparison's control).

Selection and compaction run as tensor operations on ``device``; the
ordered float32 sums run in numpy on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
F32 = np.float32


# ---------------------------------------------------------------- PRNG --
def _threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds; words held in int64 (tensors) or ints."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = (((x1 << r) & _M) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def root_key(seed: int) -> tuple[int, int]:
    """The key of an int32 seed: the words ``(0, seed)``."""
    return 0, int(seed) & _M


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    return _threefry(key[0], key[1], 0, int(data) & _M)


def node_key(key, t: int, level: int, node: int) -> tuple[int, int]:
    return fold_in(fold_in(fold_in(key, t), level), node)


def uniforms(key: tuple[int, int], n: int, device) -> torch.Tensor:
    """f32[n] in [0, 1): the top 23 bits of ``y0 ^ y1`` of the counter
    ``(0, j)`` as the mantissa of a number in [1, 2), minus 1."""
    j = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = _threefry(key[0], key[1], torch.zeros_like(j), j)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


# ----------------------------------------------------------- the tree --
@dataclasses.dataclass(frozen=True)
class Tree:
    """Shapes of the tree: ``fanin`` nodes a level (root last), level-0
    ``capacity``, strata, the end-to-end ``fraction`` that sizes every
    node's budget, and the budget ``allocation``."""

    fanin: tuple
    capacity: int
    num_strata: int
    fraction: float
    allocation: str = "fair"
    hist_bins: int = 64

    @property
    def size(self) -> int:
        """Items a node keeps each tick: ``capacity × fraction``."""
        return max(int(self.capacity * self.fraction), 1)

    @property
    def capacities(self) -> list[int]:
        """A parent's buffer holds every child's budget."""
        caps = [int(self.capacity)]
        for lvl in range(len(self.fanin) - 1):
            per_parent = -(-self.fanin[lvl] // self.fanin[lvl + 1])
            caps.append(max(self.size * per_parent, 64))
        return caps


def _fma(a, b, c):
    """``a·b + c`` with one rounding to float32 (the product is exact in
    float64)."""
    return F32(np.float64(a) * np.float64(b) + np.float64(c))


def _seq_sum(x) -> np.float32:
    """Float32 sum in the given order."""
    x = np.asarray(x, F32)
    return np.add.accumulate(x)[-1] if x.size else F32(0.0)


def _strata_sums(values, strata, mask, num_strata):
    """Per stratum: (count, Σx, Σx²) over ``mask``, float32 in item
    order."""
    c = np.zeros(num_strata, F32)
    s1 = np.zeros(num_strata, F32)
    s2 = np.zeros(num_strata, F32)
    for x in range(num_strata):
        v = values[mask & (strata == x)].astype(F32)
        c[x] = F32(v.size)
        s1[x] = _seq_sum(v)
        s2[x] = _seq_sum(v * v)
    return c, s1, s2


def _stds(values, strata, mask, num_strata):
    c, s1, s2 = _strata_sums(values, strata, mask, num_strata)
    safe = np.maximum(c, F32(1.0))
    mean = s1 / safe
    var = np.array([max(_fma(-m, m, q), F32(0.0))
                    for m, q in zip(mean, s2 / safe)], F32)
    return np.sqrt(var.astype(np.float64)).astype(F32)


def _left_sum(x):
    acc = x[..., 0].copy()
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc[..., None]


def _settle(alloc, counts, active, budget):
    """The budget not yet given goes to the lowest strata with room."""
    alloc = np.where(active, np.minimum(alloc, counts), F32(0.0))
    head = np.where(active, counts - alloc, F32(0.0))
    left = budget - alloc.sum(-1, keepdims=True, dtype=F32)
    before = np.cumsum(head, -1, dtype=F32) - head
    return alloc + np.minimum(np.maximum(left - before, F32(0.0)), head)


def allocate(size: float, counts, policy: str, stds=None):
    """Per-node, per-stratum budgets ``[n, X]`` (float32, whole numbers)
    summing to ``min(size, Σ c)``: ``fair`` shares equally and
    water-fills what small strata leave (4 rounds); ``neyman`` first
    reserves one item a non-empty stratum and splits the rest ∝ c·σ,
    re-splitting what capped strata leave (4 rounds)."""
    counts = np.asarray(counts, F32)
    active = counts > 0
    budget = np.minimum(F32(size), counts.sum(-1, keepdims=True, dtype=F32))
    if policy == "fair":
        n_active = np.maximum(active.sum(-1, keepdims=True).astype(F32),
                              F32(1.0))
        alloc = np.where(active, np.floor(budget / n_active), F32(0.0))
        for _ in range(4):
            used = np.minimum(alloc, counts)
            surplus = (alloc - used).sum(-1, keepdims=True, dtype=F32)
            capped = active & (counts > alloc)
            n_capped = np.maximum(capped.sum(-1, keepdims=True).astype(F32),
                                  F32(1.0))
            bump = np.where(capped, np.floor(surplus / n_capped), F32(0.0))
            alloc = np.where(active, used + bump, F32(0.0))
        return _settle(alloc.astype(F32), counts, active, budget)
    if policy != "neyman":
        raise ValueError(f"no reference for allocation {policy!r}")
    one = np.minimum(counts, F32(1.0))
    before = np.cumsum(one, -1, dtype=F32) - one
    reserve = np.minimum(np.maximum(budget - before, F32(0.0)), one)
    rem = budget - reserve.sum(-1, keepdims=True, dtype=F32)
    sigma = np.maximum(np.asarray(stds, F32), F32(1e-6))
    score = np.where(active, counts * sigma, F32(0.0)).astype(F32)
    total = np.maximum(_left_sum(score), F32(1e-30))
    alloc = np.minimum(reserve + np.floor(rem * score / total), counts)
    for _ in range(4):
        s = np.where(active & (alloc < counts), score, F32(0.0))
        total = np.maximum(_left_sum(s), F32(1e-30))
        spare = budget - alloc.sum(-1, keepdims=True, dtype=F32)
        alloc = np.minimum(alloc + np.floor(spare * s / total), counts)
    return _settle(alloc.astype(F32), counts, active, budget)


def _weights(c, res, w_in, c_in):
    """Eq. 9: ``W_out = W_in · max(c/N, 1) · C_in/c`` (the last factor 1
    at a source), ``C_out = min(c, N)``; strata absent this tick keep
    their metadata."""
    y = np.minimum(c, np.maximum(res, F32(0.0)))
    local = np.where(c > res, c / np.maximum(res, F32(1.0)), F32(1.0))
    calib = np.where((c_in > 0) & (c > 0), c_in / np.maximum(c, F32(1.0)),
                     F32(1.0))
    w_out = np.where(c > 0, w_in * local * calib, w_in).astype(F32)
    c_out = np.where(c > 0, y, c_in).astype(F32)
    return y.astype(F32), w_out, c_out


def select(prio, strata, valid, res, num_strata):
    """bool[n, m]: each row's top-``res[x]`` valid items of stratum x by
    priority, ties to the earlier slot."""
    n, m = prio.shape
    x = num_strata
    key = torch.where(valid, strata.double() + (1.0 - prio.double()),
                      float(x + 1))
    order = torch.sort(key, dim=1, stable=True).indices
    seg = torch.where(valid, strata.long(), x).gather(1, order)
    counts = torch.zeros((n, x + 1), dtype=torch.int64, device=prio.device)
    counts.scatter_add_(1, seg, torch.ones_like(seg))
    starts = torch.cumsum(counts, 1) - counts
    rank = torch.arange(m, device=prio.device)[None, :] - starts.gather(1, seg)
    res_ext = torch.cat([torch.as_tensor(res, device=prio.device).long(),
                         torch.zeros((n, 1), dtype=torch.int64,
                                     device=prio.device)], 1)
    keep_sorted = rank < res_ext.gather(1, seg)
    keep = torch.zeros_like(valid).scatter(1, order, keep_sorted)
    return keep & valid


def _counts(strata, valid, num_strata) -> np.ndarray:
    s = torch.where(valid, strata.long(), num_strata)
    out = torch.zeros((s.shape[0], num_strata + 1), dtype=torch.int64,
                      device=s.device)
    out.scatter_add_(1, s, torch.ones_like(s))
    return out[:, :num_strata].cpu().numpy().astype(F32)


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return x
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def tick(tree: Tree, key, t: int, values, strata, counts, *, device,
         precision: str = "float32", sticky=None) -> dict:
    """One tick of the tree from its level-0 ingest (``values`` f32 and
    ``strata`` i32 ``[fanin[0], width]``, ``counts`` i32 ``[fanin[0]]``).

    ``sticky`` is each level's ``(W, C)`` from before the tick (identity
    by default); it matters only for strata absent at a node. Returns
    the root's answers, the forwarded counts, each level's buffer, fill
    and flushed metadata as the tick leaves them, and under ``root`` the
    root's sample: its buffer's ``values`` and ``strata``, the ``keep``
    mask and each stratum's Eq. 9 ``weight``."""
    x = tree.num_strata
    caps = tree.capacities
    size = tree.size
    n_levels = len(tree.fanin)
    if sticky is None:
        sticky = [(np.ones((n, x), F32), np.zeros((n, x), F32))
                  for n in tree.fanin]
    v = torch.as_tensor(np.asarray(values, F32), device=device)
    s = torch.as_tensor(np.asarray(strata, np.int32), device=device)
    width = v.shape[1]
    if width < caps[0]:
        v = torch.cat([v, v.new_zeros((v.shape[0], caps[0] - width))], 1)
        s = torch.cat([s, s.new_zeros((s.shape[0], caps[0] - width))], 1)
    v, s = v[:, :caps[0]].contiguous(), s[:, :caps[0]].contiguous()
    v = _round(v, precision)
    fill = np.minimum(np.asarray(counts, np.int64), caps[0])
    w_in, c_in = sticky[0]
    seen = np.zeros((tree.fanin[0], x), bool)
    out = {"levels": [], "n_forwarded": []}
    for lvl in range(n_levels):
        n, cap = v.shape
        valid = (torch.arange(cap, device=device)[None, :]
                 < torch.as_tensor(fill, device=device)[:, None])
        out["levels"].append({"values": v.cpu().numpy(),
                              "strata": s.cpu().numpy(),
                              "fill": fill.copy(), "w": w_in.copy(),
                              "c": c_in.copy(), "seen": seen.copy()})
        prio = torch.stack([
            _round(uniforms(node_key(key, t, lvl, i), cap, device),
                   precision) for i in range(n)])
        c = _counts(s, valid, x)
        stds = None
        if tree.allocation == "neyman":
            vh, sh, mh = v.cpu().numpy(), s.cpu().numpy(), valid.cpu().numpy()
            stds = np.stack([_stds(vh[i], sh[i], mh[i], x) for i in range(n)])
        res = allocate(size, c, tree.allocation, stds)
        keep = select(prio, s, valid, res, x)
        y, w_out, c_out = _weights(c, res, w_in, c_in)
        if lvl == n_levels - 1:
            root = {"values": v[0].cpu().numpy(), "strata": s[0].cpu().numpy(),
                    "keep": keep[0].cpu().numpy(), "weight": w_out[0]}
            out.update(_root(tree, root["values"], root["strata"],
                             root["keep"], root["weight"], int(fill[0])))
            out["root"] = root
            break
        # Compaction: kept items to the front in slot order, at most
        # ``size`` of them; the weights follow what fits.
        n_keep = keep.sum(1)
        dest = torch.cumsum(keep.long(), 1) - 1
        fits = keep & (dest < size)
        vc = v.new_zeros((n, size))
        sc = s.new_zeros((n, size))
        rows = torch.arange(n, device=device)[:, None].expand(n, cap)
        vc[rows[fits], dest[fits]] = v[fits]
        sc[rows[fits], dest[fits]] = s[fits]
        n_fit = torch.clamp_max(n_keep, size).cpu().numpy()
        slot = np.arange(size)[None, :] < n_fit[:, None]
        sch = sc.cpu().numpy()
        kept = np.stack([np.bincount(sch[i][slot[i]], minlength=x)[:x]
                         for i in range(n)]).astype(F32)
        w_out = np.where(kept > 0, w_out * (y / np.maximum(kept, F32(1.0))),
                         w_out).astype(F32)
        c_out = np.where(kept > 0, kept, c_out).astype(F32)
        present = kept > 0
        out["n_forwarded"].append(int(n_fit.sum()))
        # Routing: parent p takes children p, p + P, ... in that order;
        # its buffer is their messages back to back, then zeros.
        parents = tree.fanin[lvl + 1]
        cap_up = caps[lvl + 1]
        pv = v.new_zeros((parents, cap_up))
        ps = s.new_zeros((parents, cap_up))
        pfill = np.zeros(parents, np.int64)
        w_up = np.zeros((parents, x), F32)
        c_up = np.zeros((parents, x), F32)
        seen = np.zeros((parents, x), bool)
        for p in range(parents):
            at = 0
            for ch in range(p, n, parents):
                k = int(min(n_fit[ch], cap_up - at))
                pv[p, at:at + k] = vc[ch, :k]
                ps[p, at:at + k] = sc[ch, :k]
                at += k
                pr = present[ch]
                w_up[p] = np.where(pr, w_up[p] + w_out[ch] * c_out[ch],
                                   w_up[p])
                c_up[p] = np.where(pr, c_up[p] + c_out[ch], c_up[p])
                seen[p] |= pr
            pfill[p] = at
        w_prev, c_prev = sticky[lvl + 1]
        w_in = np.where(seen, w_up / np.maximum(c_up, F32(1.0)),
                        w_prev).astype(F32)
        c_in = np.where(seen, c_up, c_prev).astype(F32)
        v, s, fill = pv, ps, pfill
    return out


def _root(tree: Tree, values, strata, keep, w, fill: int) -> dict:
    """SUM, MEAN (Eq. 3, 11-14) and the histogram over the root's
    sample, float32."""
    x = tree.num_strata
    y, s1, s2 = _strata_sums(values, strata, keep, x)
    mean = s1 / np.maximum(y, F32(1.0))
    ss = np.array([max(_fma(-(yi * mi), mi, qi), F32(0.0))
                   for yi, mi, qi in zip(y, mean, s2)], F32)
    s_sq = np.where(y > 1, ss / np.maximum(y - F32(1.0), F32(1.0)),
                    F32(0.0)).astype(F32)
    c_src = (y * w).astype(F32)
    fpc = np.maximum(c_src - y, F32(0.0))
    var_sum = np.where(y > 0, c_src * fpc * s_sq / np.maximum(y, F32(1.0)),
                       F32(0.0)).astype(F32)
    est_sum = F32(0.0)
    ht = F32(0.0)
    for i in range(x):
        est_sum = _fma(s1[i], w[i], est_sum)
        ht = _fma(y[i], w[i], ht)
    phi = (c_src / np.maximum(ht, F32(1.0))).astype(F32)
    est_mean = F32(0.0)
    for i in range(x):
        est_mean = _fma(phi[i], mean[i], est_mean)
    ratio = fpc / np.maximum(c_src, F32(1.0))
    var_mean = np.where((y > 0) & (c_src > 0),
                        phi * phi * s_sq / np.maximum(y, F32(1.0)) * ratio,
                        F32(0.0)).astype(F32)
    # Histogram: 64 equal bins from the least to the largest sampled value
    # (+1e-6), each bin the sum of its sampled items' weights.
    bins = tree.hist_bins
    sv = values[keep].astype(F32)
    lo, hi = F32(sv.min()), F32(sv.max())
    stop = F32(hi + F32(1e-6))
    step = (np.arange(bins, dtype=F32) / F32(bins)).astype(F32)
    edges = np.array([_fma(stop, st, lo * (F32(1.0) - st)) for st in step]
                     + [stop], F32)
    ix = np.clip(np.searchsorted(edges, sv, side="right") - 1, 0, bins - 1)
    wi = w[strata[keep]]
    hist = np.array([_seq_sum(wi[ix == b]) for b in range(bins)], F32)
    return {"ok": fill > 0, "sum": est_sum, "sum_var": _left_sum(var_sum)[0],
            "mean": est_mean, "mean_var": _left_sum(var_mean)[0],
            "n_sampled": int(keep.sum()), "histogram": hist,
            "root_c": _strata_sums(values, strata,
                                   np.arange(values.size) < fill, x)[0],
            "root_y": y}


def count_replay(tree: Tree, counts_per_tick) -> dict:
    """Every tick's flows from the ingest counts alone, with the
    counters a run accumulates over them in float32: a node keeps
    ``min(size, c)`` (the budgets conserve), a parent takes what fits.
    ``counts_per_tick`` is ``[ticks, fanin[0]]``."""
    caps, size = tree.capacities, tree.size
    n_levels = len(tree.fanin)
    acc = {"items_in": np.zeros(n_levels, F32),
           "items_kept": np.zeros(n_levels, F32),
           "flushes": np.zeros(n_levels, np.int64),
           "saturation_hits": np.zeros(n_levels, np.int64),
           "windows": 0, "dropped": [np.zeros(n, np.int64)
                                     for n in tree.fanin],
           "n_forwarded": [], "n_sampled": [], "ok": []}
    for counts in np.asarray(counts_per_tick, np.int64):
        fill = np.minimum(counts, caps[0])
        acc["dropped"][0] += counts - fill
        d_in = np.zeros(n_levels, F32)
        d_kept = np.zeros(n_levels, F32)
        fwd = []
        for lvl in range(n_levels):
            kept = np.minimum(fill, size)
            d_in[lvl] = F32(fill.sum())
            d_kept[lvl] = F32(kept.sum())
            if lvl == n_levels - 1:
                acc["windows"] += int(fill.sum() > 0)
                acc["ok"].append(bool(fill.sum() > 0))
                acc["n_sampled"].append(int(kept.sum()))
                break
            fwd.append(int(kept.sum()))
            parents = tree.fanin[lvl + 1]
            arrive = np.array([kept[p::parents].sum()
                               for p in range(parents)])
            fill = np.minimum(arrive, caps[lvl + 1])
            acc["dropped"][lvl + 1] += arrive - fill
        acc["items_in"] = (acc["items_in"] + d_in).astype(F32)
        acc["items_kept"] = (acc["items_kept"] + d_kept).astype(F32)
        flushed = d_in > 0
        acc["flushes"] += flushed
        acc["saturation_hits"] += flushed & (d_kept >= d_in)
        acc["n_forwarded"].append(fwd)
    return acc
