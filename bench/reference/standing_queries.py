"""Plain reference of the tenants' standing queries.

Written from the algorithms for the benchmark's check, in numpy float32,
sharing no code with the program under test. Every root window, each
tenant's queries are answered from the root's weighted sample
(``whs_tree.tick``'s ``root``: the buffer's values and strata, the
``keep`` mask and each stratum's Eq. 9 weight ``W``); an item's weight
is its stratum's ``W`` if sampled, else 0.

* **CLT queries** (ApproxIoT §III-D): per stratum the sample's count
  ``Y``, ``Σx`` and ``Σx²`` in item order; SUM ``Σ Σx·W`` (Eq. 3) with
  Eq. 11's variance, COUNT the Horvitz-Thompson ``Σ Y·W``, MEAN Eq.
  13-14; a bound is ``2·√variance``.
* **Histograms**: each bin the sum, in item order, of its sampled items'
  weights over ``linspace(lo, hi, bins + 1)`` (out-of-range values to
  the end bins); the variance ``Σ w·max(w − 1, 0)``.
* **Quantiles**: a KLL sketch (Karnin, Lang, Liberty, FOCS 2016) of ``L``
  levels of ``C`` slots (``L`` = 1, 2 or 4 as ``C`` < 16, < 64 or not).
  A batch enters level 0; a level whose live points (weight > 0) exceed
  ``C`` compacts: its points sorted by value (stably), their cumulative
  weights, ``m`` targets ``(k + u)·W/m`` with a random offset ``u``; each
  target picks the slot whose ``[cum. before, cum.)`` holds it (the sum
  of all such slots, in slot order), ``W/m`` each; ``m = C/2`` go up a
  level, the top level keeps ``m = C`` in place. A level that fits is
  packed, its live points first in value order. The bound is ``2·√(Σ
  q²)/W`` over the compactions. A query reads the first point whose
  cumulative weight exceeds ``q·W``.
* **Windowed quantiles**: a ring of ``R`` sub-sketches, one a window,
  merged level by level into one sketch when queried.
* **Heavy hitters**: a weighted count-min table (Cormode, Muthukrishnan,
  2005), ``depth`` rows of ``width`` buckets under the multiply-shift
  hash ``(A_d·key mod 2³²) >> (32 − log₂ width)``, keys the values
  rounded half to even; the top ``k`` of the last top-``k`` and the
  window's keys by their count-min estimate (ties to the smaller key,
  then to the earlier slot). The decayed table is ``γ·counts + batch``.

What the configuration fixes, and the reference keeps, so that a sound
run reads 0:

* the draws: query ``i``'s offset at level ``h`` is Threefry's uniform of
  ``fold_in(fold_in(fold_in(root, 0x51C7), i), h)``, and the windowed
  merge's of ``fold_in(fold_in(fold_in(fold_in(root, 0x51C7), i),
  0x574D), h)``, ``root`` the root node's key of the window (as
  ``whs_tree`` derives it);
* the orders of addition: cumulative weights as a blocked scan (16-slot
  blocks summed left to right, the block totals scanned the same way);
  ``a·b + c`` rounded once where the estimators contract it (the
  decayed update, the estimators' dot products); sums over the strata
  left to right;
* the search a quantile query makes: the bisection ``mid = lo + (hi −
  lo)//2`` for the first cumulative weight above ``q·W`` (the blocked
  scan can fall by an ulp at a block's edge, so where it does the answer
  depends on the search).

Two sums have no order the configuration fixes: a quantile sketch's
total weight and the count-min table's first row, which scale the
bounds. They are taken here in float64 and rounded once.

``precision="bfloat16"`` holds the sampled values and item weights in
bfloat16 (the comparison's control). The stable sorts run as tensor
operations on ``device``; everything else in numpy on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import whs_tree as wt

F32 = np.float32
EMPTY_KEY = 2**31 - 1
HASH_MULTIPLIERS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
                    0x165667B1, 0xD3A2646D)
QUERY_TAG = 0x51C7
WINDOW_MERGE_TAG = 0x574D
BLOCK = 16
DEFAULTS = {"lo": 0.0, "hi": 1.0, "bins": 32, "qs": (), "capacity": 256,
            "k": 8, "width": 1024, "depth": 4, "window": 8, "decay": 0.9}
SKETCH_KINDS = ("quantile", "windowed_quantile")
HH_KINDS = ("heavy_hitters", "decayed_heavy_hitters")
# Whole-number fields of a sketch's state, compared exactly.
INTEGER_FIELDS = ("compactions", "head", "key")


# ------------------------------------------------------------- helpers --
def uniform(key) -> np.float32:
    """Threefry's uniform in [0, 1) of a key, as ``whs_tree.uniforms``
    draws its first."""
    y0, y1 = wt._threefry(key[0], key[1], 0, 0)
    bits = np.uint32((((y0 ^ y1) >> 9) | 0x3F800000) & 0xFFFFFFFF)
    return F32(bits.view(F32) - F32(1.0))


def fma(a, b, c):
    """``a·b + c``, the product exact in float64, rounded to float32."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def fma_dot(a, b) -> np.float32:
    acc = F32(0.0)
    for x, y in zip(a, b):
        acc = F32(fma(x, y, acc))
    return acc


def left_sum(x) -> np.float32:
    x = np.asarray(x, F32)
    acc = x[0]
    for v in x[1:]:
        acc = F32(acc + v)
    return acc


def sqrt_rn(x):
    return np.sqrt(np.asarray(x, np.float64)).astype(F32)


def bf16(x):
    """Round float32 to the nearest bfloat16, ties to even."""
    b = np.asarray(x, F32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(F32)


def argsort(x, device) -> np.ndarray:
    """The stable ascending order of ``x`` (equal keys by index)."""
    x = np.asarray(x)
    if x.size < 4096 or torch.device(device).type == "cpu":
        return np.argsort(x, kind="stable")
    return torch.argsort(torch.as_tensor(x, device=device),
                         stable=True).cpu().numpy()


def blocked_cumsum(x) -> np.ndarray:
    """Inclusive cumulative sum in 16-slot blocks, each left to right;
    the block totals scanned the same way, each block's prefix added."""
    x = np.asarray(x, F32)
    n = x.size
    if n <= BLOCK:
        return np.add.accumulate(x) if n else x.copy()
    nb = -(-n // BLOCK)
    blk = np.zeros(nb * BLOCK, F32)
    blk[:n] = x
    within = np.add.accumulate(blk.reshape(nb, BLOCK), axis=1)
    totals = blocked_cumsum(within[:, -1])
    out = within.copy()
    out[1:] += totals[:-1, None]
    return out.reshape(-1)[:n]


def upper_bound(a, t) -> int:
    """The bisection's first index with ``a[i] > t``."""
    lo, hi = 0, len(a)
    while lo < hi:
        mid = lo + ((hi - lo) >> 1)
        if not a[mid] > t:
            lo = mid + 1
        else:
            hi = mid
    return lo


def interval_sum(values, lo, hi, targets) -> np.ndarray:
    """Each target's sum, from 0.0 in slot order, of the values of the
    slots with ``lo ≤ target < hi``."""
    values, lo, hi = (np.asarray(a, F32) for a in (values, lo, hi))
    t = np.asarray(targets, F32)
    out = np.zeros(t.size, F32)
    if np.all(t[1:] >= t[:-1]):
        # Only a slot whose interval is not empty can hold a target.
        nonempty = np.flatnonzero(lo < hi)
        values, lo, hi = values[nonempty], lo[nonempty], hi[nonempty]
        k0 = np.searchsorted(t, lo, side="left")
        k1 = np.searchsorted(t, hi, side="left")
        n = np.maximum(k1 - k0, 0)
        slot = np.repeat(np.arange(values.size), n)
        first = np.repeat(np.cumsum(n) - n, n)
        k = np.repeat(k0, n) + np.arange(slot.size) - first
    else:
        slot, k = np.nonzero((lo[:, None] <= t[None, :])
                             & (t[None, :] < hi[:, None]))
    np.add.at(out, k, values[slot])
    return out


# -------------------------------------------------------------- quantile --
def levels_of(capacity: int) -> int:
    return 1 if capacity < 16 else 2 if capacity < 64 else 4


def quantile_init(capacity: int) -> dict:
    n = levels_of(capacity)
    return {"value": np.zeros((n, capacity), F32),
            "weight": np.zeros((n, capacity), F32),
            "compactions": F32(0.0), "err_q2": F32(0.0)}


def _fold_level(u, lvl_v, lvl_w, add_v, add_w, m_up: int, device):
    """One level takes extra points: packed where its live points fit,
    else compacted (``m_up`` of them carried up; none at the top)."""
    cap = lvl_v.size
    m = cap if m_up == 0 else m_up
    v = np.concatenate([lvl_v, add_v]).astype(F32)
    w = np.concatenate([lvl_w, np.maximum(add_w, F32(0.0))]).astype(F32)
    order = argsort(v, device)
    v_s, w_s = v[order], w[order]
    cum = blocked_cumsum(w_s)
    total = cum[-1]
    live = w_s > 0
    empty = np.zeros(0, F32)
    if int(live.sum()) <= cap:
        # Live points first, each part in value order.
        pack = np.concatenate([np.flatnonzero(live),
                               np.flatnonzero(~live)])[:cap]
        carry = np.zeros(m_up, F32)
        return v_s[pack], w_s[pack], carry, carry, F32(0.0), F32(0.0)
    q = F32(total / F32(m))
    t = (np.arange(m, dtype=F32) + F32(u)) * q
    lo = np.concatenate([np.zeros(1, F32), cum[:-1]])
    picked = interval_sum(v_s, lo, cum, t)
    vmax = v_s[live].max()
    picked = np.where(t >= total, vmax, picked).astype(F32)
    pw = np.full(m, q, F32)
    if m_up == 0:
        return picked, pw, empty, empty, F32(1.0), F32(q * q)
    zeros = np.zeros(cap, F32)
    return zeros, zeros, picked, pw, F32(1.0), F32(q * q)


def _fold_all(u, sk: dict, incoming, device) -> dict:
    """Cascade per-level extra points (or ``None``) up the sketch."""
    levels, cap = sk["value"].shape
    carry_v = carry_w = np.zeros(0, F32)
    comp, err = F32(sk["compactions"]), F32(sk["err_q2"])
    rows_v, rows_w = [], []
    for h in range(levels):
        add_v, add_w = [carry_v], [carry_w]
        if incoming[h] is not None:
            add_v.append(incoming[h][0])
            add_w.append(incoming[h][1])
        m_up = 0 if h == levels - 1 else cap // 2
        nv, nw, carry_v, carry_w, did, q2 = _fold_level(
            u[h], sk["value"][h], sk["weight"][h], np.concatenate(add_v),
            np.concatenate(add_w), m_up, device)
        rows_v.append(nv)
        rows_w.append(nw)
        comp, err = F32(comp + did), F32(err + q2)
    return {"value": np.stack(rows_v), "weight": np.stack(rows_w),
            "compactions": comp, "err_q2": err}


def quantile_update(u, sk: dict, values, weights, device) -> dict:
    return _fold_all(u, sk, [(values, weights)]
                     + [None] * (sk["value"].shape[0] - 1), device)


def quantile_query(sk: dict, qs) -> np.ndarray:
    v = sk["value"].reshape(-1)
    w = sk["weight"].reshape(-1)
    order = np.argsort(v, kind="stable")
    v_s, w_s = v[order], w[order]
    cum = blocked_cumsum(w_s)
    total = cum[-1]
    if not total > 0:
        return np.zeros(len(qs), F32)
    vmax = v_s[w_s > 0].max()
    out = []
    for q in np.clip(np.asarray(qs, F32), F32(0.0), F32(1.0)):
        i = upper_bound(cum, F32(q * total))
        out.append(v_s[i] if i < v_s.size else vmax)
    return np.asarray(out, F32)


def rank_error_bound(sk: dict) -> np.float32:
    if not sk["compactions"] > 0:
        return F32(0.0)
    total = F32(np.sum(sk["weight"], dtype=np.float64))
    return F32(F32(F32(2.0) * sqrt_rn(sk["err_q2"]))
               / max(total, F32(1e-30)))


def windowed_init(capacity: int, window: int) -> dict:
    n = levels_of(capacity)
    return {"value": np.zeros((window, n, capacity), F32),
            "weight": np.zeros((window, n, capacity), F32),
            "compactions": np.zeros(window, F32),
            "err_q2": np.zeros(window, F32), "head": np.int32(0)}


def windowed_update(u, sk: dict, values, weights, device) -> dict:
    """The window's sub-sketch replaces the oldest; the head moves on."""
    _, levels, cap = sk["value"].shape
    sub = quantile_update(u, quantile_init(cap), values, weights, device)
    head = int(sk["head"])
    out = {f: np.array(sk[f], copy=True) for f in
           ("value", "weight", "compactions", "err_q2")}
    for f in out:
        out[f][head] = sub[f]
    out["head"] = np.int32((head + 1) % sk["value"].shape[0])
    return out


def windowed_merged(u, sk: dict, device) -> dict:
    _, levels, cap = sk["value"].shape
    base = {"value": np.zeros((levels, cap), F32),
            "weight": np.zeros((levels, cap), F32),
            "compactions": left_sum(sk["compactions"]),
            "err_q2": left_sum(sk["err_q2"])}
    incoming = [(sk["value"][:, h, :].reshape(-1),
                 sk["weight"][:, h, :].reshape(-1)) for h in range(levels)]
    return _fold_all(u, base, incoming, device)


# --------------------------------------------------------- heavy hitters --
def hh_init(k: int, width: int, depth: int) -> dict:
    return {"counts": np.zeros((depth, width), F32),
            "key": np.full(k, EMPTY_KEY, np.int32),
            "est": np.zeros(k, F32)}


def buckets(keys, depth: int, width: int) -> np.ndarray:
    """[depth, M] multiply-shift buckets of the keys taken as uint32."""
    k = np.asarray(keys).astype(np.int64).astype(np.uint64) & np.uint64(
        0xFFFFFFFF)
    mult = np.asarray(HASH_MULTIPLIERS[:depth], np.uint64)
    prod = (k[None, :] * mult[:, None]) & np.uint64(0xFFFFFFFF)
    shift = 32 - (width - 1).bit_length()
    if shift >= 32:
        return np.zeros(prod.shape, np.int64)
    return (prod >> np.uint64(shift)).astype(np.int64)


def cms_batch(keys, weights, depth: int, width: int) -> np.ndarray:
    """The batch's table: each bucket its items' weights added from 0.0
    in item order."""
    out = np.zeros((depth, width), F32)
    nz = weights > 0
    b = buckets(keys[nz], depth, width)
    for d in range(depth):
        np.add.at(out[d], b[d], weights[nz])
    return out


def refresh_topk(counts, cand, k: int, device):
    """The ``k`` distinct candidate keys of highest estimate."""
    cand = np.asarray(cand, np.int32)
    depth, width = counts.shape
    b = buckets(cand, depth, width)
    est = counts[np.arange(depth)[:, None], b].min(axis=0)
    est = np.where(cand == EMPTY_KEY, F32(-1.0), est).astype(F32)
    order = argsort(cand, device)
    ks, es = cand[order], est[order]
    first = np.concatenate([[True], ks[1:] != ks[:-1]])
    score = np.where(first & (ks != EMPTY_KEY), es, F32(-1.0)).astype(F32)
    top = argsort(-score, device)[:k]
    top_est = score[top]
    key = np.where(top_est >= 0, ks[top], EMPTY_KEY).astype(np.int32)
    return key, np.maximum(top_est, F32(0.0)).astype(F32)


def hh_update(sk: dict, keys, weights, device, decay=None) -> dict:
    batch = cms_batch(keys, weights, *sk["counts"].shape)
    if decay is None:
        counts = (sk["counts"] + batch).astype(F32)
    else:
        counts = fma(F32(decay), sk["counts"], batch)
    cand = np.concatenate([sk["key"], np.where(weights > 0, keys,
                                               EMPTY_KEY)])
    key, est = refresh_topk(counts, cand, sk["key"].size, device)
    return {"counts": counts, "key": key, "est": est}


# ------------------------------------------------------------------ plan --
def _spec(q: dict) -> dict:
    out = dict(DEFAULTS)
    out.update(q)
    out["qs"] = tuple(float(x) for x in out["qs"])
    return out


def out_width(q: dict) -> int:
    return {"sum": 1, "count": 1, "mean": 1, "histogram": q["bins"],
            "quantile": len(q["qs"]), "windowed_quantile": len(q["qs"]),
            "heavy_hitters": 2 * q["k"],
            "decayed_heavy_hitters": 2 * q["k"]}[q["kind"]]


class Plan:
    """The tenants of a configuration (its ``tenants`` list), answered
    every window into one vector: the tenants' blocks in order, each its
    queries' slots in order."""

    def __init__(self, tenants: list, num_strata: int):
        self.tenants = [{"name": t["name"],
                         "queries": [_spec(q) for q in t["queries"]]}
                        for t in tenants]
        self.num_strata = int(num_strata)
        exact = []
        for t in self.tenants:
            kinds = {q["kind"] for q in t["queries"]}
            t["shared_total"] = {"count", "mean"} <= kinds
            t["levels"] = max([levels_of(q["capacity"]) for q in
                               t["queries"] if q["kind"] in SKETCH_KINDS],
                              default=0)
            for q in t["queries"]:
                w = out_width(q)
                if q["kind"] == "count":
                    exact += [True]
                elif q["kind"] in HH_KINDS:
                    exact += [True] * q["k"] + [False] * q["k"]
                else:
                    exact += [False] * w
        self.exact_slots = np.asarray(exact, bool)
        self.n_out = self.exact_slots.size

    def init(self) -> list:
        """Each tenant's state: per query its sketch (``None`` for the
        CLT queries and histograms)."""
        out = []
        for t in self.tenants:
            st = []
            for q in t["queries"]:
                if q["kind"] == "quantile":
                    st.append(quantile_init(q["capacity"]))
                elif q["kind"] == "windowed_quantile":
                    st.append(windowed_init(q["capacity"], q["window"]))
                elif q["kind"] in HH_KINDS:
                    st.append(hh_init(q["k"], q["width"], q["depth"]))
                else:
                    st.append(None)
            out.append(st)
        return out

    def window(self, state: list, root: dict, root_key,
               precision: str = "float32", device="cpu"):
        """One window from the root's sample and the root node's key:
        ``(state', answers f32[n_out], bounds f32[n_out])``."""
        x = self.num_strata
        values = np.asarray(root["values"], F32)
        strata = np.asarray(root["strata"], np.int64)
        keep = np.asarray(root["keep"], bool)
        w = np.asarray(root["weight"], F32)
        w_item = (w[np.clip(strata, 0, x - 1)] * keep.astype(F32)).astype(F32)
        if precision == "bfloat16":
            values, w_item = bf16(values), bf16(w_item)
        elif precision != "float32":
            raise ValueError(f"unknown precision {precision!r}")
        y, s1, s2 = wt._strata_sums(values, strata, keep, x)
        keys = np.rint(values).astype(np.int32)
        kq = wt.fold_in(root_key, QUERY_TAG)
        answers, bounds, new_state = [], [], []
        for t, st in zip(self.tenants, state):
            clt = _clt(y, s1, s2, w, t["shared_total"])
            rows = []
            for i, (q, sk) in enumerate(zip(t["queries"], st)):
                ki = wt.fold_in(kq, i)
                u = [uniform(wt.fold_in(ki, h)) for h in range(t["levels"])]
                kind = q["kind"]
                if kind in clt:
                    a, b = clt[kind]
                elif kind == "histogram":
                    a, b = _histogram(q, values, keep, w_item)
                elif kind == "quantile":
                    sk = quantile_update(u, sk, values, w_item, device)
                    a = quantile_query(sk, q["qs"])
                    b = np.full(len(q["qs"]), rank_error_bound(sk), F32)
                elif kind == "windowed_quantile":
                    sk = windowed_update(u, sk, values, w_item, device)
                    km = wt.fold_in(ki, WINDOW_MERGE_TAG)
                    um = [uniform(wt.fold_in(km, h))
                          for h in range(t["levels"])]
                    merged = windowed_merged(um, sk, device)
                    a = quantile_query(merged, q["qs"])
                    b = np.full(len(q["qs"]), rank_error_bound(merged), F32)
                elif kind in HH_KINDS:
                    sk = hh_update(sk, keys, w_item, device,
                                   q["decay"] if kind ==
                                   "decayed_heavy_hitters" else None)
                    total = F32(np.sum(sk["counts"][0], dtype=np.float64))
                    eps = F32(F32(2.0 / q["width"]) * total)
                    a = np.concatenate([sk["key"].astype(F32), sk["est"]])
                    b = np.concatenate([np.zeros(q["k"], F32),
                                        np.full(q["k"], eps, F32)])
                else:
                    raise ValueError(f"no reference for query kind {kind!r}")
                answers.append(np.asarray(a, F32).reshape(-1))
                bounds.append(np.asarray(b, F32).reshape(-1))
                rows.append(sk)
            new_state.append(rows)
        return new_state, np.concatenate(answers), np.concatenate(bounds)


def _sample_variance(y, s1, s2):
    mean = s1 / np.maximum(y, F32(1.0))
    ss = np.maximum(fma(-(y * mean), mean, s2), F32(0.0))
    return np.where(y > 1, ss / np.maximum(y - F32(1.0), F32(1.0)),
                    F32(0.0)).astype(F32)


def _clt(y, s1, s2, w, shared_total: bool) -> dict:
    """SUM, COUNT and MEAN with their 2σ bounds from the moments."""
    s_sq = _sample_variance(y, s1, s2)
    c_src = (y * w).astype(F32)
    fpc = np.maximum(c_src - y, F32(0.0))
    var_sum = left_sum(np.where(y > 0, c_src * fpc * s_sq
                                / np.maximum(y, F32(1.0)), F32(0.0)))
    count = left_sum(c_src) if shared_total else fma_dot(y, w)
    phi = (c_src / max(count, F32(1.0))).astype(F32)
    ratio = fpc / np.maximum(c_src, F32(1.0))
    var_mean = left_sum(np.where((y > 0) & (c_src > 0),
                                 phi * phi * s_sq / np.maximum(y, F32(1.0))
                                 * ratio, F32(0.0)))
    mean = fma_dot(phi, s1 / np.maximum(y, F32(1.0)))

    def bound(var):
        return np.asarray([F32(2.0) * sqrt_rn(max(var, F32(0.0)))], F32)

    return {"sum": ([fma_dot(s1, w)], bound(var_sum)),
            "count": ([count], np.zeros(1, F32)),
            "mean": ([mean], bound(var_mean))}


def _histogram(q: dict, values, keep, w_item):
    bins = int(q["bins"])
    s = np.arange(bins, dtype=F32) / F32(bins)
    edges = np.concatenate([F32(q["lo"]) * (F32(1.0) - s) + F32(q["hi"]) * s,
                            [F32(q["hi"])]]).astype(F32)
    ix = np.clip(np.searchsorted(edges, values, side="right") - 1, 0,
                 bins - 1)
    ws = w_item[keep]
    est = np.zeros(bins, F32)
    var = np.zeros(bins, F32)
    np.add.at(est, ix[keep], ws)
    np.add.at(var, ix[keep], (ws * np.maximum(ws - F32(1.0), F32(0.0)))
              .astype(F32))
    return est, (F32(2.0) * sqrt_rn(np.maximum(var, F32(0.0)))).astype(F32)
