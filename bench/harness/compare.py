"""The output check: what the timed path produced against the plain
reference, as a few numbers, each held to its limit.

* ``mismatches``: whole-number disagreements. Every window of the run
  (since ``init``) against the reference's flows from the ingest counts:
  the tick, ``ok``, ``n_sampled`` and each level's ``n_forwarded``; the
  state carried out of the window: its tick, each level's fill and
  dropped counters, and the telemetry counters; and, on the windows
  drawn for the full reference, ``ok``, ``n_sampled`` and
  ``n_forwarded`` again and every slot of the last tick's level buffers
  (values and strata).
* ``answer_gap``: the largest relative gap of ``sum``, ``sum_var``,
  ``mean`` and ``mean_var`` over the drawn windows, and of the last
  tick's flushed per-stratum metadata (Eq. 9 weights and counts) where
  the stratum was present.
* ``histogram_gap``: the largest gap of a histogram bin over the drawn
  windows, relative to the reference histogram's total weight.
"""
from __future__ import annotations

import math

import numpy as np

ANSWERS = ("sum", "sum_var", "mean", "mean_var")
NUMBERS = ("mismatches", "answer_gap", "histogram_gap")


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    if math.isnan(a) or math.isnan(b):
        return math.inf
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(b), 1e-30)


def compare_tick(prog: dict, ref: dict) -> tuple[int, float, float]:
    """One window: (mismatches, answer gap, histogram gap)."""
    mism = int(bool(prog["ok"]) != bool(ref["ok"]))
    mism += int(int(prog["n_sampled"]) != int(ref["n_sampled"]))
    mism += sum(int(int(a) != int(b)) for a, b in
                zip(prog["n_forwarded"], ref["n_forwarded"]))
    mism += abs(len(prog["n_forwarded"]) - len(ref["n_forwarded"]))
    gap = max(_rel(prog[f], ref[f]) for f in ANSWERS)
    h_ref = np.asarray(ref["histogram"], np.float64)
    h_prog = np.asarray(prog["histogram"], np.float64)
    if h_prog.shape != h_ref.shape or not np.all(np.isfinite(h_prog)):
        hgap = math.inf
    else:
        hgap = float(np.abs(h_prog - h_ref).max()
                     / max(np.abs(h_ref).sum(), 1e-30))
    return mism, gap, hgap


def compare_levels(prog_levels, ref_levels) -> tuple[int, float]:
    """The last tick's buffers and flushed metadata, level by level:
    (slots that differ, metadata gap)."""
    mism, gap = 0, 0.0
    for p, r in zip(prog_levels, ref_levels):
        for f in ("values", "strata"):
            a, b = np.asarray(p[f]), np.asarray(r[f])
            mism += (int(np.count_nonzero(a != b)) if a.shape == b.shape
                     else max(a.size, b.size))
        seen = np.asarray(r["seen"], bool)
        for f in ("w", "c"):
            a = np.asarray(p[f], np.float64)
            b = np.asarray(r[f], np.float64)
            if a.shape != b.shape:
                return mism + 1, math.inf
            if not seen.any():
                mism += int(np.count_nonzero(a != b))
                continue
            d = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
            d = np.where(np.isnan(d), math.inf, d)
            gap = max(gap, float(d[seen].max()))
    mism += abs(len(prog_levels) - len(ref_levels))
    return mism, gap


def draw_ticks(window_ticks: list[int], last: int, seed: int,
               n: int) -> list[int]:
    """``n`` of the window's ticks drawn from the seed, and the last."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    pick = rng.choice(len(window_ticks), size=min(n, len(window_ticks)),
                      replace=False)
    return sorted({window_ticks[int(i)] for i in pick} | {last})


def check_run(ref, tree, key, pool, epochs: list, final: dict, seed: int,
              device, n_sample: int) -> dict:
    """``epochs``: every epoch since ``init`` in order, each
    ``{"pool", "window", "answers"}`` with host answers ``[T,
    ...]``; ``final``: the state after the last epoch on the host."""
    ticks = epochs[0]["answers"]["tick"].shape[0]
    counts = np.concatenate([pool.counts_host(ep["pool"]) for ep in epochs])
    flows = ref.count_replay(tree, counts)
    mism = 0
    k = 0
    window_ticks = []
    for ep in epochs:
        a = ep["answers"]
        for i in range(ticks):
            mism += int(int(a["tick"][i]) != k + 1)
            want = {"ok": flows["ok"][k], "n_sampled": flows["n_sampled"][k],
                    "n_forwarded": flows["n_forwarded"][k]}
            got = {"ok": a["ok"][i], "n_sampled": a["n_sampled"][i],
                   "n_forwarded": list(a["n_forwarded"][i])}
            mism += int(bool(got["ok"]) != bool(want["ok"]))
            mism += int(int(got["n_sampled"]) != int(want["n_sampled"]))
            mism += sum(int(int(x) != int(y)) for x, y in
                        zip(got["n_forwarded"], want["n_forwarded"]))
            if ep["window"]:
                window_ticks.append(k)
            k += 1
    mism += int(int(final["tick"]) != k + 1)
    for lvl, lv in enumerate(final["levels"]):
        mism += int(np.count_nonzero(np.asarray(lv["fill"]) != 0))
        mism += int(np.count_nonzero(np.asarray(lv["dropped"])
                                     != flows["dropped"][lvl]))
    tel = final["telemetry"]
    for f in ("items_in", "items_kept", "flushes", "saturation_hits"):
        mism += int(np.count_nonzero(
            np.asarray(tel[f], np.float64) != np.asarray(flows[f],
                                                         np.float64)))
    mism += int(int(tel["windows"]) != flows["windows"])

    gap, hgap = 0.0, 0.0
    for k in draw_ticks(window_ticks, k - 1, seed, n_sample):
        ep = epochs[k // ticks]
        i = k % ticks
        v, s, c = pool.epoch_host(ep["pool"])
        r = ref.tick(tree, key, k + 1, v[i], s[i], c[i], device=device)
        a = ep["answers"]
        prog = {f: a[f][i] for f in ("ok", "n_sampled", "histogram")
                + ANSWERS}
        prog["n_forwarded"] = list(a["n_forwarded"][i])
        m, g, h = compare_tick(prog, r)
        mism += m
        gap, hgap = max(gap, g), max(hgap, h)
        if k == len(counts) - 1:
            m, w = compare_levels(final["levels"], r["levels"])
            mism += m
            gap = max(gap, w)
    return {"mismatches": mism, "answer_gap": gap, "histogram_gap": hgap}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(name in numbers and numbers[name] <= limits[name]
               for name in limits)
