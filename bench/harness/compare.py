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

A cell whose configuration has tenants adds three numbers for their
standing queries (``check_queries``), over the first two epochs, the
last and ``n`` drawn from the window: each from the reference's own
state where the epoch before it was checked too (so the first two chain
from ``init``: the ring of windows turns over and the decayed table
carries state in the reference alone), else from the program's sketch
state at its start; every window's answers and bounds and the state it
ends in against the plain reference's:

* ``query_mismatches``: whole-number disagreements: COUNT answers,
  heavy-hitter keys, and the sketches' integer state (compaction counts,
  the ring's head, the top-k keys, each tenant's slot being live);
* ``query_answer_gap``: the largest relative gap of any other answer,
  and of the sketches' float state at the end of each checked epoch;
* ``query_bound_gap``: the largest relative gap of a bound.
"""
from __future__ import annotations

import math

import numpy as np

ANSWERS = ("sum", "sum_var", "mean", "mean_var")
NUMBERS = ("mismatches", "answer_gap", "histogram_gap")
QUERY_NUMBERS = ("query_mismatches", "query_answer_gap", "query_bound_gap")


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


def _gap(a, b, nonzero: bool = False) -> float:
    """The largest elementwise relative gap of ``a`` from ``b``; with
    ``nonzero``, over the slots where ``b`` is not 0 alone."""
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    if a.shape != b.shape:
        return math.inf
    if nonzero:
        a, b = a[b != 0], b[b != 0]
    if not a.size:
        return 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    d = np.where(a == b, 0.0, d)
    return float(np.where(np.isnan(d), math.inf, d).max())


def _differ(a, b) -> int:
    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    if a.shape != b.shape:
        return max(a.size, b.size, 1)
    return int(np.count_nonzero(a != b))


def compare_query_window(answers, bounds, ref_answers, ref_bounds,
                         exact, nonzero: bool = False
                         ) -> tuple[int, float, float]:
    """One window's answers and bounds: (whole-number slots that differ,
    largest gap of the other answers, largest gap of the bounds); the
    gaps as ``_gap`` takes them."""
    answers = np.asarray(answers)
    if answers.shape != ref_answers.shape:
        return max(answers.size, ref_answers.size), math.inf, math.inf
    return (_differ(answers[exact], ref_answers[exact]),
            _gap(answers[~exact], ref_answers[~exact], nonzero),
            _gap(bounds, ref_bounds, nonzero))


def compare_query_state(prog: list, ref: list, integer_fields,
                        nonzero: bool = False) -> tuple[int, float]:
    """The sketch state, tenant by tenant: (whole-number disagreements,
    largest gap of the float fields, as ``_gap`` takes it)."""
    mism, gap = abs(len(prog) - len(ref)), 0.0
    for p, r in zip(prog, ref):
        mism += int(not p["active"]) + abs(len(p["queries"]) - len(r))
        for a, b in zip(p["queries"], r):
            if a is None or b is None:
                mism += int((a is None) != (b is None))
                continue
            mism += len(set(a) ^ set(b))
            for f in set(a) & set(b):
                if f in integer_fields:
                    mism += _differ(a[f], b[f])
                else:
                    gap = max(gap, _gap(a[f], b[f], nonzero))
    return mism, gap


def draw_epochs(window_epochs: list[int], last: int, seed: int,
                n: int) -> list[int]:
    """The first two epochs, the last, and ``n`` of the window's drawn
    from the seed."""
    rng = np.random.default_rng((int(seed) % (1 << 63), 0x51C7))
    pick = rng.choice(len(window_epochs), size=min(n, len(window_epochs)),
                      replace=False)
    return sorted({0, 1, last} | {window_epochs[int(i)] for i in pick})


def check_queries(ref, tree, key, pool, epochs: list, qref, plan,
                  states: dict, checked: list[int], device) -> dict:
    """The standing queries over the ``checked`` epochs. ``epochs`` as in
    ``check_run``, with ``answers`` and ``bounds`` among each epoch's
    answers; ``states[e]``: the program's sketch state after epoch ``e``
    (``compare_query_state``'s layout) for every checked epoch and the
    one before it; ``qref`` the reference module, ``plan`` its ``Plan``
    of the configuration's tenants. An epoch starts from the reference's
    own state where the one before it is checked too, else from the
    program's (``init`` for the first). Beside the three numbers, the
    two gaps over the slots where the reference is not 0 (``.nonzero``),
    which no limit holds: a gap where it is 0 reads against ``_gap``'s
    floor of 1e-30."""
    ticks = epochs[0]["answers"]["tick"].shape[0]
    root_level = len(tree.fanin) - 1
    mism, agap, bgap, nagap, nbgap = 0, 0.0, 0.0, 0.0, 0.0
    own = {-1: plan.init()}
    for e in sorted(checked):
        state = (own[e - 1] if e - 1 in own else
                 [t["queries"] for t in states[e - 1]])
        ep = epochs[e]
        v, s, c = pool.epoch_host(ep["pool"])
        for i in range(ticks):
            t = e * ticks + i + 1
            r = ref.tick(tree, key, t, v[i], s[i], c[i], device=device)
            state, a, b = plan.window(state, r["root"],
                                      ref.node_key(key, t, root_level, 0),
                                      device=device)
            got = (ep["answers"]["answers"][i], ep["answers"]["bounds"][i],
                   a, b, plan.exact_slots)
            m, ga, gb = compare_query_window(*got)
            _, na, nb = compare_query_window(*got, nonzero=True)
            mism, agap, bgap = mism + m, max(agap, ga), max(bgap, gb)
            nagap, nbgap = max(nagap, na), max(nbgap, nb)
        m, g = compare_query_state(states[e], state, qref.INTEGER_FIELDS)
        _, ng = compare_query_state(states[e], state, qref.INTEGER_FIELDS,
                                    nonzero=True)
        mism, agap, nagap = mism + m, max(agap, g), max(nagap, ng)
        own[e] = state
    return {"query_mismatches": mism, "query_answer_gap": agap,
            "query_bound_gap": bgap, "query_answer_gap.nonzero": nagap,
            "query_bound_gap.nonzero": nbgap}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(name in numbers and numbers[name] <= limits[name]
               for name in limits)
