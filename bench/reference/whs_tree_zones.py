"""``whs_tree``'s plain reference for deployments of many strata.

``whs_tree._strata_sums`` walks a row once a stratum: at the taxi
deployment's 263 zones, 263 masks over each 2.7M-slot row, most of a
run's output check. Here a row's items are sorted once by stratum, by a
stable sort, so that each stratum's items keep their slot order, and
each stratum's float32 sums run over its run of the sorted row: the
same additions in the same order, so every number is bitwise
``whs_tree``'s. Everything else is ``whs_tree``'s own code, loaded as a
module of its own so that the swap leaves ``whs_tree`` as it is; any
name not defined here is that module's (``tick``, ``Tree``,
``count_replay``, ``root_key``, ``node_key``, ...). Imports nothing of
``repro_torch``.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np


def _load_whs_tree():
    path = Path(__file__).with_name("whs_tree.py")
    spec = importlib.util.spec_from_file_location("bench_ref_whs_tree_base",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


_base = _load_whs_tree()
F32 = _base.F32


def _strata_sums(values, strata, mask, num_strata):
    """Per stratum: (count, Σx, Σx²) over ``mask``, float32 in item
    order (``whs_tree._strata_sums``), by one stable sort of the row."""
    s = np.asarray(strata)[mask]
    v = np.asarray(values)[mask].astype(F32)
    inside = (s >= 0) & (s < num_strata)
    s, v = s[inside], v[inside]
    order = np.argsort(s.astype(np.int16 if num_strata <= 2**15 else s.dtype),
                       kind="stable")
    s, v = s[order], v[order]
    bounds = np.searchsorted(s, np.arange(num_strata + 1), side="left")
    c = np.diff(bounds).astype(F32)
    s1 = np.zeros(num_strata, F32)
    s2 = np.zeros(num_strata, F32)
    sq = v * v
    for x in np.flatnonzero(c):
        run = slice(bounds[x], bounds[x + 1])
        s1[x] = np.add.accumulate(v[run])[-1]
        s2[x] = np.add.accumulate(sq[run])[-1]
    return c, s1, s2


_base._strata_sums = _strata_sums


def __getattr__(name):
    return getattr(_base, name)
