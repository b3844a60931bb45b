"""Faults planted under the timed path for the benchmark's tests: each
must turn the output check's ``correct`` false."""
from __future__ import annotations

import torch


def _state_unchanged():
    """``run_epoch`` returns the state it was given."""
    from repro_torch.api.pipeline import CompiledPipeline

    orig = CompiledPipeline.run_epoch

    def run_epoch(self, state, key, values, strata, counts, budgets=None):
        _, wa = orig(self, state, key, values, strata, counts, budgets)
        return state, wa

    CompiledPipeline.run_epoch = run_epoch


def _half_batch():
    """Half of the level-0 nodes' ingest is left out, the answers taken
    over the rest."""
    from repro_torch.api.pipeline import CompiledPipeline

    orig = CompiledPipeline.run_epoch

    def run_epoch(self, state, key, values, strata, counts, budgets=None):
        counts = torch.as_tensor(counts).clone()
        counts[:, counts.shape[1] // 2:] = 0
        return orig(self, state, key, values, strata, counts, budgets)

    CompiledPipeline.run_epoch = run_epoch


def _answer_altered():
    """The root's SUM altered where it is produced."""
    from repro_torch.core import tree

    orig = tree._whs_root_core

    def root_core(*args, **kwargs):
        outs, q = orig(*args, **kwargs)
        return (outs[0] * (1.0 + 1e-5),) + tuple(outs[1:]), q

    tree._whs_root_core = root_core


def _item_altered():
    """One forwarded item's value altered where a level produces it."""
    from repro_torch.core import whs

    orig = whs.level_tick

    def level_tick(*args, **kwargs):
        v_c, s_c, slot_valid, meta, result = orig(*args, **kwargs)
        v_c = v_c.clone()
        v_c[0, 0] += 1.0
        return v_c, s_c, slot_valid, meta, result

    whs.level_tick = level_tick


def _hh_key_flipped():
    """The top heavy-hitter key's lowest bit flipped where the sketch
    produces it."""
    from repro_torch.query import sketches

    orig = sketches.hh_update

    def hh_update(sk, keys, weights):
        out = orig(sk, keys, weights)
        key = out.key.clone()
        key[0] = torch.where(key[0] == sketches.HH_EMPTY_KEY, key[0],
                             key[0] ^ 1)
        return out._replace(key=key)

    sketches.hh_update = hh_update


def _compaction_offset():
    """Each compaction's random offset ``u`` moved by one half."""
    from repro_torch.query import sketches

    orig = sketches._fold_level

    def fold_level(u, *args, **kwargs):
        return orig(torch.remainder(u + 0.5, 1.0), *args, **kwargs)

    sketches._fold_level = fold_level


def _decay_skipped():
    """The decayed heavy hitters' table not decayed."""
    from repro_torch.query import sketches

    def decayed(sk, keys, weights, decay):
        return sketches.hh_update(sk, keys, weights)

    sketches.hh_decayed_update = decayed


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered, "item_altered": _item_altered,
          "hh_key_flipped": _hh_key_flipped,
          "compaction_offset": _compaction_offset,
          "decay_skipped": _decay_skipped}


def plant(name: str) -> None:
    if name:
        FAULTS[name]()
