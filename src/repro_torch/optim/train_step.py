"""The prefill and decode steps the serving path runs.

The port of ``repro/optim/train_step.py``'s inference half. Both steps
run under ``torch.inference_mode``. Training (``make_train_step``, AdamW)
is not ported: it is the training half of ROADMAP Queue 1 item 13, and
since the reference's flash kernel has no backward it will train with
``attention_impl="xla"``, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M


def make_train_step(cfg, opt_cfg=None):
    raise NotImplementedError(
        "training is not ported yet: it is the training half of ROADMAP.md "
        "Queue 1 item 13 (optim/, data/pipeline.py, launch/train.py); the "
        "port serves the dense and vlm families")


def make_prefill_step(cfg):
    """(params, batch) → logits — inference prefill, no cache output."""

    def step(params, batch):
        with torch.inference_mode():
            logits, _ = M.forward(cfg, params, batch)
        return logits

    return step


def make_decode_step(cfg):
    """(params, cache, token, pos) → (logits, cache); the cache is
    updated in place."""

    def step(params, cache, token, pos):
        with torch.inference_mode():
            return M.decode_step(cfg, params, cache, token, pos)

    return step
