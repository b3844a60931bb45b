"""The train, prefill and decode steps.

The port of ``repro/optim/train_step.py``. The train step is the
weighted loss (``model.loss_fn``), its gradients by autograd (in each
parameter's dtype), then ``adamw.update``. The flash kernel has no
backward, in either package: training runs ``attention_impl="xla"``,
and ``"pallas"`` under autograd raises. Prefill and decode run under
``torch.inference_mode``, or under a model mesh ``torch.no_grad`` (DTensor
takes composite operations such as ``einsum`` decomposed, which inference
mode does not do for it). The same steps run sharded: called under
``launch.meshctx.use_mesh`` on trees that ``launch.sharding.distribute``
placed.
"""
from __future__ import annotations

import torch

from repro_torch.launch.meshctx import current_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw


def _no_autograd():
    return torch.no_grad() if current_mesh() is not None else \
        torch.inference_mode()


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig):
    """(params, opt_state, batch) → (params, opt_state, metrics); the
    parameters and the state are updated in place and returned. The
    metrics carry the reference's names: ``loss``, ``aux_loss``,
    ``tokens``, ``weight_sum``, ``grad_norm``, ``lr``, ``total_loss``."""

    def step(params, opt_state, batch):
        leaves = list(params.parameters())
        for t in leaves:
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = M.loss_fn(cfg, params, batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, leaves)]
        params, opt_state, opt_m = adamw.update(opt_cfg, grads, opt_state,
                                                params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, **opt_m, total_loss=loss.detach())
        return params, opt_state, metrics

    return step


def make_prefill_step(cfg):
    """(params, batch) → logits — inference prefill, no cache output."""

    def step(params, batch):
        with _no_autograd():
            logits, _ = M.forward(cfg, params, batch)
        return logits

    return step


def make_decode_step(cfg):
    """(params, cache, token, pos) → (logits, cache); the cache is
    updated in place."""

    def step(params, cache, token, pos):
        with _no_autograd():
            return M.decode_step(cfg, params, cache, token, pos)

    return step
