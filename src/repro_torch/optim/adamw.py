"""AdamW with an f32 master copy, global-norm clipping and a
warmup-cosine schedule.

The port of ``repro/optim/adamw.py``. The state mirrors the parameters:
``m``, ``v`` and ``master`` are f32 ``Params`` modules of the same tree
(``master`` a copy of every leaf in f32, f32 leaves too), ``step`` an
int32 scalar. Gradients come in each parameter's dtype; the update runs
in f32, applies weight decay to every leaf, and casts the new master
back to each leaf's dtype. ``update`` writes the new values into the
given parameter and state tensors (the reference donates them and
returns new ones) and returns them; nothing waits for the device.

Sharded (DTensor parameters, under ``launch.meshctx.use_mesh``): each
gradient is first reduced to its parameter's placement (a reduce-scatter
over "data" for the FSDP dims, an all-reduce where the parameter is
replicated), the global norm is taken over the whole tensors, and
``m``, ``v`` and ``master`` stay sharded as their parameter
(``init`` mirrors each leaf's placement; ``step`` is replicated, as
``launch.sharding.opt_state_specs`` says).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.layers import Params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to
    ``min_lr_ratio · lr`` at ``total_steps``; f32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * torch.clamp(t, 0, 1)))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _mirror(params: nn.Module, leaf) -> Params:
    """A ``Params`` tree shaped like ``params``, each tensor ``leaf(t)``;
    its ``parameters()`` come in the same order as ``params``'."""
    def conv(mod):
        out = {name: leaf(t) for name, t in mod._parameters.items()}
        for name, sub in mod._modules.items():
            out[name] = ([conv(m) for m in sub]
                         if isinstance(sub, nn.ModuleList) else conv(sub))
        return out

    return Params(conv(params))


def init(params: Params, device="cuda") -> dict:
    """Zero moments and an f32 master copy on ``device`` (CUDA unless
    asked otherwise), where ``params`` must already be."""
    dev = resolve_device(device)
    for t in params.parameters():
        if t.device != dev:
            raise ValueError(f"adamw.init: the parameters are on {t.device}"
                             f", not {dev}; pass device={t.device.type!r}")
    f32 = torch.float32
    return {
        "m": _mirror(params, lambda p: torch.zeros_like(p, dtype=f32)),
        "v": _mirror(params, lambda p: torch.zeros_like(p, dtype=f32)),
        "master": _mirror(params, lambda p: p.detach().to(f32, copy=True)),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tensors))


def _placed_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient reduced and laid out as its parameter."""
    from torch.distributed.tensor import DTensor

    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: dict, params: Params):
    """``grads``: one per tensor of ``params.parameters()``, in its order
    → ``(params, state, {"grad_norm", "lr"})``."""
    grads = [_placed_as(g, p) for g, p in zip(grads, params.parameters(),
                                              strict=True)]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    for g, p, m, v, master in zip(grads, params.parameters(),
                                  state["m"].parameters(),
                                  state["v"].parameters(),
                                  state["master"].parameters(),
                                  strict=True):
        # The reference's expressions, term by term and rounded as there,
        # computed in place where a term is no longer needed.
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)            # b1·m + (1−b1)·g
        v.mul_(cfg.b2).add_(((1 - cfg.b2) * g).mul_(g))  # b2·v + (1−b2)·g·g
        upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        upd.add_(cfg.weight_decay * master).mul_(lr)
        master.sub_(upd)
        p.copy_(master)
    state = dict(state, step=step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
