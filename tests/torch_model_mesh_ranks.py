"""What each rank of a spawned model mesh runs in the model-mesh tests.

The rank processes import this module (never JAX, never the reference):
``run_rank`` builds the rank's ``DeviceMesh``, puts carried weights,
AdamW state and batches on it by the sharding rules, runs the port's
train step, attention, prefill and moe under ``use_mesh`` and returns
host arrays (gathered whole, so every rank returns the same), which the
tests hold against the reference's sharded runs; and what this rank's
flash kernel wrapper and einsum core were called with.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_model_mesh, model_mesh_ledger
from repro_torch.launch.meshctx import use_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw
from repro_torch.optim import train_step as T


def host(x):
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    return convert._host_weight(x)


def torch_batch(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in
            batch.items()}


def cfg_of(arch: str, **kw):
    import dataclasses

    return dataclasses.replace(registry.get_config(arch).reduced(), **kw)


def train_step(mesh, arch: str, kw: dict, params_np: dict, batch_np: dict,
               opt: dict, device, steps: int = 1) -> dict:
    """``steps`` sharded train steps from carried weights; the metrics of
    each, and the parameters, ``m`` and ``v`` after, gathered."""
    cfg = cfg_of(arch, **kw)
    params = convert.params_from_numpy(cfg, params_np, device)
    state = adamw.init(params, device)
    p_spec = SH.param_specs(params, mesh)
    SH.distribute(params, p_spec, mesh)
    state = SH.distribute(state, SH.opt_state_specs(None, p_spec, mesh),
                          mesh)
    batch = torch_batch(batch_np, device)
    batch = SH.distribute(batch, SH.batch_specs(batch, mesh), mesh)
    step = T.make_train_step(cfg, adamw.AdamWConfig(**opt))
    metrics = []
    with use_mesh(mesh):
        for _ in range(steps):
            params, state, met = step(params, state, batch)
            metrics.append({k: float(SH.gather_tensor(v))
                            for k, v in met.items()})
    return {"metrics": metrics, "params": convert.params_to_numpy(params),
            "m": convert.params_to_numpy(state["m"]),
            "v": convert.params_to_numpy(state["v"])}


class CoreCalls:
    """Within the block, every call of the flash kernel's wrapper (as
    ``layers`` reaches it) and of the einsum core is counted, and each
    wrapper call's arguments recorded: whether each is a plain tensor,
    and its shape. ``first`` keeps the first call's q, k, v and output
    on the host."""

    def __init__(self):
        self.flash: list[tuple[tuple[bool, ...], tuple[tuple, ...]]] = []
        self.einsum = 0
        self.first = None

    def __enter__(self):
        from torch.distributed.tensor import DTensor

        self._real = (L.flash_ops.flash_attention, L._scores_then_values)
        real_flash, real_core = self._real

        def flash(q, k, v):
            ts = (q, k, v)
            self.flash.append((tuple(not isinstance(t, DTensor) for t in ts),
                               tuple(tuple(t.shape) for t in ts)))
            o = real_flash(q, k, v)
            if self.first is None:
                self.first = tuple(t.detach().cpu() for t in (q, k, v, o))
            return o

        def core(*args, **kw):
            self.einsum += 1
            return real_core(*args, **kw)

        L.flash_ops.flash_attention, L._scores_then_values = flash, core
        return self

    def __exit__(self, *exc):
        L.flash_ops.flash_attention, L._scores_then_values = self._real
        return False

    def record(self) -> dict:
        return {"flash": list(self.flash), "einsum": self.einsum}


def attention(mesh, arch: str, kw: dict, p_np: dict, x_np, device,
              impl: str = "xla"):
    """``layers.attention`` under the mesh, causal, from carried
    weights, its core as ``impl`` says; the output gathered."""
    cfg = cfg_of(arch, **kw)
    p = L.Params({k: torch.from_numpy(np.array(v)).to(device)
                  for k, v in p_np.items()})
    SH.distribute(p, SH.param_specs({"attn": p}, mesh)["attn"], mesh)
    x = torch.from_numpy(np.array(x_np)).to(device)
    b, s, _ = x.shape
    x = SH.distribute_tensor(x, SH.P("data"), mesh)
    pos = torch.arange(s, device=device)[None].expand(b, s)
    with use_mesh(mesh):
        out = L.attention(p, cfg, x, pos, attn_impl=impl)
    return host(out)


def prefill(mesh, arch: str, kw: dict, params_np: dict, batch_np: dict,
            device) -> dict:
    """A sharded prefill (``make_prefill_step``) from carried weights with
    ``attention_impl="pallas"``: the logits gathered, and this rank's
    calls of the flash wrapper and the einsum core."""
    cfg = cfg_of(arch, attention_impl="pallas", **kw)
    params = convert.params_from_numpy(cfg, params_np, device)
    SH.distribute(params, SH.param_specs(params, mesh), mesh)
    batch = torch_batch(batch_np, device)
    batch = SH.distribute(batch, SH.batch_specs(batch, mesh), mesh)
    with use_mesh(mesh), CoreCalls() as calls:
        logits = T.make_prefill_step(cfg)(params, batch)
    return {"logits": host(logits), "calls": calls.record()}


def refusals(mesh, device) -> dict:
    """What raises: the flash wrapper given DTensors, and a sharded train
    step of a reduced SmolLM-135M with ``attention_impl="pallas"`` (the
    kernel has no backward); each error's type and message."""
    out = {}
    q = SH.distribute_tensor(torch.zeros((2, 2, 16, 32), device=device),
                             SH.P("data", "model"), mesh)
    try:
        L.flash_ops.flash_attention(q, q, q)
    except TypeError as e:
        out["dtensor"] = ("TypeError", str(e))
    cfg = cfg_of("smollm-135m", attention_impl="pallas")
    params = M.init_params(cfg, 0, device)
    state = adamw.init(params, device)
    spec = SH.param_specs(params, mesh)
    SH.distribute(params, spec, mesh)
    state = SH.distribute(state, SH.opt_state_specs(None, spec, mesh), mesh)
    rng = np.random.default_rng(0)
    batch = torch_batch({"tokens": rng.integers(0, cfg.vocab_size, (4, 32)),
                         "labels": rng.integers(0, cfg.vocab_size, (4, 32))},
                        device)
    batch = SH.distribute(batch, SH.batch_specs(batch, mesh), mesh)
    step = T.make_train_step(cfg, adamw.AdamWConfig())
    try:
        with use_mesh(mesh):
            step(params, state, batch)
    except RuntimeError as e:
        out["train"] = ("RuntimeError", str(e))
    return out


def moe_forward(mesh, p_np: dict, x_np, cf: float, device):
    """``moe_apply`` under the mesh (qwen2-moe, reduced): the output and
    aux gathered, and this rank's kept set and choices, recorded from
    ``moe.select`` as it runs."""
    cfg = cfg_of("qwen2-moe-a2.7b")
    p = convert.params_from_numpy(cfg, {"moe": p_np}, device)["moe"]
    SH.distribute(p, SH.param_specs({"moe": p}, mesh)["moe"], mesh)
    x = torch.from_numpy(np.array(x_np)).to(device)
    x = SH.distribute_tensor(x, SH.P("data"), mesh)
    seen, real = [], MOE.select

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((out[1].cpu().numpy(), out[3].cpu().numpy()))
        return out

    MOE.select = spy
    try:
        with use_mesh(mesh):
            y, aux = MOE.moe_apply(p, cfg, x, capacity_factor=cf)
    finally:
        MOE.select = real
    return {"y": host(y), "aux": host(aux), "ix": seen[0][0],
            "keep": seen[0][1]}


def run_rank(shape, axes, device: str, backend: str, job: dict) -> dict:
    """Every part of ``job`` on this rank (see the tests for what each
    holds)."""
    mesh = make_model_mesh(shape, axes, device=device, backend=backend)
    dev = torch.device(device if device == "cpu" else "cuda:0")
    out: dict = {"rank": torch.distributed.get_rank(),
                 "coords": mesh.get_coordinate()}
    for name, (arch, kw, params_np, batch_np) in job.get("train",
                                                         {}).items():
        out[f"train/{name}"] = train_step(mesh, arch, kw, params_np,
                                          batch_np, job["opt"], dev,
                                          job.get("steps", 1))
    for name, (arch, kw, impl, p_np, x_np) in job.get("attention",
                                                      {}).items():
        out[f"attention/{name}"] = attention(mesh, arch, kw, p_np, x_np, dev,
                                             impl)
    for name, (arch, kw, params_np, batch_np) in job.get("prefill",
                                                         {}).items():
        out[f"prefill/{name}"] = prefill(mesh, arch, kw, params_np,
                                         batch_np, dev)
    if job.get("refusals"):
        out["refusals"] = refusals(mesh, dev)
    for name, (p_np, x_np, cf) in job.get("moe", {}).items():
        out[f"moe/{name}"] = moe_forward(mesh, p_np, x_np, cf, dev)
    return out


def card_train_step(shape, arch: str) -> dict:
    """One sharded train step of a reduced ``arch`` on gloo ranks sharing
    ``cuda:0``, from seeded weights; rank 0 also takes the one-rank card
    step from the same weights and batch. Metrics, parameters, ``m``
    and ``v`` come back on the host (gathered)."""
    mesh = make_model_mesh(shape, ("data", "model"), device="cuda",
                           backend="gloo")
    dev = torch.device("cuda", 0)
    cfg = cfg_of(arch)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 64)),
             "labels": rng.integers(0, cfg.vocab_size, (4, 64)),
             "weight": rng.uniform(0.5, 3.0, 4).astype(np.float32)}
    batch = torch_batch(batch, dev)
    step = T.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                     total_steps=10))
    params = M.init_params(cfg, 0, dev)
    state = adamw.init(params, dev)
    spec = SH.param_specs(params, mesh)
    SH.distribute(params, spec, mesh)
    state = SH.distribute(state, SH.opt_state_specs(None, spec, mesh), mesh)
    placed = SH.distribute(batch, SH.batch_specs(batch, mesh), mesh)
    with use_mesh(mesh):
        params, state, met = step(params, state, placed)
    out = {"metrics": {k: float(SH.gather_tensor(v)) for k, v in
                       met.items()},
           "params": convert.params_to_numpy(params),
           "m": convert.params_to_numpy(state["m"]),
           "v": convert.params_to_numpy(state["v"]),
           "ledger": model_mesh_ledger(mesh).totals()}
    if torch.distributed.get_rank() == 0:
        p1 = M.init_params(cfg, 0, dev)
        p1, s1, met1 = step(p1, adamw.init(p1, dev), batch)
        out["one_rank"] = {"metrics": {k: float(v) for k, v in
                                       met1.items()},
                           "params": convert.params_to_numpy(p1),
                           "m": convert.params_to_numpy(s1["m"]),
                           "v": convert.params_to_numpy(s1["v"])}
    return out


def card_prefill(arch: str, kw: dict) -> dict:
    """A bf16 sharded prefill of a reduced ``arch`` (with ``kw``) through
    the flash kernel on gloo ranks sharing ``cuda:0`` (data 2 × model 2),
    B 4, S 128: this rank's flash launches, its first call's q, k, v and
    output, and its coordinates."""
    from repro_torch.kernels import LAUNCHES

    mesh = make_model_mesh((2, 2), ("data", "model"), device="cuda",
                           backend="gloo")
    dev = torch.device("cuda", 0)
    cfg = cfg_of(arch, attention_impl="pallas", param_dtype=torch.bfloat16,
                 **kw)
    params = M.init_params(cfg, 0, dev)
    SH.distribute(params, SH.param_specs(params, mesh), mesh)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 128))).to(dev)
    batch = {"tokens": toks}
    batch = SH.distribute(batch, SH.batch_specs(batch, mesh), mesh)
    before = LAUNCHES["flash_attention"]
    with use_mesh(mesh), CoreCalls() as calls:
        T.make_prefill_step(cfg)(params, batch)
    torch.cuda.synchronize(dev)
    return {"coords": tuple(mesh.get_coordinate()),
            "launches": LAUNCHES["flash_attention"] - before,
            "core": calls.first, "layers": cfg.num_layers}
