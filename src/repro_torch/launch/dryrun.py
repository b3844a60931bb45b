"""Production-mesh dry run: every (arch × shape × mesh) cell's step, run
abstractly on one process, with its cost per chip.

The port of ``repro/launch/dryrun.py``. The reference lowers and
compiles each cell over 512 placeholder host devices. Here one process
joins a ``fake`` process group of 256 or 512 ranks (torch's testing
backend: collectives are accepted and move nothing) as rank 0 and
builds the production ``DeviceMesh`` on it; the parameters, the AdamW
state and the inputs are ``meta`` tensors (shapes and dtypes, no
storage), distributed by the sharding rules; the train, prefill or
decode step runs on them under ``use_mesh`` and ``hlocost.OpCost``,
which counts what rank 0 dispatches: its FLOPs, bytes and collectives
per chip. That proves the rules, the model's mesh paths and DTensor's
propagation are coherent at full size without the hardware, and gives
the roofline terms (``analysis``, the H100 SXM's peaks). Cells that
``shape_applicable`` rules out are recorded as skipped, with the
reference's reason.

Records are JSON files under ``build/dryrun/`` (``--out``), one per
cell, reused unless ``--force``.

Usage:
    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--force]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.launch import analysis, hlocost, sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.meshctx import use_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw, train_step

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"


def _fake_group(world: int) -> None:
    """Make this process rank 0 of a ``fake`` group of ``world`` ranks
    (replacing a fake group of another size)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # pragma: no cover - torch without it
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"torch does not have: {e}") from e
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run makes its own fake process "
                               "group; this process already runs "
                               f"{dist.get_backend()!r}")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(tree) -> int:
    """This rank's bytes of a tree of (D)Tensors: its local shards."""
    if isinstance(tree, torch.nn.Module):
        return sum(_local_bytes(t) for t in tree.parameters())
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    t = tree.to_local() if hasattr(tree, "to_local") else tree
    return t.numel() * t.element_size()


def cell_step(cfg, shape, mesh):
    """One cell's step on ``mesh`` with abstract inputs placed by the
    rules → ``(call, argument bytes of this rank by part)``: ``call()``
    runs the step."""
    params = M.init_params(cfg, 0, "meta")
    p_spec = sharding.param_specs(params, mesh)
    specs = registry.input_specs(cfg, shape)
    args_bytes = {}
    if shape.kind == "train":
        opt = adamw.init(params, "meta")
        sharding.distribute(params, p_spec, mesh)
        opt = sharding.distribute(
            opt, sharding.opt_state_specs(None, p_spec, mesh), mesh)
        batch = sharding.distribute(
            specs, sharding.batch_specs(specs, mesh), mesh)
        args_bytes["opt_state"] = _local_bytes(opt)
        step = train_step.make_train_step(cfg, adamw.AdamWConfig())
        call = lambda: step(params, opt, batch)           # noqa: E731
    elif shape.kind == "prefill":
        sharding.distribute(params, p_spec, mesh)
        batch = sharding.distribute(
            specs, sharding.batch_specs(specs, mesh), mesh)
        step = train_step.make_prefill_step(cfg)
        call = lambda: step(params, batch)                # noqa: E731
    else:  # decode
        sharding.distribute(params, p_spec, mesh)
        cache = sharding.distribute(
            specs["cache"], sharding.cache_specs_tree(specs["cache"], mesh),
            mesh)
        token = sharding.distribute(
            {"token": specs["token"]},
            sharding.batch_specs({"token": specs["token"]}, mesh),
            mesh)["token"]
        batch = {"token": token, "cache": cache}
        step = train_step.make_decode_step(cfg)
        pos = shape.seq_len - 1
        call = lambda: step(params, cache, token, pos)    # noqa: E731
    args_bytes["params"] = _local_bytes(params)
    args_bytes["inputs"] = _local_bytes(batch)
    return call, args_bytes


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool):
    """Run one cell abstractly; returns its record."""
    cfg = registry.get_config(arch)
    shape = SHAPES[shape_name]
    chips = 512 if multi_pod else 256
    _fake_group(chips)
    mesh = make_production_mesh(multi_pod=multi_pod)

    t0 = time.time()
    call, args_bytes = cell_step(cfg, shape, mesh)
    flash_seq = shape.seq_len if cfg.attention_impl == "flash_costed" else None
    with use_mesh(mesh):
        _, cost = hlocost.analyze(call, zero_s2_seq=flash_seq)
    run_s = time.time() - t0

    rec = analysis.summarize(cost, chips=chips,
                             argument_bytes=sum(args_bytes.values()))
    rec["memory"].update({f"{k}_bytes": v for k, v in args_bytes.items()})
    if flash_seq:
        rec["attention"] = "flash (S² scores repriced off HBM)"
    # MODEL_FLOPS: 6·N·D train / 2·N·D prefill+decode (per chip, active N)
    n_act = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * n_act * tokens / chips
    rec.update(
        arch=arch, shape=shape_name, mesh="2x16x16" if multi_pod else "16x16",
        kind=shape.kind, seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        params=cfg.param_count(), active_params=n_act,
        model_flops_per_chip=model_flops,
        model_vs_counted=model_flops / max(rec["flops_per_chip"], 1.0),
        run_s=round(run_s, 2),
    )
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, force=False,
             verbose=True, out_dir=None):
    out_dir = pathlib.Path(out_dir or RESULTS)
    out_dir.mkdir(parents=True, exist_ok=True)
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    out = out_dir / f"{arch}__{shape_name}__{mesh_tag}.json"
    if out.exists() and not force:
        if verbose:
            print(f"[skip-cached] {out.name}")
        return json.loads(out.read_text())

    cfg = registry.get_config(arch)
    ok, why = shape_applicable(cfg, SHAPES[shape_name])
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "skipped": True, "reason": why}
        out.write_text(json.dumps(rec, indent=1))
        if verbose:
            print(f"[skip-n/a]    {arch} × {shape_name}: {why}")
        return rec

    try:
        rec = lower_cell(arch, shape_name, multi_pod=multi_pod)
        if verbose:
            t = rec["terms"]
            print(f"--- {arch} × {shape_name} × {mesh_tag} ---")
            print(f"flops/chip={rec['flops_per_chip']:.3e} "
                  f"bytes/chip={rec['bytes_per_chip']:.3e} "
                  f"coll/chip={rec['collective_bytes_per_chip']:.3e} "
                  f"args/chip={rec['memory']['argument_bytes']:.3e} | "
                  f"compute={t['compute_s']:.4f}s memory={t['memory_s']:.4f}s "
                  f"coll={t['collective_s']:.4f}s dominant={t['dominant']} "
                  f"(run {rec['run_s']}s; computed on the CPU, H100 SXM "
                  f"peaks)", flush=True)
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        if verbose:
            print(f"[FAIL] {arch} × {shape_name} × {mesh_tag}: {e}",
                  flush=True)
    out.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None,
                    help=f"record directory (default {RESULTS})")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = ([(a, s) for a in registry.ARCH_NAMES for s in SHAPES]
             if args.all else [(args.arch, args.shape)])
    failures = 0
    try:
        for mp in meshes:
            for arch, shape in cells:
                rec = run_cell(arch, shape, multi_pod=mp, force=args.force,
                               out_dir=args.out)
                failures += 1 if "error" in rec else 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
