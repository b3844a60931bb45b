"""Training launcher: the end-to-end loop with the ApproxIoT data plane,
checkpoint/restart, straggler calibration, and adaptive budget control.

The port of ``repro.launch.train``: the same flags, the same printed
lines, and ``--device`` (the CUDA card unless ``--device cpu``). Each
step samples an interval of the token stream with ``whsamp`` on the
device, then runs the weighted loss, its gradients and AdamW
(``optim.train_step``). Fault tolerance:

  * checkpoint every ``--ckpt-every`` steps (atomic, keep-N, async), in
    the reference's on-disk layout (layers stacked on axis 0), so either
    package resumes from the other's;
  * auto-resume from the latest checkpoint in ``--ckpt-dir``;
  * SIGTERM → checkpoint of the step it ends → clean exit
    (preemption-safe: a resume goes on from that step);
  * per-shard deadline tracking; late shards are dropped and the loss
    re-weighted (unbiased — runtime/straggler.py).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --steps 200 --batch 8 --seq 256 --sampling-fraction 0.5 \\
        --device cpu
"""
from __future__ import annotations

import argparse
import os
import signal
import tempfile
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import registry
from repro_torch.data.pipeline import ApproxTrainPipeline, PipelineConfig
from repro_torch.data.stream import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import adamw, train_step
from repro_torch.runtime.budget import BudgetConfig, BudgetController
from repro_torch.runtime.straggler import DeadlineTracker, calibrate_weights


def _host_tree(params, opt_state):
    """(params, opt_state) as the reference checkpoints them: numpy
    trees, the layers stacked on axis 0."""
    return (convert.params_to_numpy(params),
            convert.opt_state_to_numpy(opt_state))


def _device_batch(batch: dict, dev: torch.device) -> dict:
    out = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    out["labels"] = out["labels"].long()
    return out


def _device_count(dev: torch.device) -> int:
    """Devices of the kind the run uses (one CPU device, as JAX counts)."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=registry.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--interval-size", type=int, default=32)
    ap.add_argument("--sampling-fraction", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--simulate-stragglers", type=float, default=0.0,
                    help="probability a shard misses its deadline")
    ap.add_argument("--exact", action="store_true",
                    help="disable sampling (native execution baseline)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model, the optimizer and the sampler "
                         "run (default: the CUDA card; it raises without "
                         "one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 20, 5))

    params = M.init_params(cfg, seed=0, device=dev)
    opt_state = adamw.init(params, device=dev)
    step_fn = train_step.make_train_step(cfg, opt_cfg)

    stream = TokenStream(cfg.vocab_size, args.seq, cfg.num_strata,
                         rates=list(np.linspace(1.0, 4.0, cfg.num_strata)))
    pipe_cfg = PipelineConfig(
        batch_size=args.batch, interval_size=args.interval_size,
        num_strata=cfg.num_strata,
        sampling_fraction=1.0 if args.exact else args.sampling_fraction)
    pipeline = ApproxTrainPipeline(pipe_cfg, stream, device=dev)
    budget = BudgetController(
        BudgetConfig(min_size=args.batch, max_size=args.interval_size,
                     target_latency_s=None),
        initial_size=int(args.interval_size * pipe_cfg.sampling_fraction))
    deadline = DeadlineTracker(num_shards=max(_device_count(dev), 4))
    rng = np.random.default_rng(0)

    start = 0
    latest = ckpt.latest_step(args.ckpt_dir)
    if latest is not None:
        (p_tree, o_tree), meta = ckpt.restore(
            args.ckpt_dir, latest, _host_tree(params, opt_state))
        params = convert.params_from_numpy(cfg, p_tree, dev)
        opt_state = convert.opt_state_from_numpy(o_tree, dev)
        start = int(meta.get("step", latest)) + 1
        print(f"[resume] from step {start}")
        if start >= args.steps:
            # The reference indexes an empty loss list here and raises.
            print(f"done: resumed at step {start} of --steps "
                  f"{args.steps}; nothing to train")
            return []

    checkpointer = ckpt.AsyncCheckpointer(args.ckpt_dir)
    stop = {"now": False}
    prev = signal.signal(signal.SIGTERM, lambda *a: stop.update(now=True))
    try:
        losses = _loop(args, start, params, opt_state, step_fn, pipeline,
                       budget, deadline, rng, checkpointer, stop)
    finally:
        signal.signal(signal.SIGTERM, prev)
    return losses


def _loop(args, start, params, opt_state, step_fn, pipeline, budget,
          deadline, rng, checkpointer, stop):
    dev = pipeline.device
    losses = []
    t_start = time.time()
    for step in range(start, args.steps):
        batch = pipeline.next_batch()
        # straggler simulation: shards that miss the deadline lose their
        # examples; Eq. 9 calibration keeps the loss unbiased.
        lat = rng.exponential(0.1, deadline.lat.shape[1]
                              if deadline.lat.size else 4)
        if args.simulate_stragglers > 0:
            lat = lat + (rng.random(lat.shape)
                         < args.simulate_stragglers) * 10.0
        present_shards = deadline.observe(lat)
        shard_of = np.arange(args.batch) % len(present_shards)
        present = present_shards[shard_of]
        if not present.all():
            batch["weight"] = calibrate_weights(batch["weight"], present)

        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state,
                                             _device_batch(batch, dev))
        loss = float(metrics["loss"])
        losses.append(loss)
        budget.update(latency_s=time.time() - t0)

        if step % args.log_every == 0:
            frac = pipeline.stats["sampled"] / max(pipeline.stats["arrived"], 1)
            print(f"step {step:5d} loss {loss:.4f} gnorm "
                  f"{float(metrics['grad_norm']):.3f} lr "
                  f"{float(metrics['lr']):.2e} sampled {frac:.2%} "
                  f"stragglers {int((~present).sum())}")
        if step and step % args.ckpt_every == 0 or stop["now"]:
            checkpointer.save(step, _host_tree(params, opt_state),
                              meta={"step": step})
            if stop["now"]:
                print("[sigterm] checkpointed, exiting")
                break
    else:
        # The reference writes this one after a SIGTERM too, under the
        # last step's number, so its resume skips the steps not taken;
        # here the SIGTERM checkpoint stays the newest.
        checkpointer.save(args.steps - 1, _host_tree(params, opt_state),
                          meta={"step": args.steps - 1})
    checkpointer.wait()
    dt = time.time() - t_start
    print(f"done: {len(losses)} steps in {dt:.1f}s "
          f"({len(losses) / max(dt, 1e-9):.2f} steps/s); "
          f"loss {losses[0]:.4f} → {np.mean(losses[-5:]):.4f}")
    return losses


if __name__ == "__main__":
    main()
