"""End-to-end example on the PyTorch/CUDA port: train a small LM with the
ApproxIoT data plane.

The same job as ``examples/approx_train.py``, run by
``repro_torch.launch.train``: the token stream is stratified by domain,
each interval is reservoir-sampled within a budget and the surviving
examples carry weights, so the weighted loss is an unbiased estimate of
the full-stream loss. Trains the smoke smollm-135m config with
checkpoint/restart and straggler calibration enabled. It runs on a CUDA
card by default; ``--device cpu`` runs it on the CPU:

    PYTHONPATH=src python examples/approx_train_torch.py [--steps 200] \\
        [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.launch import train

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--fraction", type=float, default=0.5)
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                   "approx_train_torch_ckpt"))
args = ap.parse_args()

losses = train.main([
    "--arch", "smollm-135m", "--smoke",
    "--steps", str(args.steps),
    "--batch", "8",
    "--seq", "128",
    "--interval-size", "24",
    "--sampling-fraction", str(args.fraction),
    "--simulate-stragglers", "0.05",     # 5% of shards miss their deadline
    "--ckpt-dir", args.ckpt_dir,
    "--log-every", "20",
    "--device", args.device,
])
print(f"\ntrained {len(losses)} steps at sampling fraction "
      f"{args.fraction:.0%} with straggler calibration; "
      f"loss {losses[0]:.3f} → {losses[-1]:.3f}")
