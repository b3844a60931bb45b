"""The single-card model path of two source trees of the port, in one
call on one CUDA card: prefill, decode and a train step, with the mesh
code of one tree absent from the other.

    python3 tools/model_path_ab.py OTHER_TREE

``OTHER_TREE`` is another checkout of the repository (for example the
parent commit unpacked with ``git archive``). Each tree runs in a
process of its own, in the order other, this, this, other, twice (the
host's speed drifts over a call and differs between processes, which
the host-bound decode loops feel most, so each time is the median of
several calls and each tree is read from four processes), and builds
its kernels into its own ``build/``. Per model, in bf16 with random
weights from seed 0 (``chip_smoke.py``'s generators, this tree's):

* SmolLM-135M at full depth, B 8, S 2048, and the zoo's families at
  ``chip_smoke.FAMILY_RUNS``' shapes and depths (whisper-medium and
  zamba2-1.2b whole, qwen2-moe-a2.7b and rwkv6-7b cut to 2 layers):
  the prefill step (``attention_impl="pallas"``), ms a forward, the
  median of 5 after a warm-up (host clock around a call and a
  ``synchronize``), and the device's busy share of one more
  (``chip_smoke.busy_share``: a trace of the device alone, for both
  trees alike);
* ``launch.serve.serve_batch`` at B 8, an 8-token prompt and 8 decoded
  tokens (15 decode steps): ms a batch, the median of 3 after a
  warm-up, and ms a decode step;
* for SmolLM-135M, a train step at B 8, S 256 (``attention_impl=
  "xla"``, AdamW at lr 1e-3): ms a step, the median of 3 after a
  warm-up.

Prints the card's name and power limit, then one JSON line per run.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODELS = {"smollm-135m": (8, 2048, 0, None)}   # as chip_smoke.FAMILY_RUNS
PROMPT, DECODE, SERVE_B = 8, 8, 8
TRAIN_B, TRAIN_S = 8, 256


def _ms(fn, reps: int) -> float:
    """The median ms of ``reps`` calls of ``fn``, each timed alone."""
    import statistics

    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def measure(tree: Path) -> dict:
    import dataclasses

    import torch

    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.optim import train_step as T

    dev = torch.device("cuda", 0)
    out = {"tree": str(tree)}
    for arch, (b, s, frames, depth) in {**MODELS, **C.FAMILY_RUNS}.items():
        cfg = dataclasses.replace(registry.get_config(arch),
                                  attention_impl="pallas",
                                  **({"num_layers": depth} if depth else {}))
        params = M.init_params(cfg, seed=0, device=dev)
        batch = C.family_batch(cfg, b, s, frames,
                               torch.Generator().manual_seed(21), dev)
        prefill = T.make_prefill_step(cfg)
        prefill(params, batch)                              # warm-up
        rec = {"prefill_ms": _ms(lambda: prefill(params, batch), 5)}
        busy = C.busy_share(lambda: prefill(params, batch))
        rec["prefill_tokens_s"] = b * s / rec["prefill_ms"] * 1e3
        rec["prefill_busy"] = busy["busy_ms"] / busy["wall_ms"]
        del batch
        toks = torch.randint(0, cfg.vocab_size, (SERVE_B, PROMPT),
                             generator=torch.Generator().manual_seed(22))
        toks = toks.to(dev)
        serve.serve_batch(cfg, params, toks, DECODE)         # warm-up
        rec["serve_batch_ms"] = _ms(
            lambda: serve.serve_batch(cfg, params, toks, DECODE), 3)
        rec["decode_step_ms"] = rec["serve_batch_ms"] / (PROMPT - 1 + DECODE)
        if arch in MODELS:
            tcfg = dataclasses.replace(cfg, attention_impl="xla")
            tb = C.family_batch(tcfg, TRAIN_B, TRAIN_S, 0,
                                torch.Generator().manual_seed(24), dev,
                                train=True)
            step = T.make_train_step(tcfg, adamw.AdamWConfig(
                lr=1e-3, warmup_steps=2, total_steps=10))
            state = adamw.init(params, dev)
            step(params, state, tb)                          # warm-up
            rec["train_step_ms"] = _ms(lambda: step(params, state, tb), 3)
            del state, tb
        out[arch] = rec
        del params
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(Path(sys.argv[2]))))
        return
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    import torch

    if not torch.cuda.is_available():
        sys.exit("model_path_ab: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    other = Path(sys.argv[1]).resolve()
    for tree in (other, ROOT, ROOT, other) * 2:
        run = subprocess.run([sys.executable, __file__, "--measure",
                              str(tree)], capture_output=True, text=True)
        if run.returncode != 0:
            sys.exit(f"model_path_ab: {tree} failed:\n{run.stderr[-3000:]}")
        print(run.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
