"""Planted faults in the ``flash_attention`` kernel, read by
``chip_smoke.py``'s checks, on a CUDA card.

For each case — the kernel as it is, then one broken copy per fault —
``src/`` and ``chip_smoke.py`` are copied into a temporary directory, the
fault is written into the copy's ``csrc/flash_attention.cu`` (into the
bf16 tensor-core kernel that the bf16 checks run, and where the f32
kernel shares or repeats the faulty line, into it too), and a child
process runs there: the kernel against its plain version at SmolLM-135M's
attention shape, then ``chip_smoke.run_prefill`` (SmolLM-135M's bf16
prefill, pallas against xla, and the f32 B 1 S 512 prefill against the
CPU), then ``chip_smoke.family_prefill`` for qwen2-moe-a2.7b (2 layers,
B 4, S 2048, bf16: pallas against xla, with the share of tokens routed
alike), each with its failures printed instead of fatal. Each case prints
what the checks read: the argmax agreement and max abs difference of the
bf16 prefills, the f32 differences, and which checks failed. The
checkout itself is never changed.

    python3 tools/flash_planted_faults.py
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = Path("src/repro_torch/csrc/flash_attention.cu")
# name → ((text of the kernel, its faulty replacement), ...); empty: the
# kernel as it is. The kv-head mapping is one function both kernels call;
# the causal mask is planted wherever it is stated: the bf16 kernel's
# scores, its rescoring, and the f32 kernel.
FAULTS = {
    "none": (),
    "kv-head mapping h % Hkv": (("(bh % hq) / (hq / hkv)",
                                 "(bh % hq) % hkv"),),
    "causal mask admits one future token": (
        ("if (col > row) s[i] = kNegInf;",
         "if (col > row + 1) s[i] = kNegInf;"),
        ("kv0 + col_of(owner, i) > q0 + row_of(owner, i)",
         "kv0 + col_of(owner, i) > q0 + row_of(owner, i) + 1"),
        ("k0 + c <= row", "k0 + c <= row + 1")),
}
CHILD = """
import sys
import torch
sys.path.insert(0, "src")
import chip_smoke as C
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import ops, ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
failed = []
C.fail = lambda msg: (failed.append(msg), print("check failed:", msg))
dev = torch.device("cuda", 0)
q, k, v = C.flash_inputs(C.SMOLLM_ATTN, torch.bfloat16, 99, dev)
got, want = ops.flash_attention(q, k, v), ref.flash_attention(q, k, v)
print(f"kernel vs plain {C.SMOLLM_ATTN} bf16: max abs "
      f"{C.max_abs(got, want)}, within one bf16 ulp: "
      f"{C.flash_agrees(got, want)}")
del q, k, v, got, want
C.run_prefill(dev, LAUNCHES, reset_launches)
print(f"prefill checks failed: {len(failed)}")
n = len(failed)
C.family_prefill("qwen2-moe-a2.7b", dev, LAUNCHES, reset_launches,
                 "this card")
print(f"qwen2-moe prefill checks failed: {len(failed) - n}")
"""


def main() -> int:
    rc = 0
    for name, fault in FAULTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(ROOT / "src", Path(tmp) / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", tmp)
            src = Path(tmp) / KERNEL
            text = src.read_text()
            for old, new in fault:
                if text.count(old) != 1:
                    print(f"{name}: {old!r} is not once in {KERNEL}")
                    return 1
                text = text.replace(old, new)
            src.write_text(text)
            print(f"== fault: {name}", flush=True)
            rc |= subprocess.run([sys.executable, "-c", CHILD],
                                 cwd=tmp).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
