"""How the bf16 flash attention's one-ulp agreement depends on the order
of the q.k sums, on a CUDA card.

For each seed, q, k and v at SmolLM-135M's attention shape (B 8, Hq 9,
Hkv 3, S 2048, D 64, bf16) go through the plain version
(``kernels/flash_attention/ref.py``, whose f32 matmul sums each q.k as a
sequential FMA chain) and through two others: the card's kernel, and the
same plain version with only its q.k summed in f64 (then rounded to f32).
For each it prints how many outputs lie more than one bf16 ulp from the
plain version's (``chip_smoke.flash_agrees``' measure) and in which rows.
A p rounded to bf16 from a score whose last bits differ can move an
output of a row with few keys by two ulps; the kernel rescores such p in
the plain version's order, so it should show none.

    python3 tools/flash_rounding_check.py [seeds]
"""
from __future__ import annotations

import sys
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402


def plain_f64_scores(q, k, v):
    """``ref.flash_attention`` with q.k summed in f64, rounded to f32."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group, scale, f32 = hq // hkv, 1.0 / (d ** 0.5), torch.float32
    blk = ref.block_size(s)
    nb = s // blk
    qf = q.reshape(b, hkv, group, nb, blk, d).to(f32)
    m = torch.full((b, hkv, group, nb, blk, 1), -1e30, dtype=f32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, group, nb, blk, d), dtype=f32, device=q.device)
    tril = torch.ones((blk, blk), dtype=torch.bool, device=q.device).tril()
    for j in range(nb):
        kj = k[:, :, None, None, j * blk:(j + 1) * blk].to(f32)
        vj = v[:, :, None, None, j * blk:(j + 1) * blk]
        sc = torch.matmul(qf[:, :, :, j:].double(),
                          kj.transpose(-1, -2).double()).to(f32) * scale
        sc[:, :, :, 0] = torch.where(tril, sc[:, :, :, 0], -1e30)
        m_prev = m[:, :, :, j:]
        m_cur = torch.maximum(m_prev, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_cur)
        alpha = torch.exp(m_prev - m_cur)
        l[:, :, :, j:] = l[:, :, :, j:] * alpha + p.sum(dim=-1, keepdim=True)
        acc[:, :, :, j:] = acc[:, :, :, j:] * alpha + torch.matmul(
            p.to(v.dtype).to(f32), vj.to(f32))
        m[:, :, :, j:] = m_cur
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out.reshape(b, hq, s, d)


def beyond_one_ulp(got, want):
    """Rows (sequence positions) of the elements past one bf16 ulp."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean().sqrt()
    tol = torch.maximum(C.bf16_ulp(want), C.bf16_ulp(rms))
    bad = ((got - want).abs() > tol).nonzero()
    return bad.shape[0], sorted({int(r) for r in bad[:, 2]})


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    seen = {"kernel": Counter(), "plain, q.k in f64": Counter()}
    for seed in range(seeds):
        q, k, v = C.flash_inputs(C.SMOLLM_ATTN, torch.bfloat16, 100 + seed,
                                 dev)
        want = ref.flash_attention(q, k, v)
        for name, got in (("kernel", ops.flash_attention(q, k, v)),
                          ("plain, q.k in f64", plain_f64_scores(q, k, v))):
            n, rows = beyond_one_ulp(got, want)
            if n:
                seen[name]["seeds"] += 1
            seen[name]["elements"] += n
            print(f"seed {100 + seed} {name}: {n} elements beyond one ulp, "
                  f"rows {rows}")
        del q, k, v, want
    print(f"{C.SMOLLM_ATTN} bf16, {seeds} seeds: " + "; ".join(
        f"{name}: {c['elements']} elements beyond one ulp in {c['seeds']} "
        f"seeds" for name, c in seen.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
