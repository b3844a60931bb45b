"""How far the tensor cores' q . k errs, a k16 step: the error model the
bf16 flash kernel's one-ulp contract rests on.

    python3 tools/wgmma_error_probe.py [--cases N] [--seed S]

``csrc/flash_attention.cu`` sums q . k as a chain of
``wgmma.m64n128k16.f32.bf16.bf16`` steps over the head dimension and
takes each step (16 exact products added to the accumulator) to err by
less than 10.5 u of the terms it adds (u = 2^-24): the tensor cores
align the products and the accumulator to the largest of them, cut each
at 2^-25 of it and truncate the sum to f32, so 17 cut terms lose less
than 8.5 u and the truncation less than 2 u. Since the accumulator
holds every earlier term, a score then lies within ``u sum_d 11 (D/16 -
floor(d/16)) |q_d k_d|`` of the exact dot product (the tensor cores'
part of ``err_weight`` in the kernel). This probe runs the kernel's own instruction,
operand layout and chain (``csrc/wgmma_probe.cu``) for chains of 1 ..
D/16 steps and holds every step against f64 sums (exact to 2^-46 of the
terms' magnitudes, far below what is measured) on inputs built to be
adversarial:

- ``normal``: N(0, 1) values;
- ``cancel``: each k16 step's products cancel in pairs but for a
  relative 2^-7 (q_{d+8} = q_d, k_{d+8} = -k_d (1 + r 2^-7)), so every
  step's sum is small against its terms;
- ``mixed``: values scaled by 2^e, e uniform in [-12, 12], so each step
  adds terms whose exponents lie 48 apart (alignment and truncation
  inside the tensor core lose the small ones);
- ``mixed_cancel``: a large pair that cancels exactly in each step and
  small terms, so the exact sum is the small terms alone;
- ``grow``: the first step large, later steps small, so the accumulator
  dwarfs what a step adds;
- ``trunc`` and ``trunc_neg``: in each step one product of 1 and fifteen
  of one sign between 2^-28 and 2^-19, so whatever alignment drops from
  the small terms adds up instead of cancelling;
- ``edge``, ``edge_neg`` and ``edge_acc``: in each step one product of
  1 (for ``edge_acc`` the 1 sits in the accumulator and the later steps
  add sixteen small terms) and fifteen terms of one sign just below a
  power of two, ``2^-j (1 - 2^-8)`` with j = 21 .. 28 by case: if the
  tensor cores align every term to the largest and truncate it to a
  grid of ``2^-j``, each loses almost a whole grid step, the worst case
  of that model (printed by j);
- ``ties``: sums that land on a rounding midpoint of f32 (1 + 2^-24 and
  its neighbours), where round-to-nearest-even, truncation and rounding
  away differ.

For each D in 32, 64, 128 it prints the largest step error in units of
``u (|c| + sum |p|)`` (c the accumulator before the step, p the step's
products; the kernel assumes less than 10.5), the largest chain error in
units of ``u sum_d |q_d k_d|`` and as a share of that bound, the share
of accumulators bitwise those of the alignment model (``model``), the
input kind that shows each, the card's name and power limit, and one
JSON line, with where the largest step error lies (case, step, q and k
row, the accumulator before the step, the step's exact sum and sum of
|p|, the result). ``--seed`` picks the inputs. It exits 1 if a step
errs by 10.5 u or more, or a chain reaches its bound.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

U = 2.0 ** -24
ASSUMED = 10.5         # the kernel's error a k16 step, in u of its terms
TC_STEP = 11.0         # its weight a step, from a term's own to the last
CASES = 24             # cases (64 x 128 scores each) per kind and D
KINDS = ("normal", "cancel", "mixed", "mixed_cancel", "grow", "ties",
         "trunc", "trunc_neg", "edge", "edge_neg", "edge_acc")


def bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16 (nearest, ties to even), as f32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def inputs(kind: str, d: int, rng, cases: int = CASES
           ) -> tuple[np.ndarray, np.ndarray]:
    """q ``[cases, 64, d]`` and k ``[cases, 128, d]``, bf16 values as
    f32."""
    q = rng.standard_normal((cases, 64, d)).astype(np.float32)
    k = rng.standard_normal((cases, 128, d)).astype(np.float32)
    if kind == "cancel":
        for s in range(0, d, 16):
            q[..., s + 8:s + 16] = q[..., s:s + 8]
            r = rng.uniform(-1, 1, k[..., s:s + 8].shape) * 2.0 ** -7
            k[..., s + 8:s + 16] = -bf16(k[..., s:s + 8] * (1 + r))
    elif kind in ("mixed", "mixed_cancel"):
        q *= np.exp2(rng.integers(-12, 13, q.shape)).astype(np.float32)
        k *= np.exp2(rng.integers(-12, 13, k.shape)).astype(np.float32)
        if kind == "mixed_cancel":
            for s in range(0, d, 16):
                big = np.float32(2.0 ** 12)
                q[..., s] = q[..., s + 1] = big
                k[..., s] = bf16(rng.standard_normal(k[..., s].shape)
                                 .astype(np.float32) * big)
                k[..., s + 1] = -k[..., s]
    elif kind == "grow":
        q[..., :16] *= np.float32(2.0 ** 10)
        k[..., :16] *= np.float32(2.0 ** 10)
        q[..., 16:] *= np.float32(2.0 ** -6)
    elif kind in ("trunc", "trunc_neg"):
        sign = 1.0 if kind == "trunc" else -1.0
        q[:] = 1.0
        k = (rng.uniform(1.0, 2.0, k.shape) * np.exp2(
            -rng.integers(20, 29, k.shape)) * sign).astype(np.float32)
        k[..., ::16] = 1.0
    elif kind in ("edge", "edge_neg", "edge_acc"):
        # terms just below a power of two, 2^-j (1 - 2^-8) with j = 21 ..
        # 28 by case, beside a product of 1 in the step (or, for
        # edge_acc, in the accumulator): each loses almost a whole grid
        # step if the tensor cores truncate every aligned term at 2^-j
        sign = -1.0 if kind == "edge_neg" else 1.0
        j = 21 + np.arange(cases) % 8
        small = (sign * (1.0 - 2.0 ** -8) * np.exp2(-j.astype(np.float64))
                 ).astype(np.float32)[:, None, None]
        q[:] = 1.0
        k = np.broadcast_to(small, k.shape).copy()
        if kind == "edge_acc":
            k[..., :16] = 0.0
            k[..., 0] = 1.0
        else:
            k[..., ::16] = 1.0
    elif kind == "ties":
        # per step: 1 + 2^-24 (x, y) and small terms a few ulps of 1 apart
        q[:] = 0.0
        k[:] = 0.0
        for s in range(0, d, 16):
            q[..., s] = 1.0
            k[..., s] = 1.0
            q[..., s + 1] = 2.0 ** -12
            k[..., s + 1] = np.where(rng.random(k[..., s + 1].shape) < 0.5,
                                     2.0 ** -12, -(2.0 ** -12))
            q[..., s + 2] = 2.0 ** -12
            k[..., s + 2] = 2.0 ** -12 * rng.integers(
                -3, 4, k[..., s + 2].shape)
    return bf16(q), bf16(k)


def build():
    _build.build_all(("wgmma_probe",))
    lib = _build.load("wgmma_probe")
    fn = lib.wgmma_probe_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, I, I, P]
    fn.restype = I
    return lib


def run(lib, q: np.ndarray, k: np.ndarray, dev) -> np.ndarray:
    """The probe's accumulators ``[cases, D/16, 64, 128]`` (f32)."""
    import torch

    cases, _, d = q.shape
    tq = torch.from_numpy(q).to(torch.bfloat16).to(dev)
    tk = torch.from_numpy(k).to(torch.bfloat16).to(dev)
    out = torch.empty((cases, d // 16, 64, 128), device=dev)
    rc = lib.wgmma_probe_launch(_build.ptr(tq), _build.ptr(tk),
                                _build.ptr(out), cases, d,
                                _build.stream_of(tq))
    _build.check(lib, rc, "wgmma_probe")
    torch.cuda.synchronize(dev)
    return out.cpu().numpy()


def model(q: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The chain as the alignment model computes it, ``[cases, D/16, 64,
    128]``: a step's 16 exact products and the accumulator, each cut
    toward zero at 2^-25 of the largest one's power of two, summed
    exactly, the sum truncated to f32."""
    cases, _, d = q.shape
    out = np.empty((cases, d // 16, 64, 128), np.float32)
    for c0 in range(0, cases, 8):
        qc = q[c0:c0 + 8].astype(np.float64)
        kc = k[c0:c0 + 8].astype(np.float64)
        acc = np.zeros(qc.shape[:2] + (kc.shape[1],))
        for n in range(d // 16):
            sl = slice(16 * n, 16 * n + 16)
            terms = np.concatenate(
                [qc[:, :, None, sl] * kc[:, None, :, sl], acc[..., None]],
                axis=-1)
            top = np.abs(terms).max(axis=-1, keepdims=True)
            grid = np.exp2(np.floor(np.log2(np.where(top > 0, top, 1.0)))
                           - 25)
            exact = (np.trunc(terms / grid) * grid).sum(axis=-1)
            f = exact.astype(np.float32)
            f = np.where(np.abs(f.astype(np.float64)) > np.abs(exact),
                         np.nextafter(f, np.float32(0)), f)
            acc = f.astype(np.float64)
            out[c0:c0 + 8, n] = f
    return out


def _ratio(err: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return np.where(scale > 0, err / np.where(scale > 0, scale, 1.0),
                    np.where(err > 0, np.inf, 0.0))


def errors(q: np.ndarray, k: np.ndarray, s: np.ndarray) -> tuple:
    """(largest step error in u of the step's terms, largest chain error
    in u of sum |q k| and as a share of its bound, where the largest step error lies: case, step,
    q row, k row, the accumulator before, the step's exact sum and sum
    of |p|, and the tensor cores' result) over every score."""
    d = q.shape[-1]
    q64, k64 = q.astype(np.float64), k.astype(np.float64)
    prev = np.zeros(s.shape[:1] + s.shape[2:])
    step_worst, where = 0.0, None
    for n in range(d // 16):
        sl = slice(16 * n, 16 * n + 16)
        p = np.einsum("crd,cjd->crj", q64[..., sl], k64[..., sl])
        a = np.einsum("crd,cjd->crj", np.abs(q64[..., sl]),
                      np.abs(k64[..., sl]))
        got = s[:, n].astype(np.float64)
        r = _ratio(np.abs(got - (prev + p)), U * (np.abs(prev) + a))
        i = np.unravel_index(int(np.argmax(r)), r.shape)
        if r[i] > step_worst:
            step_worst = float(r[i])
            where = {"case": int(i[0]), "step": n, "q_row": int(i[1]),
                     "k_row": int(i[2]), "acc": float(prev[i]),
                     "step_sum": float(p[i]), "step_abs": float(a[i]),
                     "got": float(got[i])}
        prev = got
    exact = np.einsum("crd,cjd->crj", q64, k64)
    tot = np.einsum("crd,cjd->crj", np.abs(q64), np.abs(k64))
    w = TC_STEP * (d // 16 - np.arange(d) // 16)
    bound = np.einsum("crd,cjd->crj", np.abs(q64) * w, np.abs(k64))
    chain = np.abs(prev - exact)
    return (step_worst, float(np.max(_ratio(chain, U * tot))),
            float(np.max(_ratio(chain, U * bound))), where)


def measure(dev, seed: int = 0, cases: int = CASES) -> dict:
    """Per D: the largest step and chain errors and the kinds that show
    them."""
    lib = build()
    rng = np.random.default_rng(seed)
    res = {}
    for d in (32, 64, 128):
        row = {"step": 0.0, "step_kind": None, "chain": 0.0,
               "chain_kind": None, "share": 0.0, "kinds": {}}
        for kind in KINDS:
            q, k = inputs(kind, d, rng, cases)
            got = run(lib, q, k, dev)
            st, ch, sh, where = errors(q, k, got)
            row["kinds"][kind] = {"step": st, "chain": ch, "share": sh}
            row["share"] = max(row["share"], sh)
            same = got == model(q, k)
            row["kinds"][kind]["model_bitwise"] = float(same.mean())
            if kind.startswith("edge"):
                # the largest step error by the small terms' 2^-j
                row["kinds"][kind]["step_by_j"] = {
                    int(21 + c): errors(q[c::8], k[c::8], got[c::8])[0]
                    for c in range(min(8, cases))}
            if st > row["step"]:
                row["step"], row["step_kind"] = st, kind
                row["step_at"] = where
            if ch > row["chain"]:
                row["chain"], row["chain_kind"] = ch, kind
        res[f"D{d}"] = row
    return res


def main() -> None:
    import argparse

    import torch

    if not torch.cuda.is_available():
        sys.exit("wgmma_error_probe: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=CASES)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    res = measure(torch.device("cuda", 0), args.seed, args.cases)
    print(card)
    for name, row in res.items():
        print(f"{name}: largest step error {row['step']:.4f} u of the "
              f"step's terms ({row['step_kind']}; assumed < {ASSUMED}), "
              f"largest chain error {row['chain']:.4f} u of sum |q k| "
              f"({row['chain_kind']}), at most {row['share']:.4f} of its "
              f"bound; by kind "
              + ", ".join(f"{k} {v['step']:.3f}/{v['chain']:.3f}"
                          for k, v in row["kinds"].items())
              + "; accumulators bitwise the alignment model's: "
              + ", ".join(f"{k} {v['model_bitwise']:.6f}"
                          for k, v in row["kinds"].items())
              + f"; the largest step at {row['step_at']}")
    print(json.dumps({"card": card, **res}))
    if any(row["step"] >= ASSUMED or row["share"] >= 1.0
           for row in res.values()):
        sys.exit("wgmma_error_probe: a k16 step errs by the assumed "
                 f"{ASSUMED} u of its terms or more, or a chain reaches "
                 "its bound")


if __name__ == "__main__":
    main()
