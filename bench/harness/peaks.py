"""Published peaks by card, matched by a part of
``torch.cuda.get_device_name()`` (NVIDIA's H100 SXM data sheet; dense
rates at the full 700 W)."""
from __future__ import annotations

PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "bf16_flop_per_s": 989e12,
             "f32_flop_per_s": 67e12},
}


def for_device(kind: str) -> dict | None:
    for part, peaks in PEAKS.items():
        if part in kind:
            return peaks
    return None
