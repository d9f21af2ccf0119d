"""Published peaks of the cards a cell may run on, by the name that
``torch.cuda.get_device_name()`` gives (NVIDIA's data sheet, SXM part,
at its 700 W limit)."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(device_kind: str | None) -> float | None:
    return PEAKS.get(device_kind or "", {}).get("hbm_bytes_per_s")
