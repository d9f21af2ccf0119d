"""What the per-layer readers in ``chipbench/metrics/`` share.

A reader takes the run's context (:func:`chipbench.harness.main.context`)
and returns a number, or None where it finds nothing to read. A kernel's
time is its device time in the traced window; its steps and bytes are the
work the completed jobs' shapes ask of it (``generator.launches``), counted
only where the program's own launch counter agrees with those shapes.
"""
from __future__ import annotations


def _kernel(ctx: dict, kernel: str):
    work = ctx["work"].get(kernel)
    seconds = sum(s for name, s in ctx["device_s"].items()
                  if name.startswith(kernel))
    if not work or not seconds or ctx["launches"].get(kernel) != work[
            "launches"]:
        return None, None
    return seconds, work


def us_per_step(ctx: dict, kernel: str) -> float | None:
    """Device time of ``kernel`` over the serial steps its launches run."""
    seconds, work = _kernel(ctx, kernel)
    if seconds is None:
        return None
    return seconds / work["steps"] * 1e6


def roofline_pct(ctx: dict, kernel: str) -> float | None:
    """The least time the card's HBM could move ``kernel``'s bytes in, as a
    share of the kernel's device time."""
    seconds, work = _kernel(ctx, kernel)
    if seconds is None or not ctx["hbm_bytes_per_s"]:
        return None
    return work["bytes"] / ctx["hbm_bytes_per_s"] / seconds * 100.0
