"""Scheduling policies for the subarray simulator (the paper's mechanisms).

Port note: a framework-free copy of ``repro.core.dram.policies``, with
import paths rewritten to ``repro_torch`` (the port never imports
the JAX package); tests/test_torch_frontend.py holds it equal to
the reference.
"""
from __future__ import annotations

import enum


class Policy(enum.IntEnum):
    BASELINE = 0   # subarray-oblivious: one open row per bank, full serialization
    SALP1 = 1      # overlap PRE(A) with ACT(B), A != B (reinterpret tRP)
    SALP2 = 2      # issue ACT(B) before PRE(A): overlap write recovery too
    MASA = 3       # multitude of activated subarrays + SA_SEL designation
    IDEAL = 4      # baseline with n_subarrays x banks (upper bound)

    @property
    def pretty(self) -> str:
        return {0: "Baseline", 1: "SALP-1", 2: "SALP-2", 3: "MASA", 4: '"Ideal"'}[int(self)]


ALL_POLICIES = (Policy.BASELINE, Policy.SALP1, Policy.SALP2, Policy.MASA, Policy.IDEAL)
MECHANISMS = (Policy.SALP1, Policy.SALP2, Policy.MASA)
