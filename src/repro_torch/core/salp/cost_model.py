"""Analytic SALP cost model.

Distills the DRAM engine's timing math into per-access-pair costs so schedulers
(e.g. the serving engine's continuous-batching scheduler) can score an access
*order* in O(n) without running the full simulator. The classes mirror the
paper's taxonomy:

  HIT            — row already open (designated or not)
  MISS           — subarray closed: ACT + column
  CONFLICT_SAME  — same subarray, different row: PRE + tRP + ACT + column
  CONFLICT_OTHER — different subarray of the same bank holds the open row:
                   the policy determines how much of the PRE/ACT overlaps

Costs are DRAM cycles added to the bank's critical path by serving the access
after the previous one. Under MASA a CONFLICT_OTHER against a *still-open* row
degenerates to a (cross-subarray) HIT + SA_SEL — the paper's key locality win.

Port note: a framework-free copy of ``repro.core.salp.cost_model``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_serve.py holds it equal to the reference.
"""
from __future__ import annotations

import dataclasses
import enum

from repro_torch.core.dram.policies import Policy
from repro_torch.core.dram.timing import DramTiming, DDR3_1066


class AccessClass(enum.IntEnum):
    HIT = 0
    MISS = 1
    CONFLICT_SAME = 2
    CONFLICT_OTHER = 3


@dataclasses.dataclass(frozen=True)
class SalpCostModel:
    timing: DramTiming = DDR3_1066
    policy: Policy = Policy.MASA

    def column_cost(self, is_write: bool) -> int:
        t = self.timing
        return max(t.t_ccd, t.t_bl)

    def cost(self, access: AccessClass, after_write: bool = False,
             switches_subarray: bool = False) -> int:
        """Critical-path cycles this access adds beyond pure column streaming."""
        t = self.timing
        col = self.column_cost(False)
        wrec = (t.t_cwl + t.t_bl + t.t_wr) if after_write else 0

        if access == AccessClass.HIT:
            sasel = t.t_sa if (self.policy == Policy.MASA and switches_subarray) else 0
            return col + sasel

        if access == AccessClass.MISS:
            return col + t.t_rcd

        if access == AccessClass.CONFLICT_SAME:
            # identical under every policy: PRE -> tRP -> ACT -> tRCD
            return col + wrec + t.t_rp + t.t_rcd

        # CONFLICT_OTHER: the policy ladder
        if self.policy == Policy.BASELINE:
            return col + wrec + t.t_rp + t.t_rcd
        if self.policy == Policy.SALP1:
            return col + wrec + 1 + t.t_rcd           # tRP overlapped with ACT
        if self.policy == Policy.SALP2:
            return col + max(wrec, t.t_rcd) + 1       # write recovery overlapped too
        # MASA: the other subarray stays open; if the target row is still open
        # there, the caller should have classified this as HIT. A genuine
        # CONFLICT_OTHER (row not resident) costs an overlapped ACT.
        return col + max(1, t.t_rcd - col) + t.t_sa

    def order_cost(self, classes: list[AccessClass],
                   after_write: list[bool] | None = None,
                   switches: list[bool] | None = None) -> int:
        """Total critical-path cost of serving accesses in the given order."""
        n = len(classes)
        after_write = after_write or [False] * n
        switches = switches or [False] * n
        return sum(self.cost(c, aw, sw)
                   for c, aw, sw in zip(classes, after_write, switches))
