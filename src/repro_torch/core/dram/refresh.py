"""The refresh-policy ladder (paper Sec. 6.1; Chang et al. HPCA'14).

The simulator models refresh as a *controller* concern: per-bank deadlines
every ``tREFI``, a burst that occupies the bank (or one subarray) for the
policy's burst length, and visibility stalls for the requests the burst
blocks. This module names the mechanism ladder the HPCA'14 refresh papers
define (arXiv 1712.07754 / 1601.06352) as one ``SimConfig`` axis:

================ ============================================================
``"none"``       Refresh off (the historical ``refresh=False``).
``"all_bank"``   Blocking all-bank refresh (REFab): every ``tREFI`` the due
                 bank runs a full ``tRFC`` burst; every request to the bank
                 waits. Bit-identical to the historical ``refresh=True``.
``"per_bank"``   Per-bank refresh (REFpb): same staggered deadlines, but the
                 burst is the shorter per-bank ``tRFCpb`` — one bank's rows,
                 not the whole rank's. Other banks were already free in this
                 model; the win is the ~2.5x shorter blocking burst.
``"darp"``       Dynamic Access-Refresh Parallelization on top of REFpb:
                 refreshes are *scheduled*, not fired on the deadline —
                 pulled into idle bank time, postponed under read pressure
                 (up to the spec's 8-deep window), and parallelized with
                 writes (a refresh rides the shadow of a write burst, whose
                 completion the core is not stalled on). Only when the debt
                 hits the window does a refresh force its way in front of a
                 demand request.
``"sarp"``       Subarray Access-Refresh Parallelization: the REFpb burst
                 occupies ONE subarray (round-robin) and — because refresh
                 never drives the global bitlines — requests to the bank's
                 *other* subarrays proceed even WITHOUT MASA. Blocks only
                 same-subarray requests.
``"dsarp"``      The historical DSARP mode (bit-identical to the old
                 ``refresh=True, dsarp=True`` pair): subarray-granular
                 refresh with the full ``tRFC`` burst that only MASA can
                 serve around (under non-MASA policies it degenerates to
                 blocking refresh).
================ ============================================================

The enum *value* is the engine/controller's static ``refresh_mode`` (modes
1 and 2 keep their historical numbers so the pinned regression fixtures
stay valid; see docs/refresh.md for the full semantics and provenance).

Port note: a framework-free copy of ``repro.core.dram.refresh``, with
import paths rewritten to ``repro_torch`` (the port never imports
the JAX package); tests/test_torch_frontend.py holds it equal to
the reference.
"""
from __future__ import annotations

import enum

from repro_torch.core.dram import registry


class RefreshPolicy(enum.IntEnum):
    """One rung of the refresh ladder; the value is the static refresh mode."""
    NONE = 0
    ALL_BANK = 1
    DSARP = 2
    PER_BANK = 3
    DARP = 4
    SARP = 5

    @property
    def spec(self) -> str:
        """The ``SimConfig.refresh_policy`` spelling of this rung."""
        return self.name.lower()

    @property
    def pretty(self) -> str:
        return {0: "off", 1: "REFab", 2: "DSARP", 3: "REFpb", 4: "DARP",
                5: "SARP"}[int(self)]

    @property
    def subarray_granular(self) -> bool:
        """Does the burst occupy one subarray instead of the whole bank?"""
        return self in (RefreshPolicy.DSARP, RefreshPolicy.SARP)

    @property
    def per_bank_burst(self) -> bool:
        """Does the burst last ``tRFCpb`` instead of the all-bank ``tRFC``?"""
        return self in (RefreshPolicy.PER_BANK, RefreshPolicy.DARP,
                        RefreshPolicy.SARP)

    @classmethod
    def from_spec(cls, spec: "str | RefreshPolicy") -> "RefreshPolicy":
        """Resolve a spec string; raises with the nearest match on a typo.

        Thin alias over the shared spec registry
        (:func:`repro_torch.core.dram.registry.resolve`), so the near-miss
        ``ValueError`` is format-identical across every spec axis.
        """
        if isinstance(spec, cls):
            return spec
        return registry.resolve("refresh policy", spec,
                                mapping={p.spec: p for p in cls},
                                normalize=str.lower)


registry.register("refresh policy", tuple(p.spec for p in RefreshPolicy))

#: Every rung that actually refreshes (the sweepable ladder).
REFRESH_LADDER = (RefreshPolicy.ALL_BANK, RefreshPolicy.PER_BANK,
                  RefreshPolicy.DARP, RefreshPolicy.SARP, RefreshPolicy.DSARP)
