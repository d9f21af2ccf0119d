"""Pluggable memory-request schedulers for the controller layer.

The controller (``controller.py``) holds one live head request per core and,
every scan step, asks the scheduler which head to serve next. A scheduler is a
*static* enum plus a pure key function: the controller computes an int32 key
per core and serves ``argmin(key)``, so every variant stays JIT/vmap-compatible
(the enum is a static argument, never traced).

Key construction is tiered: the scheduler places each head request into a
priority tier (row hit / open subarray / miss), and within a tier the oldest
visible request wins (its visibility cycle is the low-order part of the key).
Ties break toward the lowest core index, matching ``jnp.argmin``.

  FCFS          first-come first-served: oldest visible head, period.
  FRFCFS        FR-FCFS (Rixner et al.): row hits first, then oldest.
  FRFCFS_SALP   FR-FCFS with a middle tier for requests to already-activated
                subarrays — under MASA such a request skips the ACT (row hit)
                or can proceed without closing another subarray's row, so
                preferring it preserves subarray-level parallelism (the
                paper's scheduler-awareness discussion, Sec. 5.3).
  TCM           FR-FCFS composed with application-aware thread ranking
                (TCM-style, Kim et al. MICRO'10): the latency-sensitive
                (low-MPKI) half of the cores is strictly prioritized.
  PALP_RP       PALP-style read-priority scheduling for PCM (arXiv
                1908.07966, Sec. 5): FR-FCFS with one extra tier between
                row hits and misses that lifts pending READS whose target
                *partition* (subarray) is not serving a write's slow
                programming pulse. A PCM write keeps its partition busy for
                ~tWR after the data burst; a read scheduled into it stalls
                on the pulse, while a read into a write-free partition
                issues immediately — so the rung keeps the channel issuing
                reads into write-ready partitions and lets busy partitions
                drain their pulses in the shadow. Reads are what the core
                is stalled on (PALP's premise); writes keep only their
                FR-FCFS tiers. Meaningful on any technology, designed for
                memtech "pcm_palp" (docs/memtech.md).

Port note: the ``Scheduler`` enum, ``ALL_SCHEDULERS`` and the key
constants are copied from ``repro.core.dram.schedulers``; ``request_key``
is the reference's with the mix dimension written out (``[M, C]`` heads).
With one core every discipline degenerates to program order.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

from repro_torch.core.dram import state_layout as L


#: Tier spacing. Must exceed any realistic visibility cycle so tiers are
#: strict; small enough that key arithmetic stays within int32 (the TCM
#: rank subtraction can reach -2 * _BIG, the SALP/PALP_RP miss tiers
#: +2 * _BIG, and the DARP urgency boost composes another -4 * _BIG on
#: top — every combination stays well inside +/- 2**31 and below _DEAD).
_BIG = np.int32(1 << 28)

#: Key assigned to cores whose stream is exhausted — larger than any live key.
_DEAD = np.int32(2_000_000_000)

#: Refresh-urgency boost (DARP): subtracted from the key of pending requests
#: to a bank whose postponed-refresh debt is one step from forcing a blocking
#: burst, so the bank's queue drains before the forced refresh would stall
#: it. Strictly outranks every tier including TCM's ranking boost; the worst
#: composed key (TCM latency-sensitive + urgent) stays within int32.
_REF_URGENT = np.int32(4) * _BIG


class Scheduler(enum.IntEnum):
    FCFS = 0          # program/arrival order across cores
    FRFCFS = 1        # row hits first, then oldest
    FRFCFS_SALP = 2   # + prefer already-activated subarrays (MASA-aware)
    TCM = 3           # FR-FCFS + latency-sensitive thread ranking
    PALP_RP = 4       # PALP read-priority (PCM write-asymmetry aware)

    @property
    def pretty(self) -> str:
        return {0: "FCFS", 1: "FR-FCFS", 2: "FR-FCFS+SALP", 3: "TCM",
                4: "PALP-RP"}[int(self)]


#: The DRAM scheduling disciplines sched_bench sweeps (the historical axis).
#: PALP_RP is deliberately NOT here: it targets the PCM write asymmetry and
#: is swept by the memtech suite (benchmarks/memtech_bench.py) instead.
ALL_SCHEDULERS = (Scheduler.FCFS, Scheduler.FRFCFS, Scheduler.FRFCFS_SALP,
                  Scheduler.TCM)


def _tier(cond, then: int, other) -> torch.Tensor:
    """``where(cond, then, other)`` as int32 (a Python-int pair would give
    int64 and stop the key arithmetic from wrapping like the reference's)."""
    return torch.where(cond, then, other).to(torch.int32)


def request_key(scheduler: int, bank_state: dict, hb, hs, hw, vis, rank,
                n_cores: int, live, ref_debt=None, ref_urgent: int = 0,
                hwr=None) -> torch.Tensor:
    """int32 selection key per core of every mix; the controller serves the
    ``argmin`` over cores.

    The reference's key function over ``[M, C]`` heads: ``hb/hs/hw`` are the
    heads' bank / subarray / row, ``vis`` their visibility cycles, ``rank``
    the TCM ranks (0 = most latency-sensitive), ``live`` marks cores whose
    stream is not exhausted, ``hwr`` the heads' is-write bits and
    ``ref_debt`` (DARP only) the heads' banks' postponed-refresh counters.
    ``bank_state`` is the PRE-step packed state (``sa`` ``[M, nb, ns + 1,
    SA_F]``, ``scalars`` ``[M, SC_F]``): the open row and the partition's
    write recovery are read at each head's ``(bank, subarray)``, and a head
    is *pending* when it is visible by the time the shared data bus frees.
    See the reference for the tiers' rationale.
    """
    scheduler = Scheduler(scheduler)
    if scheduler == Scheduler.PALP_RP and hwr is None:
        raise ValueError("Scheduler.PALP_RP needs the heads' is-write bits "
                         "(hwr); the controller passes reqs[:, RQ_WR]")
    sa = bank_state["sa"]
    mix = torch.arange(sa.shape[0], dtype=torch.long, device=sa.device)[:, None]
    head = sa[mix, hb.long(), hs.long()]                  # [M, C, SA_F]
    orow = head[..., L.SA_OPEN_ROW]
    hit = orow == hw
    sa_open = orow != int(L.NEG)
    bus_free = bank_state["scalars"][:, L.SC_DATA_BUS_FREE][:, None]
    pending = vis <= bus_free
    big = int(_BIG)
    if scheduler == Scheduler.FCFS:
        key = vis
    elif scheduler == Scheduler.FRFCFS:
        key = vis + _tier(pending & hit, 0, big)
    elif scheduler == Scheduler.FRFCFS_SALP:
        key = vis + _tier(pending & hit, 0,
                          _tier(pending & sa_open, big, 2 * big))
    elif scheduler == Scheduler.TCM:
        key = vis + _tier(pending & hit, 0, big)
        latency_sensitive = pending & (rank < (n_cores // 2))
        key = key - _tier(latency_sensitive, 2 * big, 0)
    elif scheduler == Scheduler.PALP_RP:
        # partition write-ready: the head's subarray has drained its write
        # recovery by the time the shared bus frees
        wr_ready = head[..., L.SA_WRR_DONE] <= bus_free
        key = vis + _tier(pending & hit, 0,
                          _tier(pending & ~hwr & wr_ready, big, 2 * big))
    else:  # pragma: no cover - enum is exhaustive
        raise ValueError(f"unknown scheduler {scheduler!r}")
    if ref_debt is not None:
        urgent = pending & (ref_debt >= ref_urgent)
        key = key - _tier(urgent, int(_REF_URGENT), 0)
    return torch.where(live, key, int(_DEAD))
