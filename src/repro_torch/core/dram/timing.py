"""DRAM timing / energy / core-model constants.

Units: DRAM command-clock cycles (DDR3-1066 => 533 MHz command clock,
1 cycle = 1.876 ns, burst of 8 transfers occupies tBL = 4 command cycles).

The values mirror a DDR3-1066 7-7-7 part, the device class used in the SALP
paper's evaluation. ``t_rrd_sa`` is the paper's new constraint: minimum spacing
between ACTIVATEs to *different subarrays of the same bank* (Section 5.1 of the
ISCA'12 paper introduces a constraint of this kind to bound peak current);
``t_sa`` is the SA_SEL command latency MASA adds before a column command when
the designated subarray changes.

Every constant below is *enforced* by the engine/controller timing math and
*independently validated* at command granularity: the checker's declarative
rule table (``repro_torch.core.dram.checker.rules_for``) re-derives each JEDEC
constraint — tRCD/tRP/tRAS/tWR/tRTP/tCCD/tWTR/tRTW/tRRD/tRRD_sa/tFAW plus
the refresh cadences — from these fields and verifies exported command
streams against them (docs/commands.md carries the per-rule provenance
table). A timing constant that drifted out of sync with the engine's
behaviour fails the command-level CI checks, not just our own fixtures.

Port note: a framework-free copy of ``repro.core.dram.timing``, with
import paths rewritten to ``repro_torch`` (the port never imports
the JAX package); tests/test_torch_frontend.py holds it equal to
the reference.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.dram import registry


@dataclasses.dataclass(frozen=True)
class DramTiming:
    t_cl: int = 7      # column (CAS) latency, read
    t_cwl: int = 6     # column write latency
    t_rcd: int = 7     # ACT -> column command
    t_rp: int = 7      # PRE -> ACT (same subarray / same bank for baseline)
    t_ras: int = 20    # ACT -> PRE (minimum row-open time)
    t_wr: int = 8      # write recovery: last write data -> PRE
    t_rtp: int = 4     # read -> PRE
    t_bl: int = 4      # burst length on the data bus (8 beats, DDR)
    t_ccd: int = 4     # column -> column
    t_wtr: int = 4     # write data end -> read command (bus turnaround)
    t_rtw: int = 6     # read command -> write command (bus turnaround)
    t_rrd: int = 4     # ACT -> ACT, different banks
    t_rrd_sa: int = 4  # ACT -> ACT, different subarrays of the same bank (SALP)
    t_faw: int = 20    # four-activate window
    t_sa: int = 1      # SA_SEL latency (MASA designation before a column command)
    t_refi: int = 4160  # refresh interval (7.8 us @ 533 MHz)
    t_rfc: int = 160    # all-bank refresh cycle time (~300 ns, 8 Gb-class density)
    # Per-bank refresh burst (REFpb, LPDDR / DDR4 per-bank refresh; the
    # REFpb / DARP / SARP ladder of Chang et al. HPCA'14): refreshing one
    # bank's rows takes ~2.5x less than the all-bank burst at equal density
    # (tRFCpb ~= 0.4 * tRFCab in the LPDDR3 datasheets HPCA'14 Table 2 cites).
    t_rfc_pb: int = 64
    # DDR4/LPDDR spec: up to 8 refresh commands may be postponed as long as
    # the running debt never exceeds the window — the room DARP's
    # out-of-order refresh scheduling plays in (debt overflowing the window
    # forces blocking bursts; the spec's symmetric pull-in-ahead credit is
    # not modeled — see docs/refresh.md).
    ref_postpone_max: int = 8

    @property
    def t_rc(self) -> int:
        return self.t_ras + self.t_rp

    @classmethod
    def preset(cls, memtech: str = "ddr3", *, density_gb: int | None = None,
               t_refi: int | None = None) -> "DramTiming":
        """Canonical per-technology timing pack (the ``memtech`` axis).

        ``memtech`` names the pack (``"ddr3"`` / ``"lpddr4"`` /
        ``"pcm_palp"``; typos raise the shared registry near-miss error).
        ``density_gb`` scales the refresh-burst pair (tRFC/tRFCpb) with
        device density for the refreshing technologies — 8/16/32 Gb, the
        sweep axis of docs/refresh.md — and is rejected for PCM, which has
        no refresh at all. ``t_refi`` overrides the refresh interval (the
        hot-temperature 2x-rate point refresh_bench sweeps).

        ``preset("ddr3")`` with no overrides is *bit-identical* to the
        pinned :data:`DDR3_1066` baseline (asserted by tests), so the
        default path of every existing fixture is untouched.
        """
        name = memtech_spec(memtech)
        base = MEMTECHS[name]
        if density_gb is not None:
            table = _DENSITY_RFC.get(name)
            if table is None:
                raise ValueError(
                    f"memtech {name!r} has no refresh, so density_gb only "
                    f"scales nothing — drop it (PCM cells need no refresh)")
            try:
                rfc, rfc_pb = table[int(density_gb)]
            except KeyError:
                raise ValueError(
                    f"no {name} refresh-burst table for density_gb="
                    f"{density_gb!r}; expected one of "
                    f"{sorted(table)}") from None
            base = dataclasses.replace(base, t_rfc=rfc, t_rfc_pb=rfc_pb)
        if t_refi is not None:
            if base.t_refi == 0:
                raise ValueError(
                    f"memtech {name!r} has no refresh; a t_refi override is "
                    f"meaningless")
            base = dataclasses.replace(base, t_refi=int(t_refi))
        return base


#: DDR3-1066 7-7-7, the paper's device class.
DDR3_1066 = DramTiming()

#: LPDDR4-3200-class pack, expressed in its OWN command clock (1600 MHz,
#: 0.625 ns/cycle — cycle counts are therefore larger than DDR3-1066's even
#: where the nanosecond latency is similar). Values follow a JESD209-4
#: LPDDR4-3200 speed bin: RL=28 / WL=14, tRCD/tRPpb/tWR ~18 ns, tRAS 42 ns,
#: BL16 (8 command cycles on the bus), tFAW 40 ns. The pack is
#: per-bank-refresh-centric — LPDDR4 is the technology the REFpb/DARP/SARP
#: ladder (Chang et al. HPCA'14) targets: tRFCab 280 ns vs tRFCpb 140 ns at
#: 8 Gb, and the spec's 8-deep postpone window.
LPDDR4_3200 = DramTiming(
    t_cl=28, t_cwl=14, t_rcd=29, t_rp=29, t_ras=68, t_wr=29, t_rtp=12,
    t_bl=8, t_ccd=8, t_wtr=16, t_rtw=12, t_rrd=16, t_rrd_sa=16, t_faw=64,
    t_sa=1, t_refi=6240, t_rfc=448, t_rfc_pb=224, ref_postpone_max=8)

#: PCM pack after PALP (arXiv 1908.07966; device latencies from Lee et al.
#: ISCA'09), on a DDR3-1066-style interface clock (1.876 ns/cycle) so the
#: bus-side constants stay comparable to the baseline. The two PCM-defining
#: asymmetries:
#:   * slow array reads — activation senses the PCM array into the row
#:     buffer (~60 ns => tRCD=32), but reads are NON-destructive, so there
#:     is no restore: tRP is a mere buffer-reset (4 cycles) and tRAS only
#:     covers the sensing window;
#:   * much slower writes — a SET/RESET programming pulse (~150 ns =>
#:     tWR=80) keeps the *partition* (the PCM analogue of a subarray)
#:     write-busy long after the bus transfer ends. That write occupancy is
#:     exactly the problem PALP's read-priority scheduling
#:     (:data:`repro_torch.core.dram.schedulers.Scheduler.PALP_RP`) works around.
#: PCM cells need NO refresh: the refresh fields are zeroed and
#: ``SimConfig`` rejects any ``refresh_policy`` but ``"none"`` for
#: ``memtech="pcm_palp"``.
PCM_PALP = DramTiming(
    t_cl=7, t_cwl=6, t_rcd=32, t_rp=4, t_ras=36, t_wr=80, t_rtp=4,
    t_bl=4, t_ccd=4, t_wtr=4, t_rtw=6, t_rrd=4, t_rrd_sa=4, t_faw=20,
    t_sa=1, t_refi=0, t_rfc=0, t_rfc_pb=0, ref_postpone_max=0)

#: memtech spec -> timing pack (the ``SimConfig.memtech`` axis).
MEMTECHS: dict[str, DramTiming] = {
    "ddr3": DDR3_1066,
    "lpddr4": LPDDR4_3200,
    "pcm_palp": PCM_PALP,
}

registry.register("memtech", tuple(MEMTECHS))

#: Per-technology density scaling for the refresh-burst pair, in the pack's
#: own command cycles. DDR3 rows are the values refresh_bench has always
#: swept (8 Gb = the DDR3_1066 defaults; 16/32 Gb from the HPCA'14 scaling
#: the refresh docs cite); LPDDR4 rows scale the JESD209-4 tRFCab/tRFCpb
#: pair the same way. PCM has no refresh, hence no row.
_DENSITY_RFC: dict[str, dict[int, tuple[int, int]]] = {
    "ddr3": {8: (160, 64), 16: (280, 112), 32: (475, 190)},
    "lpddr4": {8: (448, 224), 16: (608, 304), 32: (896, 448)},
}


def resolve_memtech(spec: "str | DramTiming") -> DramTiming:
    """Memtech spec -> timing pack; registry near-miss ValueError on typos.

    Accepts a :class:`DramTiming` instance (returned as-is) so call sites
    can take "a pack or its name" uniformly.
    """
    if isinstance(spec, DramTiming):
        return spec
    return registry.resolve("memtech", spec, mapping=MEMTECHS,
                            normalize=str.lower)


def memtech_spec(spec: str) -> str:
    """Canonical memtech spelling (validates via the shared registry)."""
    resolve_memtech(spec)
    return str(spec).lower()


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Per-command dynamic energy (nJ) + static terms.

    Magnitudes follow the Micron DDR3 power-calculator methodology the paper
    uses: an ACT/PRE pair costs a couple of nJ and a column burst about one nJ.
    ``p_sa_static_mw`` is the paper's measured 0.56 mW per *additional*
    concurrently-activated subarray (MASA); ``p_background_mw`` is active-standby
    background power per device, charged over the whole simulated interval so
    that static energy is policy-comparable.
    """
    e_act: float = 1.60    # nJ per ACTIVATE
    e_pre: float = 0.80    # nJ per PRECHARGE
    e_rd: float = 1.10     # nJ per read burst (incl. IO)
    e_wr: float = 1.25     # nJ per write burst (incl. IO + ODT)
    e_sasel: float = 0.05  # nJ per SA_SEL (single-bit latch toggle + cmd decode)
    p_sa_static_mw: float = 0.56   # per extra activated subarray (paper, Sec. 2.3)
    p_background_mw: float = 95.0  # active standby background
    cycle_ns: float = 1.876        # DDR3-1066 command-clock period

    def static_nj(self, cycles: float, extra_sa_cycles: float) -> float:
        # Unit derivation: power is stored in mW, time in DRAM cycles.
        #   mW * ns = (1e-3 J/s) * (1e-9 s) = 1e-12 J = 1 pJ,
        # so (power-in-mW) * (cycles * cycle_ns) is directly picojoules and a
        # single 1e-3 factor converts pJ -> nJ. (An earlier version also
        # scaled the power by 1e-3 — mW -> W — which double-converted and
        # underreported static energy 1000x.)
        bg_pj = self.p_background_mw * cycles * self.cycle_ns
        sa_pj = self.p_sa_static_mw * extra_sa_cycles * self.cycle_ns
        return (bg_pj + sa_pj) * 1e-3


DEFAULT_ENERGY = EnergyModel()


@dataclasses.dataclass(frozen=True)
class CoreModel:
    """Analytic out-of-order core used to pace the request stream.

    The paper evaluates with a 3-wide out-of-order core, 128-entry ROB, CPU
    clock ~6x the DRAM command clock. Requests are issued in program order
    (single stream) with:
      * a compute gap between consecutive misses drawn from the workload MPKI,
      * dependent loads serializing on the previous load's completion,
      * a ROB-occupancy constraint: request ``i`` cannot issue before request
        ``i - mlp_window`` has completed (bounded memory-level parallelism).
    """
    ipc_peak: float = 3.0          # retire width
    rob: int = 128                 # ROB entries
    cpu_per_dram: float = 6.0      # CPU cycles per DRAM command cycle
    mshr: int = 32                 # max outstanding misses

    @property
    def instr_per_dram_cycle(self) -> float:
        return self.ipc_peak * self.cpu_per_dram

    def mlp_window(self, mpki: float) -> int:
        """Outstanding misses allowed by a full ROB at this miss density."""
        w = int(round(self.rob * mpki / 1000.0))
        return max(1, min(self.mshr, w))


DEFAULT_CORE = CoreModel()
