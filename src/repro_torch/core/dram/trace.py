"""Workload -> memory-request trace generation + external-trace ingestion.

Traces are generated on the host with numpy (deterministic per seed) and fed to
the simulator as arrays. A workload is a small Markov process over a set of
concurrently-live access streams, parameterized to match the *published
characteristics* of the paper's 32-application suite (SPEC CPU2006 + STREAM +
GUPS + TPC classes): misses-per-kilo-instruction (MPKI), write fraction
(=> WMPKI), row-buffer run length, number of concurrent streams (=> bank
conflict pressure), pointer-chasing dependence fraction, and streaming-ness.
See docs/workloads.md for the knob-by-knob reference and the calibration
provenance of the suite table.

The *baseline* is calibrated against these published characteristics; the
mechanisms' gains are then emergent from the timing model — they are never fit.

Address mapping (docs/address-mapping.md): the generator emits a *physical
address* stream in the canonical layout of
:mod:`repro_torch.core.dram.address_map`; an :class:`AddressMapping` then decodes it
into the ``(bank, subarray, row)`` arrays the simulator consumes. The pinned
default (``"golden"``) reproduces the historical hard-coded golden-ratio
row->subarray hash bit-for-bit; any other mapping replays the *same* physical
stream under a different layout. :meth:`Trace.from_file` ingests
ramulator/DRAMSim-style ``cycle addr R|W`` text traces through the same
decode path, and :meth:`Trace.dump` writes one back (the round trip is exact
for dependence-free traces; the text format has no dependence column).

This is the *request*-side text format (``# repro-trace v1``). The
*command*-side twin — the DRAM command stream a simulation actually issued
(ACT/PRE/RD/WR/REF with issue cycles) — is
:meth:`repro_torch.core.dram.commands.CommandTrace.dump` (``# repro-cmds v1``),
re-checkable against the JEDEC rule table from the file alone
(docs/commands.md).

Port note: a framework-free copy of ``repro.core.dram.trace``, with
import paths rewritten to ``repro_torch`` (the port never imports
the JAX package); tests/test_torch_frontend.py holds it equal to
the reference.
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from typing import IO, Sequence

import numpy as np

from repro_torch.core.dram import registry
from repro_torch.core.dram.address_map import (AddressMapping, DEFAULT_MAPPING,
                                         mapping_for)
from repro_torch.core.dram.timing import CoreModel, DEFAULT_CORE


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Knobs describing one application's memory behaviour."""
    name: str
    mpki: float            # last-level-cache misses per kilo-instruction
    wr_frac: float         # fraction of requests that are writes (WMPKI = mpki * wr_frac)
    row_run: float         # mean consecutive same-row accesses within a stream
    n_streams: int         # concurrently-live access streams (bank-conflict pressure)
    rows_per_stream: int   # hot-row working set per stream (row reuse => MASA hits)
    dep_frac: float        # fraction of loads dependent on the previous load
    seq_frac: float        # P(row switch is sequential next-row) vs jump-to-hot-row
    cold_frac: float = 0.02  # P(completely random cold access)
    align: float = 0.0     # fraction of hot rows sharing a common bank phase
                           # (lockstep multi-array stride patterns => persistent
                           # same-bank, cross-subarray conflicts)

    @property
    def wmpki(self) -> float:
        return self.mpki * self.wr_frac


#: The 32-workload suite. MPKI ordering mirrors the paper's Figure 4 x-axis
#: (sorted by memory intensity); the three most write-intensive entries
#: (lbm / stream_copy / gups: WMPKI > 15, MPKI > 25) are the paper's SALP-2
#: standouts; mcf/omnetpp/gups are the dependence-heavy pointer chasers.
PAPER_WORKLOADS: tuple[WorkloadProfile, ...] = (
    WorkloadProfile("gamess",       0.4, 0.20,  8.0, 2,  4, 0.10, 0.50),
    WorkloadProfile("povray",       0.5, 0.20,  8.0, 2,  4, 0.15, 0.30),
    WorkloadProfile("namd",         0.7, 0.25,  6.0, 2,  6, 0.10, 0.40),
    WorkloadProfile("calculix",     0.8, 0.30,  8.0, 2,  4, 0.10, 0.50),
    WorkloadProfile("perlbench",    1.0, 0.25,  6.0, 3,  6, 0.20, 0.30),
    WorkloadProfile("h264ref",      1.2, 0.30, 10.0, 2,  4, 0.10, 0.60),
    WorkloadProfile("gobmk",        1.4, 0.25,  5.0, 3,  8, 0.25, 0.20),
    WorkloadProfile("sjeng",        1.5, 0.20,  4.0, 3,  8, 0.30, 0.20),
    WorkloadProfile("tonto",        1.6, 0.30,  6.0, 2,  6, 0.10, 0.40),
    WorkloadProfile("gromacs",      2.0, 0.30,  8.0, 2,  4, 0.10, 0.50),
    WorkloadProfile("gcc",          2.5, 0.30,  5.0, 3,  8, 0.20, 0.30),
    WorkloadProfile("astar",        3.5, 0.25,  4.0, 2,  8, 0.45, 0.10),
    WorkloadProfile("hmmer",        4.0, 0.35, 12.0, 2,  3, 0.05, 0.70, align=0.3),
    WorkloadProfile("bzip2",        4.5, 0.30,  8.0, 3,  6, 0.15, 0.40),
    WorkloadProfile("dealII",       5.0, 0.30,  6.0, 3,  6, 0.15, 0.40),
    WorkloadProfile("cactusADM",    6.0, 0.35, 10.0, 3,  4, 0.10, 0.60, align=0.3),
    WorkloadProfile("xalancbmk",    7.5, 0.25,  4.0, 4,  8, 0.30, 0.15),
    WorkloadProfile("zeusmp",       9.0, 0.35,  8.0, 4,  4, 0.10, 0.50, align=0.3),
    WorkloadProfile("wrf",         10.0, 0.35, 10.0, 3,  4, 0.08, 0.60, align=0.3),
    WorkloadProfile("sphinx3",     12.0, 0.15,  6.0, 4,  6, 0.15, 0.40),
    WorkloadProfile("bwaves",      15.0, 0.30, 12.0, 4,  3, 0.05, 0.80, align=0.35),
    WorkloadProfile("leslie3d",    16.0, 0.35, 10.0, 4,  4, 0.05, 0.70, align=0.45),
    WorkloadProfile("omnetpp",     17.0, 0.20,  3.0, 4, 10, 0.40, 0.10),
    WorkloadProfile("soplex",      20.0, 0.25,  6.0, 4,  6, 0.15, 0.40),
    WorkloadProfile("GemsFDTD",    22.0, 0.40, 10.0, 4,  4, 0.05, 0.70, align=0.5),
    WorkloadProfile("libquantum",  25.0, 0.25, 16.0, 2,  2, 0.05, 0.90, align=0.5),
    WorkloadProfile("milc",        26.0, 0.45,  6.0, 4,  6, 0.10, 0.40, align=0.6),
    WorkloadProfile("lbm",         30.0, 0.55,  8.0, 4,  4, 0.05, 0.60, align=0.7),
    WorkloadProfile("mcf",         33.0, 0.20,  3.0, 5, 12, 0.50, 0.05),
    WorkloadProfile("stream_copy", 38.0, 0.50, 16.0, 3,  2, 0.02, 0.95, align=0.65),
    WorkloadProfile("stream_triad",40.0, 0.35, 16.0, 4,  2, 0.02, 0.95, align=0.55),
    WorkloadProfile("gups",        45.0, 0.50,  1.0, 6, 64, 0.60, 0.00),
)

#: Name -> profile for the suite (benchmarks/tests address workloads by name).
WORKLOADS_BY_NAME: dict[str, WorkloadProfile] = {p.name: p for p in PAPER_WORKLOADS}

#: Row-address stride between the cores of a multi-core mix (passed as
#: ``generate_trace(..., row_space_offset=ROW_SPACE_STRIDE * core_index)``):
#: each core gets its own hot rows while sharing banks. One constant so
#: hand-built mixes and ``run_mix_sweep`` cells generate identical traces.
ROW_SPACE_STRIDE = 4096


registry.register("workload", tuple(sorted(WORKLOADS_BY_NAME)))


def workload(name: str) -> WorkloadProfile:
    """Suite profile by name; raises with the valid names (and the nearest
    match) on a typo.

    Thin alias over :func:`repro_torch.core.dram.registry.resolve`, so a typo'd
    workload raises the same near-miss ``ValueError`` as every other spec
    axis. (Historically this raised ``KeyError``; the registry
    consolidation unified the exception type across axes.)
    """
    return registry.resolve("workload", name, mapping=WORKLOADS_BY_NAME)


#: ``Trace.dump`` / ``Trace.from_file`` header (carries what the text columns
#: cannot: the format version and the core's ROB-limited MLP window).
_TRACE_HEADER = "# repro-trace v1"

_WRITE_TOKENS = {"W", "WR", "WRITE", "P_MEM_WR"}
_READ_TOKENS = {"R", "RD", "READ", "P_MEM_RD"}


@dataclasses.dataclass
class Trace:
    """Arrays of length ``n`` describing one request stream (trace order)."""
    bank: np.ndarray       # int32 [n]
    subarray: np.ndarray   # int32 [n]
    row: np.ndarray        # int32 [n]  (row id within the subarray's address space)
    is_write: np.ndarray   # bool  [n]
    gap: np.ndarray        # int32 [n]  compute cycles before this request (DRAM cycles)
    dep: np.ndarray        # bool  [n]  depends on previous request's completion
    mlp_window: int        # ROB-limited outstanding misses for this workload
    profile: WorkloadProfile | None = None
    addr: np.ndarray | None = None   # uint64 [n] physical addresses (canonical
                                     # layout; None for hand-built traces)
    mapping: str = DEFAULT_MAPPING   # spec the (bank, subarray, row) arrays
                                     # were decoded under

    def __len__(self) -> int:
        return int(self.bank.shape[0])

    @classmethod
    def from_file(cls, path: str | os.PathLike | IO[str],
                  n_banks: int = 8, n_subarrays: int = 8,
                  rows_per_bank: int = 32768,
                  mapping: str | AddressMapping = DEFAULT_MAPPING,
                  mlp_window: int | None = None) -> "Trace":
        """Ingest a ramulator/DRAMSim-style text trace.

        Each non-comment line is ``cycle addr R|W`` (or ``addr R|W`` — the
        cycle column is optional and gaps default to 0): ``cycle`` is the DRAM
        cycle the core exposes the request (monotone non-decreasing), ``addr``
        a decimal or ``0x``-hex physical byte address, and the type token one
        of R/RD/READ/P_MEM_RD or W/WR/WRITE/P_MEM_WR (case-insensitive).
        Addresses are decoded into ``(bank, subarray, row)`` by ``mapping``,
        so one file replays under any layout. ``# repro-trace v1`` headers
        written by :meth:`dump` restore ``mlp_window`` (an explicit argument
        wins; the fallback is the default core's MSHR count). The text format
        has no dependence column: ``dep`` is all-False.

        A malformed line raises ``ValueError`` naming the source file, the
        line number, and the offending text — a 2M-line ramulator dump with
        one bad row must point at that row, not at a numpy shape error three
        layers later.
        """
        if hasattr(path, "read"):
            src = getattr(path, "name", None) or "<stream>"
            lines = list(path)
        else:
            src = os.fspath(path)
            with open(path) as f:
                lines = list(f)

        def bad(lineno: int, raw: str, msg: str) -> ValueError:
            return ValueError(
                f"{src}: line {lineno}: {msg}: offending text {raw.strip()!r}")

        header_mlp = None
        cycles, addrs, writes = [], [], []
        for lineno, raw in enumerate(lines, 1):
            line = raw.strip()
            if line.startswith(_TRACE_HEADER):
                for tok in line.split():
                    if tok.startswith("mlp_window="):
                        header_mlp = int(tok.split("=", 1)[1])
                continue
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            if len(toks) == 2:
                cyc, a, rw = None, toks[0], toks[1]
            elif len(toks) == 3:
                try:
                    cyc = int(toks[0])
                except ValueError:
                    raise bad(lineno, raw,
                              f"bad cycle token {toks[0]!r}") from None
                a, rw = toks[1], toks[2]
            else:
                raise bad(lineno, raw,
                          "expected 'cycle addr R|W' or 'addr R|W'")
            rw = rw.upper()
            if rw in _WRITE_TOKENS:
                writes.append(True)
            elif rw in _READ_TOKENS:
                writes.append(False)
            else:
                raise bad(lineno, raw,
                          f"unknown request type {rw!r} (expected one of "
                          f"{sorted(_READ_TOKENS | _WRITE_TOKENS)})")
            cycles.append(cyc)
            try:
                # base 0 for 0x-hex; plain base 10 rescues zero-padded
                # decimals ("00421") that base 0 rejects as bad octal
                addrs.append(int(a, 0) if not a.lstrip("+-").startswith("0")
                             or a.lower().startswith(("0x", "0b", "0o"))
                             else int(a, 10))
            except ValueError:
                raise bad(lineno, raw, f"bad address token {a!r} "
                          f"(expected decimal or 0x-hex)") from None
        if not addrs:
            raise ValueError(f"trace file {src} contains no requests")

        addr = np.asarray(addrs, np.uint64)
        if all(c is None for c in cycles):
            gap = np.zeros(len(addr), np.int64)
        elif any(c is None for c in cycles):
            # a mixed file means a malformed line, not an addr-only trace;
            # silently zeroing every gap would change simulated timing
            i = cycles.index(None) + 1
            raise ValueError(f"{src}: trace mixes 'cycle addr R|W' and "
                             f"'addr R|W' lines (first cycle-less request "
                             f"is #{i}); use one form throughout")
        else:
            cyc_arr = np.asarray(cycles, np.int64)
            gap = np.maximum(np.diff(cyc_arr, prepend=cyc_arr[:1]), 0)
            if gap.max() >= 2 ** 31:
                i = int(gap.argmax())
                raise ValueError(
                    f"{src}: cycle gap of {int(gap[i])} before request "
                    f"#{i + 1} overflows the simulator's int32 gap field")

        m = mapping_for(mapping, n_banks, n_subarrays, rows_per_bank)
        bank, subarray, row = m.decode(addr)
        if mlp_window is None:
            mlp_window = header_mlp if header_mlp is not None else DEFAULT_CORE.mshr
        return cls(bank=bank.astype(np.int32),
                   subarray=subarray.astype(np.int32),
                   row=row.astype(np.int32),
                   is_write=np.asarray(writes, bool),
                   gap=gap.astype(np.int32),
                   dep=np.zeros(len(addr), bool),
                   mlp_window=int(mlp_window), addr=addr, mapping=m.spec)

    def dump(self, path: str | os.PathLike | IO[str]) -> None:
        """Write the trace as ``cycle addr R|W`` text (see :meth:`from_file`).

        Requires physical addresses (``self.addr``); the cycle column is the
        cumulative sum of ``gap``. Dependence flags are NOT representable in
        the text format — dump refuses a trace with live ``dep`` bits rather
        than silently changing its simulated timing.
        """
        if self.addr is None:
            raise ValueError("trace has no physical addresses to dump; "
                             "generate with generate_trace() or ingest via "
                             "Trace.from_file()")
        if self.dep.any():
            raise ValueError(
                "the text trace format has no dependence column; clear dep "
                "first (dataclasses.replace(trace, dep=np.zeros_like(trace.dep)))")
        cycles = np.cumsum(self.gap.astype(np.int64))
        out = path if hasattr(path, "write") else open(path, "w")
        try:
            out.write(f"{_TRACE_HEADER} mlp_window={int(self.mlp_window)}\n")
            for c, a, w in zip(cycles, self.addr, self.is_write):
                out.write(f"{int(c)} 0x{int(a):x} {'W' if w else 'R'}\n")
        finally:
            if out is not path:
                out.close()


def generate_trace(
    profile: WorkloadProfile,
    n_requests: int,
    n_banks: int = 8,
    n_subarrays: int = 8,
    rows_per_bank: int = 32768,
    core: CoreModel = DEFAULT_CORE,
    seed: int = 0,
    row_space_offset: int = 0,
    mapping: str | AddressMapping = DEFAULT_MAPPING,
    footprint_rows: int | None = None,
) -> Trace:
    """Generate one workload trace.

    ``row_space_offset`` shifts the hot-row address space (used to give each
    core of a multi-core mix its own rows while sharing banks).

    ``mapping`` / ``footprint_rows`` are the physical-address mode
    (docs/address-mapping.md): the Markov machinery below always runs
    identically (same RNG stream), producing a canonical physical-address
    stream; ``mapping`` then decodes it into ``(bank, subarray, row)``. The
    default ``"golden"`` mapping is bit-identical to the historical
    hard-coded frontend. ``footprint_rows`` confines the workload's resident
    set to a contiguous physical region of that many rows (dense OS page
    allocation) — the regime where subarray-oblivious mappings collapse
    SALP/MASA gains because the whole footprint fits in one contiguous
    subarray slab.
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(profile.name.encode())]))
    k = profile.n_streams

    # Hot working set: per stream, a set of (bank, row) pairs. Streams landing
    # in the same bank create the cross-subarray conflicts SALP targets.
    # Lockstep multi-array iteration (lbm/STREAM/milc...): arrays share page
    # alignment, so corresponding elements of different arrays land in the SAME
    # bank but different rows => persistent same-bank cross-subarray conflicts.
    # ``align`` controls what fraction of the hot set collides this way.
    hot_bank = rng.integers(0, n_banks, size=(k, profile.rows_per_stream))
    if profile.align > 0:
        shared_bank = rng.integers(0, n_banks, size=profile.rows_per_stream)
        collide = rng.random((k, profile.rows_per_stream)) < profile.align
        hot_bank = np.where(collide, shared_bank[None, :], hot_bank)
    hot_row = (rng.integers(0, rows_per_bank, size=(k, profile.rows_per_stream))
               + row_space_offset) % rows_per_bank

    # Current position per stream (index into its hot set) + sequential cursor.
    cur = rng.integers(0, profile.rows_per_stream, size=k)
    seq_row = rng.integers(0, rows_per_bank, size=k)
    seq_bank = rng.integers(0, n_banks, size=k)
    in_seq = np.zeros(k, dtype=bool)

    stream_pick = rng.integers(0, k, size=n_requests)
    switch_draw = rng.random(n_requests)
    seq_draw = rng.random(n_requests)
    cold_draw = rng.random(n_requests)
    hot_jump = rng.integers(0, profile.rows_per_stream, size=n_requests)
    cold_bank = rng.integers(0, n_banks, size=n_requests)
    cold_row = rng.integers(0, rows_per_bank, size=n_requests)

    p_switch = 1.0 / max(profile.row_run, 1.0)

    bank = np.zeros(n_requests, dtype=np.int64)
    row = np.zeros(n_requests, dtype=np.int64)

    for i in range(n_requests):
        s = stream_pick[i]
        if cold_draw[i] < profile.cold_frac:
            # Cold random access (TLB-miss-like noise).
            bank[i] = cold_bank[i]
            row[i] = (cold_row[i] + row_space_offset) % rows_per_bank
            continue
        if switch_draw[i] < p_switch:
            if seq_draw[i] < profile.seq_frac:
                # Sequential advance: next row, rotating through banks the way a
                # row-interleaved mapping spreads a linear stream.
                if not in_seq[s]:
                    in_seq[s] = True
                    seq_row[s] = hot_row[s, cur[s]]
                    seq_bank[s] = hot_bank[s, cur[s]]
                seq_row[s] = (seq_row[s] + 1) % rows_per_bank
                if seq_draw[i] > profile.align * profile.seq_frac:
                    # row-interleaved mapping: a linear stream rotates banks;
                    # aligned strided arrays stay in-bank (conflict persists)
                    seq_bank[s] = (seq_bank[s] + 1) % n_banks
            else:
                in_seq[s] = False
                cur[s] = hot_jump[i]
        if in_seq[s]:
            bank[i] = seq_bank[s]
            row[i] = seq_row[s]
        else:
            bank[i] = hot_bank[s, cur[s]]
            row[i] = hot_row[s, cur[s]]

    if footprint_rows is not None:
        if not 0 < footprint_rows <= rows_per_bank:
            raise ValueError(f"footprint_rows must be in (0, {rows_per_bank}];"
                             f" got {footprint_rows}")
        # Dense resident set: fold the abstract row ids into a contiguous
        # physical region (per-core regions stay disjoint via the offset).
        row = (row % footprint_rows + row_space_offset) % rows_per_bank

    # Physical-address mode: encode the canonical stream, decode under the
    # requested mapping. The golden default round-trips (bank, row) exactly
    # and applies the historical hash — bit-identical to the old frontend.
    m = mapping_for(mapping, n_banks, n_subarrays, rows_per_bank)
    addr = m.encode(bank, row)
    bank, subarray, row = m.decode(addr)

    is_write = rng.random(n_requests) < profile.wr_frac
    dep = (rng.random(n_requests) < profile.dep_frac) & ~is_write
    dep[0] = False

    # Compute gap between misses: (1000/MPKI) instructions at peak retire rate.
    mean_gap = (1000.0 / profile.mpki) / core.instr_per_dram_cycle
    gap = rng.exponential(mean_gap, size=n_requests)
    gap = np.maximum(0, np.round(gap)).astype(np.int64)
    gap[0] = 0

    return Trace(
        bank=bank.astype(np.int32),
        subarray=subarray.astype(np.int32),
        row=row.astype(np.int32),
        is_write=is_write,
        gap=gap.astype(np.int32),
        dep=dep,
        mlp_window=core.mlp_window(profile.mpki),
        profile=profile,
        addr=addr,
        mapping=m.spec,
    )


def to_ideal(trace: Trace, n_banks: int, n_subarrays: int) -> Trace:
    """Rewrite a trace so every subarray becomes its own real bank ("Ideal").

    The rewritten (bank, subarray) arrays no longer correspond to any decode
    of the original physical addresses, so ``addr`` is dropped — ``dump`` on
    an ideal trace refuses instead of silently writing addresses that would
    replay as the non-ideal trace.
    """
    return dataclasses.replace(
        trace,
        bank=(trace.bank * n_subarrays + trace.subarray).astype(np.int32),
        subarray=np.zeros_like(trace.subarray),
        addr=None,
    )


def stack_traces(traces: Sequence[Trace]) -> dict[str, np.ndarray]:
    """Stack equal-length traces into [W, N] arrays for vmapped simulation.

    Stacking requests that were decoded under *different* address mappings is
    almost always a sweep-construction bug (cells of one vmapped bucket must
    share a config, and the mapping is a config axis), so it is rejected.
    """
    n = len(traces[0])
    assert all(len(t) == n for t in traces), "traces must be equal length to stack"
    mappings = {t.mapping for t in traces}
    if len(mappings) > 1:
        raise ValueError(f"cannot stack traces decoded under different "
                         f"address mappings: {sorted(mappings)}")
    stacked = {
        "bank": np.stack([t.bank for t in traces]),
        "subarray": np.stack([t.subarray for t in traces]),
        "row": np.stack([t.row for t in traces]),
        "is_write": np.stack([t.is_write for t in traces]),
        "gap": np.stack([t.gap for t in traces]),
        "dep": np.stack([t.dep for t in traces]),
        "mlp_window": np.array([t.mlp_window for t in traces], dtype=np.int32),
    }
    if all(t.addr is not None for t in traces):
        stacked["addr"] = np.stack([t.addr for t in traces])
    return stacked
