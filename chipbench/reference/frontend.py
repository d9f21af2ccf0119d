"""The frontend, frozen: workload profiles, the analytic core and the trace
generator with the golden-ratio address map.

A plain copy of the simulator's semantics, written for this benchmark and
independent of the code under test: the same profile, seed and geometry
give the same request stream. Only numpy's seeded generator is shared
(both sides draw from ``numpy.random.default_rng``).
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from pathlib import Path

import numpy as np

SUITE_DIR = Path(__file__).resolve().parents[1] / "data"

#: Golden-ratio multiplier of the row -> subarray hash (2^32 / phi).
GOLDEN_MULT = 2654435761
#: Canonical layout: 64 B lines, 128 lines a row.
LINE_BITS, COL_BITS = 6, 7
#: Row stride between the cores of a multi-core mix.
ROW_SPACE_STRIDE = 4096


@dataclasses.dataclass(frozen=True)
class Profile:
    name: str
    mpki: float
    wr_frac: float
    row_run: float
    n_streams: int
    rows_per_stream: int
    dep_frac: float
    seq_frac: float
    cold_frac: float = 0.02
    align: float = 0.0


@dataclasses.dataclass(frozen=True)
class Core:
    """The analytic out-of-order core that paces a request stream."""
    ipc_peak: float = 3.0
    rob: int = 128
    cpu_per_dram: float = 6.0
    mshr: int = 32

    def mlp_window(self, mpki: float) -> int:
        return max(1, min(self.mshr, int(round(self.rob * mpki / 1000.0))))


def load_suite(name: str) -> dict[str, Profile]:
    """Name -> profile of the suite in ``data/<name>.json``."""
    doc = json.loads((SUITE_DIR / f"{name}.json").read_text())
    return {row[0]: Profile(**dict(zip(doc["fields"], row)))
            for row in doc["workloads"]}


@dataclasses.dataclass
class Trace:
    """One request stream as plain lists."""
    bank: list
    subarray: list
    row: list
    is_write: list
    gap: list
    dep: list
    mlp_window: int


def golden_decode(bank, row, n_banks: int, n_subarrays: int,
                  rows_per_bank: int):
    """Encode (bank, row) canonically and decode under the golden map."""
    line = row.astype(np.uint64) * np.uint64(n_banks) + bank.astype(np.uint64)
    addr = (line * np.uint64(1 << COL_BITS)) << np.uint64(LINE_BITS)
    line = addr >> np.uint64(LINE_BITS + COL_BITS)
    bank = (line % np.uint64(n_banks)).astype(np.int64)
    row = ((line // np.uint64(n_banks))
           % np.uint64(rows_per_bank)).astype(np.int64)
    sa = ((row.astype(np.uint64) * np.uint64(GOLDEN_MULT))
          >> np.uint64(11)).astype(np.int64) % n_subarrays
    return bank, sa, row


def generate(p: Profile, n: int, n_banks: int, n_subarrays: int,
             rows_per_bank: int, core: Core, seed: int,
             row_space_offset: int = 0) -> Trace:
    """One workload's trace: the profile's Markov process over its streams,
    decoded under the golden map, with its writes, dependences and gaps."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(p.name.encode())]))
    k, rps = p.n_streams, p.rows_per_stream
    hot_bank = rng.integers(0, n_banks, size=(k, rps))
    if p.align > 0:
        shared = rng.integers(0, n_banks, size=rps)
        collide = rng.random((k, rps)) < p.align
        hot_bank = np.where(collide, shared[None, :], hot_bank)
    hot_row = (rng.integers(0, rows_per_bank, size=(k, rps))
               + row_space_offset) % rows_per_bank
    cur = rng.integers(0, rps, size=k).tolist()
    seq_row = rng.integers(0, rows_per_bank, size=k).tolist()
    seq_bank = rng.integers(0, n_banks, size=k).tolist()
    in_seq = [False] * k
    pick = rng.integers(0, k, size=n).tolist()
    switch = rng.random(n).tolist()
    seqd = rng.random(n).tolist()
    cold = rng.random(n).tolist()
    jump = rng.integers(0, rps, size=n).tolist()
    cold_bank = rng.integers(0, n_banks, size=n).tolist()
    cold_row = rng.integers(0, rows_per_bank, size=n).tolist()
    hb, hr = hot_bank.tolist(), hot_row.tolist()
    p_switch = 1.0 / max(p.row_run, 1.0)
    seq_cut = p.align * p.seq_frac

    bank, row = [0] * n, [0] * n
    for i in range(n):
        s = pick[i]
        if cold[i] < p.cold_frac:
            bank[i] = cold_bank[i]
            row[i] = (cold_row[i] + row_space_offset) % rows_per_bank
            continue
        if switch[i] < p_switch:
            if seqd[i] < p.seq_frac:
                if not in_seq[s]:
                    in_seq[s] = True
                    seq_row[s] = hr[s][cur[s]]
                    seq_bank[s] = hb[s][cur[s]]
                seq_row[s] = (seq_row[s] + 1) % rows_per_bank
                if seqd[i] > seq_cut:
                    seq_bank[s] = (seq_bank[s] + 1) % n_banks
            else:
                in_seq[s] = False
                cur[s] = jump[i]
        if in_seq[s]:
            bank[i], row[i] = seq_bank[s], seq_row[s]
        else:
            bank[i], row[i] = hb[s][cur[s]], hr[s][cur[s]]

    b, sa, r = golden_decode(np.asarray(bank, np.int64),
                             np.asarray(row, np.int64), n_banks, n_subarrays,
                             rows_per_bank)
    is_write = rng.random(n) < p.wr_frac
    dep = (rng.random(n) < p.dep_frac) & ~is_write
    dep[0] = False
    mean_gap = (1000.0 / p.mpki) / (core.ipc_peak * core.cpu_per_dram)
    gap = np.maximum(0, np.round(rng.exponential(mean_gap, size=n)))
    gap = gap.astype(np.int64)
    gap[0] = 0
    return Trace(b.tolist(), sa.tolist(), r.tolist(), is_write.tolist(),
                 gap.tolist(), dep.tolist(), core.mlp_window(p.mpki))
