"""The comparison that decides ``correct``.

Every answer of every job completed in the window (each cell's counters,
a mix's per-core and run-alone cycles, each IPC gain and weighted speedup)
is held to the frozen reference's answer for the same job. The simulator
is exact integer arithmetic and its derived results are float64 formulas
over those integers, so the comparison is exact: each number compared has
the limit 0.
"""
from __future__ import annotations

#: number compared -> its limit
LIMITS = {"answers_wrong": 0, "answers_missing": 0}


def compare(expected: dict, got: dict) -> tuple[int, int, set]:
    """``(wrong, missing, failed cells)``: numbers that differ, answers
    absent, and the (item, policy, point) cells either touches. An answer
    the reference does not know counts as wrong."""
    wrong = missing = 0
    failed = set()
    for key, want in expected.items():
        have = got.get(key)
        if have is None:
            missing += len(want) if isinstance(want, tuple) else 1
            failed.add(key[1:])
            continue
        if isinstance(want, tuple):
            bad = sum(a != b for a, b in zip(want, have))
            bad += abs(len(want) - len(have))
        else:
            bad = int(have != want)
        if bad:
            wrong += bad
            failed.add(key[1:])
    for key in got.keys() - expected.keys():
        wrong += 1
        failed.add(key[1:])
    return wrong, missing, failed


def lines(values: dict) -> list[str]:
    return [f"check {k} {values[k]} limit {LIMITS[k]}" for k in LIMITS]
