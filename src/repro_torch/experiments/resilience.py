"""Fault-isolated bucket execution for the sweep runner (the port of
``repro.experiments.resilience``).

The sweep runner turns a grid into shape buckets, each one batched simulator
call. Without isolation, one poisoned bucket — an allocator OOM, a refused
shape, a wedged host — aborts the whole grid and throws away every completed
cell.
This module is the reliability substrate between "list of buckets" and "call
the simulator":

* **Retry with bounded exponential backoff** — transient failures (allocator
  pressure, flaky device init) get ``max_retries`` extra attempts per
  (sub-)bucket before any cell is given up on.
* **Bisection** — a bucket that keeps failing is split in half and each half
  retried independently, recursively, until the truly-poisoned cells are
  stranded one by one. A 30-cell bucket with one bad cell loses one cell,
  not thirty.
* **Quarantine** — cells that still fail alone are recorded (error, attempts,
  originating bucket) in a structured ``quarantined`` list that the runner
  surfaces in the ``repro.sweep/v1`` artifact; the sweep completes.
* **Watchdog** — per-bucket wall time feeds a
  :class:`repro_torch.fault.StepWatchdog` EWMA; stragglers land in artifact
  stats.
* **Deterministic fault injection** — :class:`FaultPlan` raises / OOMs /
  delays / corrupts counters at named bucket or cell indices, so every path
  above is exercised by tests and CI instead of merely trusted
  (``benchmarks.run --inject-faults``).

``execute_buckets`` is shared by ``run_sweep`` and ``run_mix_sweep``; it only
sees lists of opaque cell indices plus two callbacks, so both sweep flavours
get identical semantics.

One difference from the reference: a CUDA error is not survivable. It
leaves the device's context unusable (every later launch fails too), so a
retry cannot help and quarantining would turn a kernel fault into a sweep
that looks complete. :func:`device_fault` recognises one, and
``execute_buckets`` lets it propagate at once, with every earlier bucket
committed. Nothing here re-runs a bucket on another device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Sequence

import torch

from repro_torch.fault.watchdog import StepWatchdog


class SimulatedOOM(MemoryError):
    """What a ``kind="oom"`` injected fault raises (stands in for the real
    backend's out-of-memory error, which is environment-specific)."""


class SweepKilled(BaseException):
    """Process-death simulation for crash-resume tests.

    Deliberately a ``BaseException``: the retry/bisect machinery catches
    ``Exception`` only, so a kill propagates out of the runner exactly like
    SIGKILL would — nothing downstream of the last committed bucket runs.
    """


_FAULT_KINDS = ("raise", "oom", "delay", "corrupt", "kill")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault, armed at a bucket and/or cell index.

    ``bucket`` matches the top-level bucket's submission index (sub-buckets
    produced by bisection inherit it — a persistent bucket fault therefore
    quarantines the whole bucket). ``cell`` matches whenever the executing
    (sub-)bucket *contains* that global cell index — under bisection the
    fault follows the poisoned cell down, so exactly that cell is stranded.
    ``times`` bounds how often the fault fires (``None`` = every time).
    """
    kind: str
    bucket: int | None = None
    cell: int | None = None
    times: int | None = 1
    delay_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in _FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_FAULT_KINDS}")
        if self.bucket is None and self.cell is None:
            raise ValueError("fault needs a bucket and/or cell target")

    def matches(self, bucket: int, cell_indices: Sequence[int]) -> bool:
        if self.bucket is not None and self.bucket != bucket:
            return False
        if self.cell is not None and self.cell not in cell_indices:
            return False
        return True


class FaultPlan:
    """Deterministic fault schedule, threaded through the runner as a
    test-only hook (``run_sweep(..., fault_plan=...)``).

    The compact spec grammar (``benchmarks.run --inject-faults``)::

        plan  := fault ("," fault)*
        fault := KIND "@" TARGET (":" OPT)*
        KIND  := raise | oom | delay | corrupt | kill
        TARGET:= "b" N   (bucket submission index)
               | "c" N   (global cell index, grid.expand() order)
        OPT   := "x" N   (fire N times; default 1)
               | "p"     (persistent: fire every time)
               | FLOAT   (delay seconds, "delay" kind only)

    ``"oom@b0:x2,raise@c4:p,delay@b1:0.05"`` — OOM the first bucket twice
    (retries recover), persistently poison cell 4 (bisection strands it),
    and slow bucket 1 by 50 ms (the watchdog sees a straggler).
    """

    def __init__(self, faults: Iterable[Fault]) -> None:
        self.faults = list(faults)
        self._fired: dict[int, int] = {i: 0 for i in range(len(self.faults))}
        self.log: list[dict[str, Any]] = []

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        faults = []
        for token in filter(None, (t.strip() for t in spec.split(","))):
            try:
                kind, rest = token.split("@", 1)
            except ValueError:
                raise ValueError(f"fault {token!r}: expected KIND@TARGET"
                                 f"[:OPT...]") from None
            parts = rest.split(":")
            target, opts = parts[0], parts[1:]
            kw: dict[str, Any] = {"kind": kind}
            if target[:1] == "b" and target[1:].isdigit():
                kw["bucket"] = int(target[1:])
            elif target[:1] == "c" and target[1:].isdigit():
                kw["cell"] = int(target[1:])
            else:
                raise ValueError(f"fault {token!r}: target must be bN "
                                 f"(bucket) or cN (cell), got {target!r}")
            for opt in opts:
                if opt == "p":
                    kw["times"] = None
                elif opt[:1] == "x" and opt[1:].isdigit():
                    kw["times"] = int(opt[1:])
                else:
                    try:
                        kw["delay_s"] = float(opt)
                    except ValueError:
                        raise ValueError(f"fault {token!r}: bad option "
                                         f"{opt!r}") from None
            faults.append(Fault(**kw))
        if not faults:
            raise ValueError(f"fault spec {spec!r} contains no faults")
        return cls(faults)

    def _armed(self, kinds: tuple[str, ...], bucket: int,
               cell_indices: Sequence[int]) -> tuple[int, Fault] | None:
        for i, f in enumerate(self.faults):
            if f.kind not in kinds:
                continue
            if f.times is not None and self._fired[i] >= f.times:
                continue
            if f.matches(bucket, cell_indices):
                return i, f
        return None

    def _fire(self, i: int, f: Fault, bucket: int,
              cell_indices: Sequence[int]) -> None:
        self._fired[i] += 1
        self.log.append({"kind": f.kind, "bucket": bucket,
                         "cells": list(cell_indices)})

    def before(self, bucket: int, cell_indices: Sequence[int]) -> None:
        """Called right before each (sub-)bucket simulates; may raise/sleep."""
        hit = self._armed(("delay",), bucket, cell_indices)
        if hit is not None:
            i, f = hit
            self._fire(i, f, bucket, cell_indices)
            time.sleep(f.delay_s)
        hit = self._armed(("raise", "oom", "kill"), bucket, cell_indices)
        if hit is not None:
            i, f = hit
            self._fire(i, f, bucket, cell_indices)
            where = f"bucket {bucket}, cells {list(cell_indices)}"
            if f.kind == "oom":
                raise SimulatedOOM(f"injected OOM at {where}")
            if f.kind == "kill":
                raise SweepKilled(f"injected kill at {where}")
            raise RuntimeError(f"injected fault at {where}")

    def after(self, bucket: int, cell_indices: Sequence[int],
              counters_by_index: dict[int, dict[str, int]]) -> dict[int, dict[str, int]]:
        """Called on each (sub-)bucket's results; may corrupt counters."""
        hit = self._armed(("corrupt",), bucket, cell_indices)
        if hit is None:
            return counters_by_index
        i, f = hit
        self._fire(i, f, bucket, cell_indices)
        out = dict(counters_by_index)
        targets = ([f.cell] if f.cell is not None and f.cell in out
                   else list(out))
        for idx in targets:
            v = out[idx]
            if isinstance(v, dict):        # single-core sweeps: counter dicts
                out[idx] = {k: -abs(c) - 1 for k, c in v.items()}
            else:                          # mix sweeps: results with .counters
                v.counters = {k: -abs(c) - 1 for k, c in v.counters.items()}
        return out

    def summary(self) -> dict[str, Any]:
        return {"n_faults": len(self.faults), "fired": len(self.log)}


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Knobs for retry / bisection / straggler detection.

    The defaults favour forward progress: two retries with short exponential
    backoff, then bisection down to single cells. ``bisect=False`` degrades
    to all-or-nothing per bucket (the pre-resilience behaviour, minus the
    abort). ``sleep`` is injectable so tests never actually wait.
    """
    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    bisect: bool = True
    straggler_threshold: float = 2.5
    sleep: Callable[[float], None] = time.sleep


@dataclasses.dataclass
class QuarantinedCell:
    """One cell stranded after retries + bisection exhausted."""
    index: int          # global cell index (grid.expand() order)
    bucket: int         # originating top-level bucket (submission order)
    error: str          # "ExcType: message" of the final failure
    attempts: int       # simulate attempts spent on the stranding sub-bucket


@dataclasses.dataclass
class ResilienceReport:
    """Execution accounting ``execute_buckets`` hands back to the runner."""
    n_batches: int = 0      # successful simulator calls (incl. sub-buckets)
    retries: int = 0        # failed attempts that were retried in place
    bisections: int = 0     # bucket splits performed
    quarantined: list[QuarantinedCell] = dataclasses.field(default_factory=list)
    stragglers: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    ewma_s: float | None = None

    def stats(self) -> dict[str, Any]:
        """The runner folds this into ``sweep.stats`` (artifact-visible)."""
        out: dict[str, Any] = {"retries": self.retries,
                               "bisections": self.bisections,
                               "quarantined": len(self.quarantined)}
        if self.stragglers or self.ewma_s is not None:
            out["watchdog"] = {
                "ewma_s": None if self.ewma_s is None else round(self.ewma_s, 6),
                "stragglers": self.stragglers,
            }
        return out


def device_fault(exc: BaseException) -> bool:
    """Whether ``exc`` is a CUDA error: torch's ``AcceleratorError``, or a
    message naming one (a kernel wrapper's failed launch, or torch's report
    of an earlier asynchronous fault). An allocator OOM is not one."""
    accel = getattr(torch, "AcceleratorError", None)
    return ((accel is not None and isinstance(exc, accel))
            or "CUDA error" in str(exc))


def execute_buckets(
    buckets: Iterable[Sequence[int]],
    simulate_fn: Callable[[list[int]], dict[int, Any]],
    commit_fn: Callable[[dict[int, Any]], None],
    *,
    policy: ResiliencePolicy | None = None,
    fault_plan: FaultPlan | None = None,
    watchdog: StepWatchdog | None = None,
    bucket_ids: Sequence[int] | None = None,
    on_quarantine: Callable[[QuarantinedCell], None] | None = None,
) -> ResilienceReport:
    """Run every bucket through retry → bisect → quarantine isolation.

    ``simulate_fn(indices)`` simulates one (sub-)bucket and returns
    ``{index: result}``; ``commit_fn(mapping)`` persists a successful
    (sub-)bucket's results *immediately* (crash consistency: a later
    failure can never lose earlier buckets). Results are opaque to this
    layer except for the ``corrupt`` fault, which assumes ``{str: int}``
    counter dicts.

    ``bucket_ids`` overrides the bucket index reported for each submission
    (default: enumeration order). The sharded scheduler
    (:mod:`repro_torch.experiments.sharding`) splits one logical bucket into
    several shard submissions; passing the logical bucket's index for every
    shard keeps ``FaultPlan`` ``bN`` targets and quarantine provenance
    identical to the unsharded run.

    ``on_quarantine`` is called once per stranded cell, at the moment the
    cell is given up on — the streaming-fragment aggregator uses it to
    account quarantined cells against their shard without waiting for the
    sweep to finish.

    ``KeyboardInterrupt`` and other ``BaseException``s (including the
    injected :class:`SweepKilled`) propagate — only ``Exception``-level
    failures are survivable, and of those not a :func:`device_fault`.
    """
    policy = policy or ResiliencePolicy()
    watchdog = watchdog or StepWatchdog(threshold=policy.straggler_threshold)
    report = ResilienceReport()

    def attempt(bucket: int, idxs: list[int]) -> tuple[dict[int, Any] | None,
                                                       Exception | None, int]:
        last: Exception | None = None
        n = 0
        for try_no in range(policy.max_retries + 1):
            n += 1
            t0 = time.perf_counter()
            try:
                if fault_plan is not None:
                    fault_plan.before(bucket, idxs)
                out = simulate_fn(list(idxs))
                elapsed = time.perf_counter() - t0
                if watchdog.observe_step(report.n_batches, elapsed):
                    report.stragglers.append(
                        {"bucket": bucket, "n_cells": len(idxs),
                         "elapsed_s": round(elapsed, 6),
                         "ewma_s": round(watchdog.events[-1].ewma, 6)})
                report.n_batches += 1
                if fault_plan is not None:
                    out = fault_plan.after(bucket, idxs, out)
                return out, None, n
            except Exception as e:  # noqa: BLE001 — isolation boundary
                if device_fault(e):
                    raise
                last = e
                if try_no < policy.max_retries:
                    report.retries += 1
                    policy.sleep(policy.backoff_base_s
                                 * policy.backoff_factor ** try_no)
        return None, last, n

    def run_isolated(bucket: int, idxs: list[int]) -> None:
        out, err, n = attempt(bucket, idxs)
        if err is None:
            commit_fn(out)  # type: ignore[arg-type]
            return
        if len(idxs) > 1 and policy.bisect:
            report.bisections += 1
            mid = len(idxs) // 2
            run_isolated(bucket, idxs[:mid])
            run_isolated(bucket, idxs[mid:])
            return
        for i in idxs:
            q = QuarantinedCell(index=i, bucket=bucket,
                                error=f"{type(err).__name__}: {err}",
                                attempts=n)
            report.quarantined.append(q)
            if on_quarantine is not None:
                on_quarantine(q)

    for submission, idxs in enumerate(buckets):
        bucket = bucket_ids[submission] if bucket_ids is not None else submission
        run_isolated(bucket, list(idxs))

    report.ewma_s = watchdog.ewma
    return report
