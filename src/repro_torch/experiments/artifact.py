"""Versioned JSON artifacts for experiment sweeps.

A copy of ``repro.experiments.artifact``: the same schemas, so the port's
artifacts and the JAX package's read, merge and compare as one.

Three schemas, all carrying an explicit ``schema_version``:

* ``repro.sweep/v1`` — one grid run (produced by ``SweepResult.to_json``):
  ``{schema_version, grid, stats, cells[]}`` where every cell records its
  workload, policy, config overrides, content-hash key, raw ``SimResult``
  counters, and derived metrics (IPC, row-hit rate, energy, ...).
* ``repro.sweep-fragment/v1`` — one shard's slice of a sweep, streamed to
  disk while the sweep is still running
  (:mod:`repro_torch.experiments.sharding`).
  Fragments carry global cell indices and a grid fingerprint;
  ``merge_fragments`` reassembles the exact ``repro.sweep/v1`` cell ordering
  from any set of fragments (see docs/experiments.md, "Sharded execution").
* ``repro.bench/v1`` — one ``benchmarks.run`` invocation: a set of benchmark
  summaries plus every sweep artifact the benchmarks produced, under a single
  top-level document (see ``docs/experiments.md`` for the field reference).
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any

SWEEP_SCHEMA = "repro.sweep/v1"
FRAGMENT_SCHEMA = "repro.sweep-fragment/v1"
BENCH_SCHEMA = "repro.bench/v1"


def git_sha(cwd: str | None = None) -> str:
    """Current git commit (with ``-dirty`` suffix), or ``"unknown"``.

    Embedded in every ``repro.bench/v1`` artifact so a result can always be
    traced back to the exact code that produced it. Defaults to THIS file's
    repository, not the process working directory (benchmarks may be invoked
    from anywhere).
    """
    if cwd is None:
        cwd = os.path.dirname(os.path.abspath(__file__))
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=5, check=True).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], cwd=cwd, capture_output=True,
            text=True, timeout=5, check=True).stdout.strip()
        return sha + ("-dirty" if dirty else "")
    except (OSError, subprocess.SubprocessError):
        # expected when git is absent, the dir is not a checkout, or the
        # probe times out — anything else is a real bug and must surface
        return "unknown"


def bench_artifact(results: dict[str, Any], sweeps: list[dict[str, Any]],
                   argv: list[str] | None = None,
                   cache_stats: dict[str, Any] | None = None,
                   seed: int | None = None,
                   fault_injection: str | None = None,
                   sharding: dict[str, Any] | None = None) -> dict[str, Any]:
    """Assemble the single top-level document ``benchmarks.run`` emits.

    ``fault_injection`` records the ``--inject-faults`` spec (when one was
    active) so a quarantine-bearing artifact is self-describing: validators
    and humans can tell deliberate fault drills from organic failures.
    ``sharding`` likewise records the shard plan (``--shards``/``--mesh``)
    so an artifact produced by sharded execution names its device mesh and
    fragment directory — required by ``validate.py --check-shards``.
    """
    return {
        "schema_version": BENCH_SCHEMA,
        "created_unix": time.time(),
        "git_sha": git_sha(),
        "seed": seed,
        "argv": argv or [],
        "results": results,
        "sweeps": sweeps,
        "cache_stats": cache_stats or {},
        "fault_injection": fault_injection,
        "sharding": sharding,
    }


def write_artifact(path: str, doc: dict[str, Any]) -> str:
    """Write an artifact document as JSON, creating parent dirs. Returns path.

    Crash-consistent: the document is written to a temp file and atomically
    renamed into place, so a killed run leaves either the previous artifact
    or the new one — never a truncated JSON that downstream validation would
    choke on.
    """
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=False, default=_default)
    os.replace(tmp, path)
    return path


def read_artifact(path: str | os.PathLike) -> dict[str, Any]:
    """Load any artifact document (sweep, fragment, or bench) back from disk."""
    with open(path) as f:
        return json.load(f)


def _default(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)
