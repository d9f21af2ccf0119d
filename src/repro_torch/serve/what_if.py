"""Interactive what-if queries over merged sweep fragments (the port of
``repro.serve.what_if``).

The ROADMAP's end state for the sweep service: a long-lived process that has
(or lazily merges) the fragments a sharded sweep streamed to disk and answers
"my workload — which configuration?" without re-running anything. This module
is that query layer:

    from repro_torch.serve import SweepIndex, what_if

    idx = SweepIndex.from_fragments("artifacts/fragments/smoke")
    best = idx.what_if("mcf", {"n_subarrays": 8})          # ranked configs
    best = what_if("mcf", fragments="artifacts/fragments") # convenience

A :class:`SweepIndex` ingests any mix of ``repro.sweep/v1`` documents —
merged from fragment directories
(:func:`repro_torch.experiments.merge_fragments` proves coverage on the way
in), pulled out of a ``repro.bench/v1`` artifact,
or handed over directly — and serves ranked candidate cells for a workload
under optional axis constraints. Quarantined cells are never candidates (a
stranded cell has no counters), but their records are kept so an answer can
say when a potentially-better configuration is missing.
"""
from __future__ import annotations

import enum
import os
from typing import Any, Iterable

from repro_torch.experiments.artifact import (BENCH_SCHEMA, SWEEP_SCHEMA,
                                              read_artifact)
from repro_torch.experiments.sharding import merge_fragment_dir

#: Metrics where smaller is better; anything else ranks descending.
_MINIMIZE = {"total_cycles", "avg_read_latency_cpu", "dynamic_nj", "total_nj"}


def _axis_value(v: Any) -> Any:
    """Axis constraints arrive as python values (possibly enums); cells store
    the JSON-safe form (enum names)."""
    return v.name if isinstance(v, enum.Enum) else v


class SweepIndex:
    """Queryable view over one or more ``repro.sweep/v1`` documents."""

    def __init__(self, sweeps: Iterable[dict[str, Any]]) -> None:
        self.sweeps = list(sweeps)
        for s in self.sweeps:
            if s.get("schema_version") != SWEEP_SCHEMA:
                raise ValueError(f"not a {SWEEP_SCHEMA} document: "
                                 f"{s.get('schema_version')!r}")

    @classmethod
    def from_fragments(cls, root: str | os.PathLike) -> "SweepIndex":
        """Merge fragment directories under ``root`` (the ``benchmarks.run
        --fragments`` layout: one subdir per grid) — or ``root`` itself when
        it directly holds ``fragment-*.json``."""
        root = os.fspath(root)
        subdirs = sorted(
            os.path.join(root, d) for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not subdirs:
            subdirs = [root]
        return cls(merge_fragment_dir(d) for d in subdirs)

    @classmethod
    def from_artifact(cls, doc: dict[str, Any] | str | os.PathLike) -> "SweepIndex":
        """Ingest a ``repro.bench/v1`` artifact (all its sweeps) or a single
        ``repro.sweep/v1`` document, by value or by path."""
        if not isinstance(doc, dict):
            doc = read_artifact(doc)
        if doc.get("schema_version") == BENCH_SCHEMA:
            return cls(doc.get("sweeps") or ())
        return cls([doc])

    def _grid_of(self, sweep: dict[str, Any]) -> dict[str, Any]:
        return sweep.get("grid") or {}

    def _cell_matches(self, sweep: dict[str, Any], cell: dict[str, Any],
                      workload: str, axes: dict[str, Any]) -> bool:
        wl = cell.get("workload") or cell.get("mix", "")
        if workload not in (wl, *wl.split("+")):
            return False
        base = self._grid_of(sweep).get("base_config") or {}
        for k, v in axes.items():
            got = cell.get("overrides", {}).get(k, base.get(k))
            if got != _axis_value(v):
                return False
        return True

    def _metric_of(self, cell: dict[str, Any], metric: str) -> float | None:
        for table in (cell.get("counters") or {}, cell.get("derived") or {},
                      cell):
            if metric in table and isinstance(table[metric], (int, float)):
                return float(table[metric])
        return None

    def what_if(self, workload: str, axes: dict[str, Any] | None = None, *,
                metric: str = "total_cycles", minimize: bool | None = None,
                top: int = 5) -> dict[str, Any]:
        """Rank every matching cell by ``metric`` and return the best.

        ``axes`` constrains ``SimConfig`` fields (matched against each cell's
        overrides, falling back to its grid's base config) — e.g.
        ``{"n_subarrays": 8}``. ``minimize`` defaults per metric
        (cycle/latency/energy metrics minimize; IPC-like metrics maximize).
        The answer names the winning (grid, policy, overrides) plus a
        ranking, and counts quarantined cells that matched the query so a
        caller knows when the answer is built on a partial sweep.
        """
        axes = axes or {}
        if minimize is None:
            minimize = metric in _MINIMIZE
        candidates: list[dict[str, Any]] = []
        n_quarantined = 0
        for sweep in self.sweeps:
            name = self._grid_of(sweep).get("name")
            for cell in sweep.get("cells") or ():
                if not self._cell_matches(sweep, cell, workload, axes):
                    continue
                val = self._metric_of(cell, metric)
                if val is None:
                    continue
                candidates.append({
                    "grid": name,
                    "workload": cell.get("workload") or cell.get("mix"),
                    "policy": cell.get("policy"),
                    "overrides": cell.get("overrides") or {},
                    metric: val,
                })
            for q in sweep.get("quarantined") or ():
                if workload in ((q.get("workload") or q.get("mix", "")),
                                *str(q.get("mix", "")).split("+")):
                    n_quarantined += 1
        if not candidates:
            raise LookupError(
                f"no cells for workload {workload!r} under {axes} "
                f"(metric {metric!r}) in {len(self.sweeps)} sweep(s)")
        candidates.sort(key=lambda c: (c[metric] if minimize else -c[metric],
                                       c["grid"] or "", c["policy"] or ""))
        return {
            "workload": workload,
            "axes": {k: _axis_value(v) for k, v in axes.items()},
            "metric": metric,
            "minimize": minimize,
            "n_candidates": len(candidates),
            "n_quarantined_matches": n_quarantined,
            "best": candidates[0],
            "ranking": candidates[:top],
        }


def what_if(workload: str, axes: dict[str, Any] | None = None, *,
            fragments: str | os.PathLike | None = None,
            artifact: dict[str, Any] | str | os.PathLike | None = None,
            **query: Any) -> dict[str, Any]:
    """One-shot convenience: build a :class:`SweepIndex` from a fragment
    directory or an artifact and answer a single query."""
    if (fragments is None) == (artifact is None):
        raise ValueError("pass exactly one of fragments= or artifact=")
    idx = (SweepIndex.from_fragments(fragments) if fragments is not None
           else SweepIndex.from_artifact(artifact))
    return idx.what_if(workload, axes, **query)
