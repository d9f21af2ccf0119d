"""Content-hashed result cache for the sweep runner (the port of
``repro.experiments.cache``).

The cache key is a digest of everything that determines a simulation's output:
the trace arrays themselves (not the generator parameters — anything producing
bit-identical requests hits the same entry), the policy, and the full
``SimConfig``. Values are plain dicts of python ints (the ``SimResult``
counters), so entries are JSON-serializable and comparable bit-for-bit.

The practical effect inside one process: the baseline is simulated exactly
once per (workload, geometry) cell no matter how many mechanism policies are
compared against it, and sweeps that share cells (fig4's 32x5 grid and fig5's
32x2 grid, say) share their results.

:class:`PersistentResultCache` extends the same store with a crash-consistent
on-disk journal, so completed cells survive the *process*: a killed or OOM'd
sweep re-run from the journal replays every finished cell from disk and only
executes the remainder (see docs/experiments.md, "Resilience").

Keys equal the reference's: :func:`cell_key` hashes the config as
:func:`reference_fields` renders it, with the reference's ``backend`` field
at its default, so a journal written by the JAX package replays here as
hits, and one written here replays there.

A key is :func:`trace_digest` (the trace's arrays) finished by
:func:`finish_key` (the window, policy and config). ``run_sweep`` digests
each distinct trace object once a call and finishes every cell's key from
a copy of that state; no digest outlives the call, since trace arrays are
mutable.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any

import numpy as np

from repro_torch.core.dram.engine import SimConfig
from repro_torch.core.dram.policies import Policy
from repro_torch.core.dram.trace import Trace

#: The reference's ``SimConfig`` field that the port's lacks, at its default:
#: it named the reference's executor (the port's is the ``device``), and it
#: sits just before ``memtech``.
REFERENCE_BACKEND = ("backend", "scan")


def reference_fields(config: SimConfig) -> dict[str, Any]:
    """``config``'s fields as the reference's ``SimConfig`` holds them: in
    its order, with ``backend`` at its default. Cell keys and grid
    descriptions both render a config through this."""
    out: dict[str, Any] = {}
    for f in dataclasses.fields(config):
        if f.name == "memtech":
            out[REFERENCE_BACKEND[0]] = REFERENCE_BACKEND[1]
        out[f.name] = getattr(config, f.name)
    return out


def trace_digest(trace: Trace) -> Any:
    """The ``hashlib.sha256`` state after ``trace``'s six arrays: the part of a
    :func:`cell_key` that every cell of one trace shares."""
    h = hashlib.sha256()
    for arr in (trace.bank, trace.subarray, trace.row,
                trace.is_write, trace.gap, trace.dep):
        a = np.ascontiguousarray(arr)
        h.update(str(a.dtype).encode())
        h.update(a)
    return h


def finish_key(digest: Any, trace: Trace, policy: Policy,
               config: SimConfig) -> str:
    """The :func:`cell_key` of (``trace``, ``policy``, ``config``), finished
    from a copy of ``digest``, which is ``trace_digest(trace)`` and is left
    as it was."""
    h = digest.copy()
    fields = tuple(dataclasses.astuple(v) if dataclasses.is_dataclass(v)
                   else v for v in reference_fields(config).values())
    h.update(repr((int(trace.mlp_window), int(policy), fields)).encode())
    return h.hexdigest()[:24]


def cell_key(trace: Trace, policy: Policy, config: SimConfig) -> str:
    """Content hash of one (trace, policy, config) simulation point."""
    return finish_key(trace_digest(trace), trace, policy, config)


class ResultCache:
    """In-memory {cell_key: counters-dict} store with hit/miss accounting.

    ``get``/``put`` exchange *defensive copies*: a caller mutating the dict it
    passed in or got back can never corrupt the cached counters (which other
    sweeps — and, in the persistent subclass, the on-disk journal — trust
    bit-for-bit).
    """

    def __init__(self) -> None:
        self._store: dict[str, dict[str, int]] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: str) -> bool:
        return key in self._store

    def get(self, key: str) -> dict[str, int] | None:
        out = self._store.get(key)
        if out is None:
            self.misses += 1
            return None
        self.hits += 1
        return dict(out)

    def put(self, key: str, counters: dict[str, int]) -> None:
        self._store[key] = dict(counters)

    def flush(self) -> None:
        """Durability hook: the runner calls this after committing each
        bucket. A no-op for the in-memory store."""

    def stats(self) -> dict[str, Any]:
        return {"entries": len(self._store), "hits": self.hits,
                "misses": self.misses}


class PersistentResultCache(ResultCache):
    """Result cache backed by an append-only JSON-lines journal on disk.

    One line per cell — ``{"key": <cell_key>, "counters": {...}}`` — loaded
    at construction, so re-running any sweep (across processes and PRs)
    replays completed cells from the journal and only executes the remainder.

    Crash consistency: ``flush()`` (called by the runner after every
    committed bucket or shard) appends the entries added since the last
    flush and fsyncs — counters are deterministic, so journal entries are
    write-once and appending keeps per-commit cost proportional to the
    commit, not the store (sharded sweeps flush once per *shard*; a full
    rewrite each time would be quadratic at scale). A kill mid-append can
    tear at most the trailing line, which the loader tolerates: bad lines
    are counted in ``dropped`` and skipped, never fatal — losing one cached
    cell costs one re-simulation, while refusing the whole journal would
    cost the entire sweep. The rare non-append case (an existing key's
    counters changed) falls back to the original full rewrite via
    ``<path>.tmp.<pid>`` + atomic rename.
    """

    def __init__(self, path: str | os.PathLike) -> None:
        super().__init__()
        self.path = os.fspath(path)
        self.loaded = 0     # journal entries restored at construction
        self.dropped = 0    # malformed/torn lines skipped at construction
        self._dirty = False
        self._appendable: list[str] = []  # brand-new keys since last flush
        self._rewrite = False             # an existing key changed → rewrite
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                lines = f.readlines()
        except FileNotFoundError:
            return
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                key = rec["key"]
                counters = {str(k): int(v) for k, v in rec["counters"].items()}
                if not isinstance(key, str) or not counters:
                    raise ValueError(line)
            except (json.JSONDecodeError, KeyError, TypeError,
                    ValueError, AttributeError):
                self.dropped += 1
                continue
            self._store[key] = counters
            self.loaded += 1

    def put(self, key: str, counters: dict[str, int]) -> None:
        cur = self._store.get(key)
        if cur != counters:
            self._dirty = True
            if cur is None:
                self._appendable.append(key)
            else:
                self._rewrite = True
        super().put(key, counters)

    def flush(self) -> None:
        """Persist entries added since the last flush (append + fsync), or
        rewrite the whole journal atomically when an entry changed."""
        if not self._dirty:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        if self._rewrite:
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                for key, counters in self._store.items():
                    f.write(json.dumps({"key": key, "counters": counters},
                                       sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._rewrite = False
        else:
            with open(self.path, "a") as f:
                for key in self._appendable:
                    f.write(json.dumps({"key": key,
                                        "counters": self._store[key]},
                                       sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
        self._appendable = []
        self._dirty = False

    def stats(self) -> dict[str, Any]:
        return {**super().stats(), "journal": self.path,
                "loaded": self.loaded, "dropped": self.dropped}


#: Process-wide default cache: benchmarks run back-to-back by
#: ``benchmarks.run`` share baselines through this instance.
GLOBAL_CACHE = ResultCache()


def install_global_cache(cache: ResultCache) -> ResultCache:
    """Swap the process-wide cache (e.g. for a journal-backed
    :class:`PersistentResultCache`); returns the previous instance.

    Rebinds both this module's ``GLOBAL_CACHE`` and the
    ``repro_torch.experiments`` package alias, so call sites using either
    import path agree.
    """
    global GLOBAL_CACHE
    prev = GLOBAL_CACHE
    GLOBAL_CACHE = cache
    import repro_torch.experiments as pkg
    pkg.GLOBAL_CACHE = cache
    return prev
