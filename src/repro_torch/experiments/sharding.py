"""Device-aware sharded sweep execution with streaming shard fragments (the
port of ``repro.experiments.sharding``).

The sweep runner buckets cells by static compile signature and executes each
bucket as one vmapped simulator call. Every lane of that call is independent
(one trace, one policy, one config — no cross-lane state), so a bucket's cell
axis can be partitioned across devices and the per-cell counters are
bit-identical by construction. This module is the scheduler that does the
partitioning, plus the streaming aggregator that turns per-shard commits into
on-disk ``repro.sweep-fragment/v1`` documents and reassembles the exact
single-device ``repro.sweep/v1`` artifact from them.

Design notes (why per-shard dispatch, not one launch over every device):

* **Fault isolation.** The whole point of running shards through
  :func:`repro_torch.experiments.resilience.execute_buckets` is that a
  poisoned cell strands only its own shard — retry, bisection, and
  quarantine all operate per submission. Each shard is therefore its own
  submission: its simulate call is handed the shard's ``torch.device``
  explicitly (no process-wide default device is set) and goes through the
  same retry → bisect → quarantine machinery as an unsharded bucket.
* **Ragged shards.** ``np.array_split`` partitioning leaves the last shards
  one cell short whenever ``len(bucket) % n_shards != 0``; independent
  dispatch handles ragged shapes for free, where one fused launch would
  need padding lanes and a masked unpad.
* **Devices.** A plan holds ``torch.device``s: by default every CUDA device,
  and it raises when there is none (the port's rule: the CPU runs only when
  asked for). ``describe()`` embeds the same ``mesh_axes`` record as the
  reference (one ``"shards"`` axis over the plan's devices) and the device
  list in artifact stats, so a sharded run is self-describing.

Streaming fragments replace whole-sweep materialization: as soon as every
cell of a shard is accounted for (committed or quarantined), the shard's
slice of the artifact is written to ``<fragment_dir>/fragment-NNNN.json``.
Cache-hit cells resolved before execution stream out immediately as a
``prologue`` fragment — on a journal-backed resume
(:class:`repro_torch.experiments.cache.PersistentResultCache`) a killed run's
completed cells land there, so fragment coverage is complete without
re-executing anything. ``merge_fragments`` reassembles the final document:
cells sorted by global index (= ``grid.expand()`` order — bit-identical to
the single-device artifact), quarantine records sorted by (bucket, index)
(= submission order), and a coverage proof that every grid index appears
exactly once across cells + quarantined.
"""
from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.dram import registry
from repro_torch.experiments.artifact import (FRAGMENT_SCHEMA, SWEEP_SCHEMA,
                                              read_artifact, write_artifact)
from repro_torch.experiments.resilience import (FaultPlan, QuarantinedCell,
                                                ResiliencePolicy,
                                                ResilienceReport,
                                                execute_buckets)
from repro_torch.fault.watchdog import StepWatchdog

#: Platform names the mesh spec may address (``"<platform>[:<count>]"``):
#: ``gpu`` is the CUDA devices, ``cpu`` torch's one CPU device.
_MESH_PLATFORMS = ("cpu", "gpu")

registry.register("mesh platform", ("auto",) + _MESH_PLATFORMS)


def device_of(device: Any) -> torch.device:
    """``device`` as a plan holds it: a ``torch.device``, a CUDA one with its
    index (``"cuda"`` is the current CUDA device). Raises as the entry points
    do when it names CUDA and there is none."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(platform: str = "gpu") -> list[torch.device]:
    """Every device of a mesh platform: the CUDA devices for ``gpu`` (raises
    without one), the one CPU device for ``cpu``."""
    if platform == "cpu":
        return [torch.device("cpu")]
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_mesh(mesh: str | None = None) -> list[torch.device]:
    """Mesh spec -> device list (the spec-resolution half of ``--mesh``).

    Grammar: ``"auto"``/``None``/``""`` = all local devices (the CUDA
    devices), ``"<count>"`` = first N of them, ``"<platform>"`` = all
    devices of that platform, ``"<platform>:<count>"`` = first N of that
    platform. torch has one CPU device, so ``"cpu:4"`` selects one device.
    A platform typo raises the shared registry near-miss ``ValueError``
    (same format as every other spec axis); a syntactically valid spec
    that selects zero devices raises a plain ``ValueError``; a spec that
    needs CUDA raises ``RuntimeError`` on a machine without it.
    """
    spec = (mesh or "auto").strip().lower()
    if spec in ("", "auto"):
        devices = local_devices()
    elif spec.isdigit():
        devices = local_devices()[:int(spec)]
    else:
        platform, _, count = spec.partition(":")
        if platform not in _MESH_PLATFORMS:
            raise registry.spec_error(
                "mesh platform", platform, ("auto",) + _MESH_PLATFORMS,
                extra=" or '<count>' / '<platform>:<count>'")
        if count and not count.isdigit():
            raise ValueError(
                f"mesh spec {mesh!r}: count {count!r} is not an integer")
        devices = local_devices(platform)
        if count:
            devices = devices[:int(count)]
    if not devices:
        raise ValueError(f"mesh spec {mesh!r} selects no devices")
    return devices


@dataclasses.dataclass(frozen=True)
class Shard:
    """One shard submission: a contiguous slice of one logical bucket."""
    bucket: int                 # logical bucket (submission order)
    shard: int                  # shard index within the bucket
    cells: tuple[int, ...]      # global cell indices (grid.expand() order)


class ShardPlan:
    """How a sweep's buckets are split across devices.

    ``n_shards`` slices each bucket's cell axis into that many contiguous,
    balanced chunks (``np.array_split`` semantics — ragged last shards when
    the bucket size doesn't divide). Shard ``s`` of every bucket runs on
    ``devices[s % len(devices)]``, so ``n_shards`` may exceed the device
    count (useful for finer-grained streaming/fault granularity, and for
    exercising shard semantics on a single-device host).
    """

    def __init__(self, n_shards: int,
                 devices: Sequence[Any] | None = None) -> None:
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.devices = (tuple(device_of(d) for d in devices) if devices
                        else tuple(local_devices()))
        if not self.devices:
            raise ValueError("shard plan needs at least one device")

    @classmethod
    def resolve(cls, shards: int | None = None,
                mesh: str | None = None) -> "ShardPlan":
        """Build a plan from CLI-ish specs (thin alias over
        :func:`resolve_mesh` for the device-selection half).

        ``mesh`` selects devices: ``"auto"``/``None`` = all CUDA devices,
        ``"4"`` = first 4 of them, ``"gpu:4"`` = first 4 devices of that
        platform, ``"cpu"`` = all devices of that platform. ``shards``
        defaults to one shard per selected device.
        """
        devices = resolve_mesh(mesh)
        return cls(shards if shards else len(devices), devices)

    def device_for(self, shard_index: int) -> torch.device:
        return self.devices[shard_index % len(self.devices)]

    def partition(self, indices: Sequence[int]) -> list[list[int]]:
        """Contiguous balanced split; empty chunks dropped (fewer cells than
        shards), order preserved."""
        chunks = np.array_split(np.asarray(list(indices)), self.n_shards)
        return [c.tolist() for c in chunks if len(c)]

    def shards_for(self, buckets: Iterable[Sequence[int]]) -> list[Shard]:
        """Expand logical buckets into shard submissions, in submission
        order (bucket-major, then shard index)."""
        out = []
        for b, idxs in enumerate(buckets):
            for s, chunk in enumerate(self.partition(idxs)):
                out.append(Shard(bucket=b, shard=s, cells=tuple(chunk)))
        return out

    def describe(self) -> dict[str, Any]:
        return {
            "n_shards": self.n_shards,
            "n_devices": len(self.devices),
            "devices": [str(d) for d in self.devices],
            "mesh_axes": {"shards": len(self.devices)},
        }


def fragment_fingerprint(grid_doc: dict[str, Any], kind: str | None,
                         n_cells: int) -> str:
    """Identity of the sweep a fragment belongs to: fragments from different
    grids (or grid revisions) must never merge."""
    payload = json.dumps({"grid": grid_doc, "kind": kind, "n_cells": n_cells},
                         sort_keys=True, default=repr)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


class StreamingAggregator:
    """Turns per-shard commits into ``repro.sweep-fragment/v1`` documents.

    The runner registers every shard up front, then streams resolved cell
    JSONs (:meth:`commit_cells`) and quarantine records (:meth:`quarantine`)
    as execution proceeds. The moment a shard's last cell is accounted for,
    its fragment is emitted — appended to :attr:`fragments` and, when
    ``fragment_dir`` is set, written atomically to
    ``fragment-NNNN.json``. Nothing waits for the end of the sweep; a killed
    run leaves every finished shard's fragment on disk (and the per-cell
    journal lets the resume route the killed shard's committed cells through
    the prologue fragment instead of re-executing them).

    Cells resolved without executing a shard — cache hits, and duplicate-key
    cells whose representative was a hit — go through :meth:`prologue`.
    Duplicate-key cells resolved *by* a shard's commit ride along in that
    shard's fragment (they are accounted to the resolving shard, not to a
    shard of their own).
    """

    def __init__(self, grid_doc: dict[str, Any], n_cells: int, *,
                 kind: str | None = None,
                 fragment_dir: str | os.PathLike | None = None,
                 plan: ShardPlan | None = None) -> None:
        self.grid_doc = grid_doc
        self.n_cells = n_cells
        self.kind = kind
        self.fragment_dir = (os.fspath(fragment_dir)
                             if fragment_dir is not None else None)
        self.plan = plan
        self.fingerprint = fragment_fingerprint(grid_doc, kind, n_cells)
        self.fragments: list[dict[str, Any]] = []
        self.paths: list[str] = []
        self._seq = 0
        self._shard_of: dict[int, tuple[int, int]] = {}
        self._open: dict[tuple[int, int], dict[str, Any]] = {}

    def prologue(self, cells: list[tuple[int, dict[str, Any]]]) -> None:
        """Emit the pre-resolved cells (cache hits + their duplicates) as a
        fragment of their own, before any shard executes."""
        if cells:
            self._emit({"role": "prologue", "bucket": None, "shard": None,
                        "cells": [i for i, _ in cells]}, cells, [])

    def register_shard(self, shard: Shard) -> None:
        meta = {"role": "shard", "bucket": shard.bucket, "shard": shard.shard,
                "n_shards": self.plan.n_shards if self.plan else 1,
                "device": (str(self.plan.device_for(shard.shard))
                           if self.plan else None),
                "cells": list(shard.cells)}
        key = (shard.bucket, shard.shard)
        self._open[key] = {"meta": meta, "pending": set(shard.cells),
                           "cells": [], "quarantined": []}
        for i in shard.cells:
            self._shard_of[i] = key

    def commit_cells(self, resolved: list[tuple[int, dict[str, Any]]]) -> None:
        """Stream resolved cells; indices outside any registered shard
        (duplicate-key riders) attach to the shard being resolved."""
        owner: tuple[int, int] | None = None
        riders: list[tuple[int, dict[str, Any]]] = []
        touched: set[tuple[int, int]] = set()
        for i, doc in resolved:
            key = self._shard_of.get(i)
            if key is None:
                riders.append((i, doc))
                continue
            st = self._open[key]
            st["cells"].append(doc)
            st["pending"].discard(i)
            touched.add(key)
            owner = owner or key
        for i, doc in riders:
            if owner is None:
                raise ValueError(
                    f"cell {i} resolved outside any registered shard and no "
                    f"owning shard in the same commit")
            self._open[owner]["cells"].append(doc)
        for key in sorted(touched):
            self._maybe_close(key)

    def quarantine(self, index: int, record: dict[str, Any]) -> None:
        key = self._shard_of[index]
        st = self._open[key]
        st["quarantined"].append(record)
        st["pending"].discard(index)
        self._maybe_close(key)

    def _maybe_close(self, key: tuple[int, int]) -> None:
        st = self._open[key]
        if not st["pending"]:
            del self._open[key]
            self._emit(st["meta"], [(None, c) for c in st["cells"]],
                       st["quarantined"])

    def _emit(self, shard_meta: dict[str, Any],
              cells: list[tuple[Any, dict[str, Any]]],
              quarantined: list[dict[str, Any]]) -> None:
        frag = {
            "schema_version": FRAGMENT_SCHEMA,
            "kind": self.kind,
            "fingerprint": self.fingerprint,
            "n_cells": self.n_cells,
            "grid": self.grid_doc,
            "shard": shard_meta,
            "seq": self._seq,
            "cells": [doc for _, doc in cells],
            "quarantined": quarantined,
        }
        self._seq += 1
        self.fragments.append(frag)
        if self.fragment_dir is not None:
            path = os.path.join(self.fragment_dir,
                                f"fragment-{frag['seq']:04d}.json")
            self.paths.append(write_artifact(path, frag))


def execute_sharded(
    buckets: Iterable[Sequence[int]],
    simulate_fn: Callable[[list[int], torch.device], Any],
    commit_fn: Callable[[dict[int, Any]], None],
    *,
    plan: ShardPlan,
    aggregator: StreamingAggregator | None = None,
    quarantine_record: Callable[[QuarantinedCell], dict[str, Any]] | None = None,
    policy: ResiliencePolicy | None = None,
    fault_plan: FaultPlan | None = None,
    watchdog: StepWatchdog | None = None,
) -> tuple[ResilienceReport, list[Shard]]:
    """Partition buckets into shard submissions and run them through the
    retry → bisect → quarantine layer, each on its plan-assigned device.

    Serial: each shard is collected before the next is issued (a window of
    1), where the single-device path keeps up to 8 buckets in flight on a
    card; overlapping shards is not done here.

    ``commit_fn`` keeps the :func:`execute_buckets` contract;
    ``simulate_fn(indices, device)`` keeps it too (it returns the results or
    a function that collects them), and also takes the device of the shard
    the indices belong to, ``plan.device_for(s)``.
    ``bucket_ids`` preserve the logical bucket index for every shard, so
    ``FaultPlan`` ``bN`` targets and quarantine ``bucket`` provenance match
    the unsharded run exactly. Bisected sub-buckets stay inside one shard
    (bisection only ever narrows a submission), so the device assignment is
    stable all the way down to single-cell retries.
    """
    shards = plan.shards_for(buckets)
    shard_key_of: dict[int, tuple[int, int]] = {}
    for sh in shards:
        for i in sh.cells:
            shard_key_of[i] = (sh.bucket, sh.shard)
        if aggregator is not None:
            aggregator.register_shard(sh)

    def simulate_on_device(idxs: list[int]) -> Any:
        _, s = shard_key_of[idxs[0]]
        return simulate_fn(idxs, plan.device_for(s))

    on_q = None
    if aggregator is not None:
        if quarantine_record is None:
            raise ValueError("aggregator needs a quarantine_record function")

        def on_q(q: QuarantinedCell) -> None:
            aggregator.quarantine(q.index, quarantine_record(q))

    report = execute_buckets(
        [list(sh.cells) for sh in shards], simulate_on_device, commit_fn,
        policy=policy, fault_plan=fault_plan, watchdog=watchdog,
        bucket_ids=[sh.bucket for sh in shards], on_quarantine=on_q)
    return report, shards


def load_fragments(fragment_dir: str | os.PathLike) -> list[dict[str, Any]]:
    """Read every ``fragment-*.json`` under a directory, in seq order."""
    paths = sorted(glob.glob(os.path.join(os.fspath(fragment_dir),
                                          "fragment-*.json")))
    if not paths:
        raise FileNotFoundError(f"no fragment-*.json under {fragment_dir}")
    return [read_artifact(p) for p in paths]


def merge_fragments(fragments: Sequence[dict[str, Any]], *,
                    require_full: bool = True) -> dict[str, Any]:
    """Reassemble a ``repro.sweep/v1`` document from shard fragments.

    The merge contract:

    * every fragment must carry the same fingerprint (same grid, kind, and
      cell count — fragments from different sweeps never mix);
    * each global cell index appears **exactly once** across all fragments'
      cells + quarantine records (no loss, no double-commit);
    * merged ``cells`` are sorted by global index — i.e. ``grid.expand()``
      order, bit-identical to the single-device artifact's cell list once
      the bookkeeping ``index`` field is stripped;
    * merged ``quarantined`` records are sorted by (bucket, index) —
      submission order, matching the unsharded runner's quarantine list;
    * merged ``stats`` are pure functions of the fragments (counts only, no
      wall-clock), so the same fragments always merge to the same bytes.

    ``require_full=False`` permits an incomplete index set (a sweep whose
    duplicate-key cells lost their representative to quarantine can never
    reach full coverage — the runner mirrors the unsharded behaviour and
    omits those cells from both lists).
    """
    if not fragments:
        raise ValueError("no fragments to merge")
    frags = sorted(fragments, key=lambda f: f.get("seq", 0))
    first = frags[0]
    fp = first.get("fingerprint")
    n_cells = first.get("n_cells")
    kind = first.get("kind")
    cells_by_index: dict[int, dict[str, Any]] = {}
    quarantined: list[dict[str, Any]] = []
    seen: set[int] = set()
    for f in frags:
        if f.get("schema_version") != FRAGMENT_SCHEMA:
            raise ValueError(f"not a sweep fragment: "
                             f"{f.get('schema_version')!r}")
        if f.get("fingerprint") != fp:
            raise ValueError(f"fragment fingerprint mismatch: "
                             f"{f.get('fingerprint')!r} != {fp!r}")
        for cell in f.get("cells") or ():
            cell = dict(cell)
            i = cell.pop("index")
            if i in seen:
                raise ValueError(f"cell index {i} appears in more than one "
                                 f"fragment record")
            seen.add(i)
            cells_by_index[i] = cell
        for q in f.get("quarantined") or ():
            i = q["index"]
            if i in seen:
                raise ValueError(f"cell index {i} is both committed and "
                                 f"quarantined across fragments")
            seen.add(i)
            quarantined.append(q)
    if not all(0 <= i < n_cells for i in seen):
        raise ValueError(f"cell index out of range for n_cells={n_cells}")
    if require_full and len(seen) != n_cells:
        missing = sorted(set(range(n_cells)) - seen)[:8]
        raise ValueError(
            f"fragments cover {len(seen)}/{n_cells} cells "
            f"(first missing: {missing}) — incomplete or lost fragment")
    quarantined.sort(key=lambda q: (q.get("bucket", 0), q["index"]))
    doc: dict[str, Any] = {"schema_version": SWEEP_SCHEMA}
    if kind is not None:
        doc["kind"] = kind
    doc.update({
        "grid": first.get("grid"),
        "stats": {
            "n_cells": n_cells,
            "merged_cells": len(cells_by_index),
            "quarantined_cells": n_cells - len(cells_by_index),
            "n_fragments": len(frags),
            "n_shards": sum(1 for f in frags
                            if (f.get("shard") or {}).get("role") == "shard"),
        },
        "cells": [cells_by_index[i] for i in sorted(cells_by_index)],
        "quarantined": quarantined,
    })
    return doc


def merge_fragment_dir(fragment_dir: str | os.PathLike, *,
                       require_full: bool = True) -> dict[str, Any]:
    """:func:`merge_fragments` over everything in a fragment directory."""
    return merge_fragments(load_fragments(fragment_dir),
                           require_full=require_full)
