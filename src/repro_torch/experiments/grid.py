"""Declarative experiment grids (the port of ``repro.experiments.grid``).

A :class:`SweepGrid` names the full cross product the paper's evaluations are
made of — policies x workloads x ``SimConfig`` axes — without saying anything
about execution order, batching, or caching. The runner
(:mod:`repro_torch.experiments.runner`) expands the grid into :class:`Cell`s,
groups cells that share static shapes into single batched simulator calls, and
consults a content-hashed result cache so no (trace, policy, config) point is
ever simulated twice.

Two ways to span configurations:

* ``config_axes={"n_subarrays": (1, 2, 4, 8)}`` — cartesian product over
  ``SimConfig`` fields (the Sec. 9.2 sensitivity shape), and/or
* ``configs=({}, {"refresh_policy": "per_bank"}, {"refresh_policy": "darp"})``
  — an explicit list of override dicts (the refresh-ladder study shape).

``where(policy, overrides) -> bool`` prunes cells that make no sense (e.g.
DSARP under the baseline policy, which is defined to equal blocking refresh).

Two grid flavours share the config-span machinery:

* :class:`SweepGrid` — single-core cells (workload x policy x config); runs
  through :func:`repro_torch.experiments.runner.run_sweep`.
* :class:`MixGrid` — multi-core cells (mix x policy x config, where a mix is
  a tuple of workloads sharing one channel); runs through
  :func:`repro_torch.experiments.runner.run_mix_sweep`. The ``scheduler`` /
  ``refresh`` ``SimConfig`` axes make this the paper's scheduler-combination
  evaluation surface (policy x scheduler x mix).

``describe()`` renders ``base_config`` as the reference does, ``backend``
field included (:func:`repro_torch.experiments.cache.reference_fields`), so
the port's artifacts equal the JAX package's. The port's ``SimConfig`` has
no ``backend`` field, so a grid that sweeps it is refused as an unknown
field.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core.dram.engine import SimConfig
from repro_torch.core.dram.policies import Policy
from repro_torch.core.dram.trace import ROW_SPACE_STRIDE, WorkloadProfile
from repro_torch.experiments.cache import reference_fields

DEFAULT_SEED = 7


def _validate_config_span(base_config: SimConfig,
                          config_axes: Mapping[str, Sequence[Any]],
                          configs: Sequence[Mapping[str, Any]] | None) -> None:
    if configs is not None and config_axes:
        raise ValueError("pass either config_axes (product) or configs "
                         "(explicit list), not both")
    for field in config_axes:
        if not hasattr(base_config, field):
            raise ValueError(f"unknown SimConfig field in config_axes: {field!r}")
    for c in configs or ():
        for field in c:
            if not hasattr(base_config, field):
                raise ValueError(f"unknown SimConfig field in configs: {field!r}")


def _config_points(config_axes: Mapping[str, Sequence[Any]],
                   configs: Sequence[Mapping[str, Any]] | None) -> list[dict[str, Any]]:
    if configs is not None:
        return [dict(c) for c in configs]
    if not config_axes:
        return [{}]
    keys = list(config_axes)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(config_axes[k] for k in keys))]


@dataclasses.dataclass(frozen=True)
class Cell:
    """One point of the grid: simulate `workload` under `policy` at `config`."""
    workload: WorkloadProfile
    policy: Policy
    config: SimConfig
    overrides: tuple[tuple[str, Any], ...]  # (field, value) pairs applied to base_config

    @property
    def override_dict(self) -> dict[str, Any]:
        return dict(self.overrides)


@dataclasses.dataclass
class SweepGrid:
    """Declarative description of one experiment sweep."""
    name: str
    workloads: Sequence[WorkloadProfile]
    policies: Sequence[Policy]
    n_requests: int = 4000
    seed: int = DEFAULT_SEED
    base_config: SimConfig = SimConfig()
    config_axes: Mapping[str, Sequence[Any]] = dataclasses.field(default_factory=dict)
    configs: Sequence[Mapping[str, Any]] | None = None
    where: Callable[[Policy, dict[str, Any]], bool] | None = None
    #: Physical-address mode: confine each workload's resident set to a
    #: contiguous region of this many rows (None = historical uniform rows).
    #: Part of every trace's identity; see docs/address-mapping.md.
    footprint_rows: int | None = None

    def __post_init__(self) -> None:
        _validate_config_span(self.base_config, self.config_axes, self.configs)

    def config_points(self) -> list[dict[str, Any]]:
        """The list of override dicts this grid spans (order is canonical)."""
        return _config_points(self.config_axes, self.configs)

    def expand(self) -> list[Cell]:
        """Expand to cells in canonical order: config point, workload, policy."""
        cells = []
        for ov in self.config_points():
            cfg = dataclasses.replace(self.base_config, **ov)
            ov_t = tuple(sorted(ov.items()))
            for w in self.workloads:
                for pol in self.policies:
                    if self.where is not None and not self.where(pol, dict(ov)):
                        continue
                    cells.append(Cell(workload=w, policy=pol, config=cfg,
                                      overrides=ov_t))
        return cells

    def describe(self) -> dict[str, Any]:
        """JSON-safe summary of the grid (embedded in sweep artifacts)."""
        return {
            "name": self.name,
            "workloads": [w.name for w in self.workloads],
            "policies": [p.name for p in self.policies],
            "n_requests": self.n_requests,
            "seed": self.seed,
            "footprint_rows": self.footprint_rows,
            "base_config": _json_safe(reference_fields(self.base_config)),
            "config_axes": {k: [_json_safe(v) for v in vs]
                            for k, vs in self.config_axes.items()},
            "configs": ([{k: _json_safe(v) for k, v in c.items()}
                         for c in self.configs]
                        if self.configs is not None else None),
            "n_cells": len(self.expand()),
        }


@dataclasses.dataclass(frozen=True)
class MixCell:
    """One point of a mix grid: simulate `profiles` sharing one channel."""
    mix_index: int
    profiles: tuple[WorkloadProfile, ...]
    policy: Policy
    config: SimConfig
    overrides: tuple[tuple[str, Any], ...]

    @property
    def mix_name(self) -> str:
        return "+".join(p.name for p in self.profiles)

    @property
    def override_dict(self) -> dict[str, Any]:
        return dict(self.overrides)


@dataclasses.dataclass
class MixGrid:
    """Declarative multi-core sweep: mixes x policies x ``SimConfig`` axes.

    A *mix* is a tuple of workloads whose request streams share one channel
    (one row of the paper's Sec. 4 / 9.3 multi-core evaluation). All mixes
    must have the same core count so they share one compiled program. The
    ``scheduler`` config axis spans the request schedulers
    (:class:`repro_torch.core.dram.Scheduler`), making the paper's
    policy x scheduler x mix comparison a single grid.
    """
    name: str
    mixes: Sequence[Sequence[WorkloadProfile]]
    policies: Sequence[Policy]
    n_requests: int = 2000
    seed: int = DEFAULT_SEED
    base_config: SimConfig = SimConfig()
    config_axes: Mapping[str, Sequence[Any]] = dataclasses.field(default_factory=dict)
    configs: Sequence[Mapping[str, Any]] | None = None
    where: Callable[[Policy, dict[str, Any]], bool] | None = None
    #: Physical-address mode knob; see :class:`SweepGrid.footprint_rows`.
    footprint_rows: int | None = None

    def __post_init__(self) -> None:
        _validate_config_span(self.base_config, self.config_axes, self.configs)
        if not self.mixes:
            raise ValueError("MixGrid needs at least one mix")
        if self.footprint_rows is not None:
            if self.footprint_rows > ROW_SPACE_STRIDE:
                # per-core regions are offset by ROW_SPACE_STRIDE; a larger
                # footprint would silently overlap the cores' hot rows
                raise ValueError(
                    f"footprint_rows={self.footprint_rows} exceeds the "
                    f"per-core row-space stride ({ROW_SPACE_STRIDE}); cores "
                    f"of a mix would share hot rows")
        cores = {len(m) for m in self.mixes}
        if len(cores) != 1:
            raise ValueError(f"all mixes must have the same core count; got {sorted(cores)}")

    @property
    def n_cores(self) -> int:
        return len(self.mixes[0])

    def config_points(self) -> list[dict[str, Any]]:
        """The list of override dicts this grid spans (order is canonical)."""
        return _config_points(self.config_axes, self.configs)

    def expand(self) -> list[MixCell]:
        """Expand to cells in canonical order: config point, mix, policy."""
        cells = []
        for ov in self.config_points():
            cfg = dataclasses.replace(self.base_config, **ov)
            ov_t = tuple(sorted(ov.items()))
            for i, m in enumerate(self.mixes):
                for pol in self.policies:
                    if self.where is not None and not self.where(pol, dict(ov)):
                        continue
                    cells.append(MixCell(mix_index=i, profiles=tuple(m),
                                         policy=pol, config=cfg, overrides=ov_t))
        return cells

    def describe(self) -> dict[str, Any]:
        """JSON-safe summary of the grid (embedded in sweep artifacts)."""
        return {
            "name": self.name,
            "mixes": [[p.name for p in m] for m in self.mixes],
            "policies": [p.name for p in self.policies],
            "n_requests": self.n_requests,
            "seed": self.seed,
            "footprint_rows": self.footprint_rows,
            "base_config": _json_safe(reference_fields(self.base_config)),
            "config_axes": {k: [_json_safe(v) for v in vs]
                            for k, vs in self.config_axes.items()},
            "configs": ([{k: _json_safe(v) for k, v in c.items()}
                         for c in self.configs]
                        if self.configs is not None else None),
            "n_cells": len(self.expand()),
        }


def _json_safe(v: Any) -> Any:
    if isinstance(v, enum.Enum):
        return v.name
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return _json_safe(dataclasses.asdict(v))
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)
