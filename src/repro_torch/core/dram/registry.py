"""The ONE spec-string resolver behind every config axis.

Since PR 4 each string-valued axis grew its own resolver — address mappings
(``mapping_for``), workload names (``trace.workload``), the refresh ladder
(``RefreshPolicy.from_spec``), the backend check in ``SimConfig``, the mesh
spec in ``repro.experiments.sharding`` — and with the memtech axis the
"every axis invents its own lookup + error" pattern stopped scaling. This
module is the single implementation all of them now route through:

* :func:`resolve` — validate a spec string against a kind's registered
  choices and return the canonical spelling (or the mapped value).
* :func:`spec_error` — build the uniform near-miss ``ValueError`` every
  axis raises on a typo::

      unknown <kind> 'spc' (did you mean 'spec'?); expected one of [...]

  The ``(did you mean ...)`` hint comes from :func:`difflib`-based
  :func:`repro_torch.core.dram.errors.did_you_mean` and is omitted when nothing
  is close. Tests pin this exact shape for every axis
  (``tests/test_registry.py``), so error UX cannot drift per-axis again.
* :func:`register` / :func:`choices` — the kind -> valid-spec table, so
  tools (CLIs, docs, tests) can enumerate every axis programmatically.

The historical entry points (``mapping_for``, ``workload``, ``from_spec``,
``SimConfig(backend=...)``, ``resolve_mesh``) keep their signatures — they
are thin aliases over :func:`resolve` now, so no caller breaks.

Port note: a framework-free copy of ``repro.core.dram.registry``, with
import paths rewritten to ``repro_torch`` (the port never imports
the JAX package); tests/test_torch_frontend.py holds it equal to
the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Mapping

from repro_torch.core.dram.errors import did_you_mean

#: kind -> tuple of valid canonical specs (or a callable producing them,
#: for axes whose choices are computed lazily, e.g. jax platforms).
_REGISTRY: dict[str, Callable[[], tuple[str, ...]]] = {}


def register(kind: str, specs: Iterable[str] | Callable[[], Iterable[str]]) -> None:
    """Register (or re-register) the valid specs for an axis ``kind``."""
    if callable(specs):
        _REGISTRY[kind] = lambda: tuple(specs())
    else:
        frozen = tuple(specs)
        _REGISTRY[kind] = lambda: frozen


def kinds() -> tuple[str, ...]:
    """Every registered axis kind, sorted (for docs/tests/CLIs)."""
    return tuple(sorted(_REGISTRY))


def choices(kind: str) -> tuple[str, ...]:
    """The valid canonical specs for ``kind`` (raises on unknown kind)."""
    try:
        return _REGISTRY[kind]()
    except KeyError:
        raise ValueError(f"unknown spec kind {kind!r}; registered kinds: "
                         f"{list(kinds())}") from None


def spec_error(kind: str, spec: Any, valid: Iterable[str] | None = None, *,
               extra: str = "") -> ValueError:
    """The uniform near-miss error every spec axis raises on a typo.

    ``extra`` extends the expected-one-of clause for axes that also accept
    a structured grammar (e.g. ``'bits:<order>'`` mappings, ``'cpu:4'``
    meshes) on top of the named choices.
    """
    valid_sorted = sorted(valid if valid is not None else choices(kind))
    hint = did_you_mean(str(spec), valid_sorted)
    return ValueError(f"unknown {kind} {spec!r}{hint}; "
                      f"expected one of {valid_sorted}{extra}")


def resolve(kind: str, spec: Any, valid: Iterable[str] | None = None, *,
            mapping: Mapping[str, Any] | None = None,
            normalize: Callable[[str], str] = str,
            extra: str = "") -> Any:
    """Validate ``spec`` for axis ``kind``; return its canonical value.

    * With ``mapping``, the valid specs are the mapping's keys and the
      resolved value is ``mapping[spec]`` (lookup-style axes: workloads,
      refresh rungs, memtechs).
    * Without, the valid specs come from ``valid`` (or the registered
      choices for ``kind``) and the resolved value is the canonical spec
      string itself (membership-style axes: backend).

    ``normalize`` canonicalizes the input before lookup (e.g.
    ``str.lower``); the raw input is still what the error message quotes.
    """
    key = normalize(str(spec))
    if mapping is not None:
        try:
            return mapping[key]
        except KeyError:
            raise spec_error(kind, spec, mapping, extra=extra) from None
    valid_t = tuple(valid) if valid is not None else choices(kind)
    if key in valid_t:
        return key
    raise spec_error(kind, spec, valid_t, extra=extra)
