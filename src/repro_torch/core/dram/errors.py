"""Shared error-message helpers for the registry-style lookups.

Every spec-string registry in the package (workload names, address-mapping
specs, refresh policies) raises on a typo with the same "did you mean"
near-miss hint; this is the one implementation of that hint.

Port note: a framework-free copy of ``repro.core.dram.errors``, with
import paths rewritten to ``repro_torch`` (the port never imports
the JAX package); tests/test_torch_frontend.py holds it equal to
the reference.
"""
from __future__ import annotations

import difflib
from typing import Iterable


def did_you_mean(value: str, valid: Iterable[str]) -> str:
    """``" (did you mean 'x'?)"`` for the closest valid name, or ``""``."""
    close = difflib.get_close_matches(str(value), list(valid), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""
