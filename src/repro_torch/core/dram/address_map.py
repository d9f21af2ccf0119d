"""Physical-address -> (bank, subarray, row) mapping functions (the frontend).

The paper's mechanisms only pay off when requests to the *same bank* land in
*different subarrays* — and that is decided entirely by the controller's
address-mapping function, before a single timing rule runs. This module makes
the mapping a first-class, sweepable axis: every mapping translates a stream
of physical addresses into ``(bank, subarray, row)`` tuples, so the same
workload (synthetic or ingested from a controller trace file) can be replayed
under any layout. Related work treats layout exactly this way — PALP's
partition-aware mapping (arXiv 1908.07966) and DSARP's subarray-granularity
refresh (arXiv 1601.06352) both hinge on which address bits pick the subarray.

Canonical physical layout (what the synthetic generator emits and every
mapping decodes)::

    addr = ((row * n_banks + bank) * COLS_PER_ROW + col) << LINE_BITS

i.e. cache lines interleave over columns, rows interleave over banks (the
usual open-page controller layout), and the synthetic generator always emits
``col = 0`` (the simulator models row granularity). ``decode`` drops the
column/offset bits, so file traces with live column bits land on the same
rows the paper's controller would see.

Mappings are addressed by *spec string* (so ``SimConfig`` stays hashable and
grids sweep them via ``config_axes={"mapping": (...)}``):

================= ==========================================================
``"golden"``      Pinned default. Row/bank from the canonical slices;
                  subarray = golden-ratio hash of the row — bit-identical to
                  the historical hard-coded frontend.
``"contiguous"``  Naive contiguous: each subarray owns a contiguous slab of
                  ``rows_per_bank / n_subarrays`` rows. A workload whose
                  resident set fits in one slab never exercises a second
                  subarray — the subarray-oblivious layout under which
                  SALP/MASA gains collapse.
``"xor"``         XOR bank/subarray hashing (permutation-based interleaving,
                  Zhang et al.): subarray = fold-XOR of low/high row bits and
                  the bank; spreads even slab-sized footprints.
``"bits:A-B-C"``  Bit-sliced interleaving: ``A-B-C`` is the MSB->LSB order of
                  the ``row`` / ``bank`` / ``sa`` fields inside the line
                  address (e.g. ``bits:row-sa-bank`` puts the subarray bits
                  between row and bank). Any permutation of the three names.
================= ==========================================================

Port note: a framework-free copy of ``repro.core.dram.address_map``, with
import paths rewritten to ``repro_torch`` (the port never imports
the JAX package); tests/test_torch_frontend.py holds it equal to
the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dram import registry

#: Golden-ratio multiplier of the pinned default mapping (Knuth's 2^32 / phi).
GOLDEN_MULT = 2654435761

#: Canonical layout constants: 64 B lines, 128 lines per row => 8 KiB rows.
LINE_BITS = 6
COL_BITS = 7
COLS_PER_ROW = 1 << COL_BITS


def _check_pow2(name: str, v: int) -> int:
    b = int(v).bit_length() - 1
    if v <= 0 or (1 << b) != v:
        raise ValueError(f"{name} must be a power of two for bit-sliced "
                         f"mappings; got {v}")
    return b


@dataclasses.dataclass(frozen=True)
class AddressMapping:
    """Base class: geometry + the canonical encode; subclasses decode.

    ``decode(addr)`` is vectorized over uint64 numpy arrays and must return
    ``(bank, subarray, row)`` int64 arrays with ``bank < n_banks``,
    ``subarray < n_subarrays``, ``row < rows_per_bank``.
    """
    n_banks: int
    n_subarrays: int
    rows_per_bank: int

    @property
    def spec(self) -> str:
        raise NotImplementedError

    # -- canonical physical layout (mapping-independent) ---------------------
    def encode(self, bank: np.ndarray, row: np.ndarray,
               col: np.ndarray | int = 0) -> np.ndarray:
        """(bank, row[, col]) -> canonical physical byte address (uint64)."""
        line = (np.asarray(row, np.uint64) * np.uint64(self.n_banks)
                + np.asarray(bank, np.uint64))
        return ((line * np.uint64(COLS_PER_ROW)
                 + np.asarray(col, np.uint64)) << np.uint64(LINE_BITS))

    def _line_fields(self, addr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Drop column/offset bits; peel the canonical (bank, row) slices."""
        line = np.asarray(addr, np.uint64) >> np.uint64(LINE_BITS + COL_BITS)
        bank = (line % np.uint64(self.n_banks)).astype(np.int64)
        row = ((line // np.uint64(self.n_banks))
               % np.uint64(self.rows_per_bank)).astype(np.int64)
        return bank, row

    def decode(self, addr: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        raise NotImplementedError


def golden_subarray(row: np.ndarray, n_subarrays: int) -> np.ndarray:
    """The pinned golden-ratio row->subarray hash (uniform, stride-agnostic)."""
    return ((np.asarray(row).astype(np.uint64) * GOLDEN_MULT)
            >> np.uint64(11)).astype(np.int64) % n_subarrays


@dataclasses.dataclass(frozen=True)
class GoldenRatioMapping(AddressMapping):
    """Default: canonical row/bank slices, subarray = golden-ratio row hash."""

    @property
    def spec(self) -> str:
        return "golden"

    def decode(self, addr):
        bank, row = self._line_fields(addr)
        return bank, golden_subarray(row, self.n_subarrays), row


@dataclasses.dataclass(frozen=True)
class ContiguousMapping(AddressMapping):
    """Each subarray owns a contiguous ``rows_per_bank / n_subarrays`` slab."""

    @property
    def spec(self) -> str:
        return "contiguous"

    def decode(self, addr):
        bank, row = self._line_fields(addr)
        slab = max(self.rows_per_bank // self.n_subarrays, 1)
        return bank, np.minimum(row // slab, self.n_subarrays - 1), row


@dataclasses.dataclass(frozen=True)
class XorMapping(AddressMapping):
    """Fold-XOR of low/high row bits and the bank index into the subarray."""

    @property
    def spec(self) -> str:
        return "xor"

    def decode(self, addr):
        bank, row = self._line_fields(addr)
        ns = self.n_subarrays
        sa = (row ^ (row // ns) ^ (row // (ns * ns)) ^ bank) % ns
        return bank, sa, row


_FIELDS = ("row", "bank", "sa")


@dataclasses.dataclass(frozen=True)
class BitSlicedMapping(AddressMapping):
    """Generic bit-sliced interleaving over the line address.

    ``order`` names the MSB->LSB arrangement of the row / bank / subarray
    fields inside the line number (column and offset bits always sit below).
    Requires power-of-two geometry. ``"bits:row-bank-sa"`` with the canonical
    encode reads the subarray straight out of the low line bits — which the
    canonical layout fills with *bank* bits, so consecutive rows alias into a
    fixed subarray pattern: the classic way a real controller's slicing and
    the DIMM's internal slicing disagree.
    """
    order: tuple[str, str, str] = ("row", "bank", "sa")

    def __post_init__(self):
        if sorted(self.order) != sorted(_FIELDS):
            raise ValueError(f"bit-sliced order must be a permutation of "
                             f"{_FIELDS}; got {self.order}")
        _check_pow2("n_banks", self.n_banks)
        _check_pow2("n_subarrays", self.n_subarrays)
        _check_pow2("rows_per_bank", self.rows_per_bank)

    @property
    def spec(self) -> str:
        return "bits:" + "-".join(self.order)

    def decode(self, addr):
        line = np.asarray(addr, np.uint64) >> np.uint64(LINE_BITS + COL_BITS)
        widths = {"row": _check_pow2("rows_per_bank", self.rows_per_bank),
                  "bank": _check_pow2("n_banks", self.n_banks),
                  "sa": _check_pow2("n_subarrays", self.n_subarrays)}
        out = {}
        for name in reversed(self.order):          # peel LSB-first
            w = np.uint64(widths[name])
            out[name] = (line & ((np.uint64(1) << w) - np.uint64(1))).astype(np.int64)
            line = line >> w
        return out["bank"], out["sa"], out["row"]


#: Spec -> constructor for the named (parameter-free) mappings.
NAMED_MAPPINGS = {
    "golden": GoldenRatioMapping,
    "contiguous": ContiguousMapping,
    "xor": XorMapping,
}

#: The pinned default spec (the historical hard-coded frontend).
DEFAULT_MAPPING = "golden"

registry.register("address mapping", tuple(sorted(NAMED_MAPPINGS)))


def mapping_for(spec: str | AddressMapping, n_banks: int, n_subarrays: int,
                rows_per_bank: int) -> AddressMapping:
    """Resolve a mapping spec string for a geometry.

    Accepts an :class:`AddressMapping` instance (validated against the
    geometry), a named spec (``"golden"``, ``"contiguous"``, ``"xor"``), or a
    bit-slice spec (``"bits:row-sa-bank"``). Raises ``ValueError`` naming the
    valid specs on a typo.
    """
    if isinstance(spec, AddressMapping):
        if (spec.n_banks, spec.n_subarrays, spec.rows_per_bank) != (
                n_banks, n_subarrays, rows_per_bank):
            raise ValueError(
                f"mapping {spec.spec!r} was built for geometry "
                f"({spec.n_banks}, {spec.n_subarrays}, {spec.rows_per_bank}), "
                f"not ({n_banks}, {n_subarrays}, {rows_per_bank})")
        return spec
    if spec in NAMED_MAPPINGS:
        return NAMED_MAPPINGS[spec](n_banks, n_subarrays, rows_per_bank)
    if isinstance(spec, str) and spec.startswith("bits:"):
        order = tuple(spec[len("bits:"):].split("-"))
        return BitSlicedMapping(n_banks, n_subarrays, rows_per_bank,
                                order=order)  # type: ignore[arg-type]
    raise registry.spec_error(
        "address mapping", spec, sorted(NAMED_MAPPINGS),
        extra=f" or 'bits:<msb-to-lsb order>' (a permutation of {_FIELDS}, "
              f"e.g. 'bits:row-sa-bank')")
