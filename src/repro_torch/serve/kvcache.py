"""Paged KV cache with a SALP-aware physical layout.

Pages are the serving layer's DRAM "rows". Each page id maps to a
(bank, subarray) class by the same golden-ratio hash the DRAM simulator uses
for rows — on real hardware this models which HBM channel/bank group a page's
backing memory hits. The allocator spreads consecutive pages of one sequence
across banks (row-interleaving) and the scheduler (scheduler.py) uses the
class map to order page accesses so same-bank conflicts land in different
subarrays (SALP-overlappable) rather than the same subarray (serialized).

Prefix sharing: allocate() can adopt another sequence's page list prefix
(copy-on-write at page granularity) — shared pages are MASA's multiple
activated row buffers: both sequences hit the same resident page.

Port note: a framework-free copy of ``repro.serve.kvcache``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_serve.py holds it equal to the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_HASH_MULT = 2654435761


def page_class(page_id: int | np.ndarray, n_banks: int = 8, n_subarrays: int = 8):
    h = (np.uint64(page_id) * np.uint64(_HASH_MULT)) >> np.uint64(11)
    bank = np.int64(h) % n_banks
    sub = (np.int64(h) // n_banks) % n_subarrays
    return bank, sub


@dataclasses.dataclass
class PageAllocator:
    n_pages: int
    n_banks: int = 8
    n_subarrays: int = 8

    def __post_init__(self):
        self._free: list[int] = list(range(self.n_pages - 1, -1, -1))
        self._refcount = np.zeros(self.n_pages, np.int32)
        # per-bank free lists let allocation rotate across banks
        self._bank_of = np.array([page_class(p, self.n_banks)[0]
                                  for p in range(self.n_pages)])
        self._next_bank = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int, interleave: bool = True) -> list[int]:
        if n > len(self._free):
            raise MemoryError(f"KV cache OOM: want {n}, have {len(self._free)}")
        if not interleave:
            out = [self._free.pop() for _ in range(n)]
        else:
            # round-robin banks (the DRAM row-interleaved mapping): consecutive
            # pages of a sequence land in different banks => no self-conflicts
            out = []
            for _ in range(n):
                pick = None
                for off in range(self.n_banks):
                    want = (self._next_bank + off) % self.n_banks
                    for idx in range(len(self._free) - 1, -1, -1):
                        if self._bank_of[self._free[idx]] == want:
                            pick = self._free.pop(idx)
                            break
                    if pick is not None:
                        break
                if pick is None:
                    pick = self._free.pop()
                self._next_bank = (self._bank_of[pick] + 1) % self.n_banks
                out.append(pick)
        for p in out:
            self._refcount[p] += 1
        return out

    def share(self, pages: list[int]) -> list[int]:
        """Adopt existing pages (prefix sharing); bump refcounts."""
        for p in pages:
            self._refcount[p] += 1
        return list(pages)

    def free(self, pages: list[int]) -> None:
        for p in pages:
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                self._free.append(p)
            assert self._refcount[p] >= 0


@dataclasses.dataclass
class PagedKVCache:
    """Device-side paged KV storage + host-side page tables.

    Storage layout matches kernels/paged_attention:
      k_pages/v_pages [n_pages, page_size, kv_heads, head_dim] per layer stack
      (stacked [R, ...] like the rest of the model).
    """
    n_pages: int
    page_size: int
    allocator: PageAllocator = None

    def __post_init__(self):
        if self.allocator is None:
            self.allocator = PageAllocator(self.n_pages)
        self.tables: dict[int, list[int]] = {}   # seq id -> page list
        self.lengths: dict[int, int] = {}

    def add_sequence(self, seq_id: int, n_tokens: int,
                     shared_prefix_of: int | None = None) -> list[int]:
        pages_needed = -(-n_tokens // self.page_size)
        pages: list[int] = []
        if shared_prefix_of is not None and shared_prefix_of in self.tables:
            donor = self.tables[shared_prefix_of]
            shared = min(len(donor), n_tokens // self.page_size)  # full pages only
            pages = self.allocator.share(donor[:shared])
        pages += self.allocator.alloc(pages_needed - len(pages))
        self.tables[seq_id] = pages
        self.lengths[seq_id] = n_tokens
        return pages

    def extend(self, seq_id: int, n_new: int = 1) -> None:
        self.lengths[seq_id] += n_new
        need = -(-self.lengths[seq_id] // self.page_size)
        if need > len(self.tables[seq_id]):
            self.tables[seq_id] += self.allocator.alloc(need - len(self.tables[seq_id]))

    def drop_sequence(self, seq_id: int) -> None:
        self.allocator.free(self.tables.pop(seq_id))
        del self.lengths[seq_id]

    def block_table(self, seq_ids: list[int], max_pages: int) -> np.ndarray:
        bt = np.zeros((len(seq_ids), max_pages), np.int32)
        for i, sid in enumerate(seq_ids):
            pages = self.tables[sid][:max_pages]
            bt[i, :len(pages)] = pages
        return bt

    def seq_lens(self, seq_ids: list[int]) -> np.ndarray:
        return np.array([self.lengths[s] for s in seq_ids], np.int32)
