"""SALP-aware continuous-batching scheduler (the paper's Sec. 5 research
direction — "SALP-aware memory scheduling algorithms" — realized at the
serving layer).

Each decode step touches one KV page per active request. The page-access
*order* matters the way command order matters in DRAM: an access whose bank
was touched within the last ``window`` accesses must wait for that bank's
in-flight ACT/PRE (serialized); an access to an idle bank overlaps and only
pays its column slot. The policy ladder changes both the serialization cost
(SALP-1/2 overlap PRE/write-recovery) and the number of rows that can stay
open (MASA keeps every subarray's row buffer active -> revisits become hits).

The scheduler greedily picks the next request with the cheapest access under
this model: it groups same-page hits, spreads same-bank conflicts apart, and
under MASA exploits multi-residency. ``order_cost`` is the shared scoring
function (benchmarks compare scheduled vs FIFO orders per policy).

Port note: a framework-free copy of ``repro.serve.scheduler``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_serve.py holds it equal to the reference.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.core.dram.policies import Policy
from repro_torch.core.salp.cost_model import AccessClass, SalpCostModel
from repro_torch.serve.kvcache import PagedKVCache, page_class


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    shared_prefix_of: int | None = None
    generated: int = 0
    state: str = "waiting"        # waiting -> running -> done


class _BankState:
    """Open-row tracking: one row per bank (subarray-oblivious) or one per
    subarray (MASA)."""

    def __init__(self, masa: bool):
        self.masa = masa
        self.rows: dict = {}      # bank -> {sub: page} (non-MASA: at most 1 sub)

    def classify(self, bank: int, sub: int, page: int) -> AccessClass:
        bank_rows = self.rows.get(bank, {})
        if bank_rows.get(sub) == page:
            return AccessClass.HIT
        if sub in bank_rows:
            return AccessClass.CONFLICT_SAME
        if bank_rows:
            return AccessClass.CONFLICT_OTHER
        return AccessClass.MISS

    def open(self, bank: int, sub: int, page: int) -> None:
        if self.masa:
            self.rows.setdefault(bank, {})[sub] = page
        else:
            self.rows[bank] = {sub: page}


class SalpScheduler:
    """Admission + per-step batch ordering."""

    def __init__(self, cache: PagedKVCache, max_batch: int,
                 policy: Policy = Policy.MASA,
                 n_banks: int = 8, n_subarrays: int = 8, window: int = 4):
        self.cache = cache
        self.max_batch = max_batch
        self.policy = policy
        self.cost = SalpCostModel(policy=policy)
        self.nb, self.ns = n_banks, n_subarrays
        self.window = window
        self.waiting: deque[Request] = deque()
        self.running: dict[int, Request] = {}

    # ------------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def admit(self) -> list[Request]:
        """Admit waiting requests while pages + batch slots remain. Requests
        sharing a resident prefix are admitted first (their pages are already
        "activated" — MASA hits instead of cold ACTIVATEs)."""
        admitted = []
        ordered = sorted(
            self.waiting,
            key=lambda r: 0 if (r.shared_prefix_of in self.cache.tables) else 1)
        for req in ordered:
            if len(self.running) >= self.max_batch:
                break
            pages_needed = -(-req.prompt_len // self.cache.page_size)
            shared = 0
            if req.shared_prefix_of in self.cache.tables:
                shared = min(len(self.cache.tables[req.shared_prefix_of]),
                             req.prompt_len // self.cache.page_size)
            if pages_needed - shared > self.cache.allocator.free_pages:
                continue
            self.cache.add_sequence(req.rid, req.prompt_len,
                                    shared_prefix_of=req.shared_prefix_of)
            req.state = "running"
            self.running[req.rid] = req
            self.waiting.remove(req)
            admitted.append(req)
        return admitted

    # ------------------------------------------------------------- scoring
    def _page_of(self, sid: int) -> tuple[int, int, int]:
        page = self.cache.tables[sid][-1]
        b, s = page_class(page, self.nb, self.ns)
        return int(b), int(s), page

    def _access_cost(self, cls: AccessClass, bank_busy: bool,
                     switches: bool) -> int:
        full = self.cost.cost(cls, switches_subarray=switches)
        if cls == AccessClass.HIT:
            return full                      # hits never re-activate
        if bank_busy:
            return full                      # bank critical path: serialized
        return self.cost.column_cost(False)  # idle bank: ACT overlaps others

    def order_cost(self, order: list[int]) -> int:
        """Page-access critical-path cost of serving ``order``."""
        state = _BankState(self.policy == Policy.MASA)
        recent: deque[int] = deque(maxlen=self.window)
        designated: dict[int, int] = {}
        total = 0
        for sid in order:
            b, s, page = self._page_of(sid)
            cls = state.classify(b, s, page)
            total += self._access_cost(cls, b in recent,
                                       designated.get(b, s) != s)
            state.open(b, s, page)
            designated[b] = s
            recent.append(b)
        return total

    def schedule_step(self) -> list[int]:
        """This step's batch order: greedy cheapest-next under the SALP cost
        model (groups page hits, spreads same-bank conflicts apart)."""
        sids = list(self.running.keys())
        if len(sids) <= 2:
            return sids
        state = _BankState(self.policy == Policy.MASA)
        recent: deque[int] = deque(maxlen=self.window)
        designated: dict[int, int] = {}
        remaining = dict.fromkeys(sids)
        order: list[int] = []
        while remaining:
            best, best_cost = None, None
            for sid in remaining:
                b, s, page = self._page_of(sid)
                cls = state.classify(b, s, page)
                c = self._access_cost(cls, b in recent,
                                      designated.get(b, s) != s)
                if best_cost is None or c < best_cost:
                    best, best_cost = sid, c
            b, s, page = self._page_of(best)
            state.open(b, s, page)
            designated[b] = s
            recent.append(b)
            order.append(best)
            del remaining[best]
        return order

    # ------------------------------------------------------------- lifecycle
    def step_done(self, sids: list[int]) -> list[int]:
        """Advance lengths; retire finished requests. Returns retired ids."""
        retired = []
        for sid in sids:
            req = self.running[sid]
            req.generated += 1
            self.cache.extend(sid, 1)
            if req.generated >= req.max_new_tokens:
                req.state = "done"
                retired.append(sid)
        for sid in retired:
            del self.running[sid]
            self.cache.drop_sequence(sid)
        return retired
