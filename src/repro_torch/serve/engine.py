"""Continuous-batching serving engine (the port of ``repro.serve.engine``).

Couples the SALP scheduler + paged KV cache with a model: admits requests,
prefills then decodes with a fixed-capacity running batch, retires finished
sequences, and reports SALP cost-model statistics (hit/conflict mix of the
scheduled page stream vs a FIFO baseline) — the serving-layer analogue of
the paper's Figure 4. Admission, scheduling, stats and the greedy argmax
are the reference's; where it jits ``decode_step`` the port calls it. The
model holds its parameters, so the engine takes none. Each sequence keeps
a dense per-sequence model cache; the paged cache holds only the host-side
page tables the scheduler orders.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.dram.policies import Policy
from repro_torch.models.builder import Model
from repro_torch.serve.kvcache import PagedKVCache
from repro_torch.serve.scheduler import Request, SalpScheduler


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    tokens: int = 0
    scheduled_cost: int = 0
    fifo_cost: int = 0

    @property
    def cost_reduction(self) -> float:
        if self.fifo_cost == 0:
            return 0.0
        return 1.0 - self.scheduled_cost / self.fifo_cost


def _map_cache(fn, cache):
    return {k: type(v)(*(fn(a) for a in v)) for k, v in cache.items()}


def grow_cache(cache, prompt_len: int, max_len: int):
    """A prefill cache padded to ``max_len`` slots so that decode can
    append, as the reference pads it: only leaves whose axis 2 has the
    prompt's length (the KV caches' sequence axis)."""
    def grow(a):
        if a.dim() >= 4 and a.shape[2] == prompt_len:
            pad = [0, 0] * (a.dim() - 3) + [0, max_len - a.shape[2]]
            return torch.nn.functional.pad(a, pad)
        return a
    return _map_cache(grow, cache)


class ServingEngine:
    def __init__(self, model: Model, *, max_batch: int = 8,
                 n_pages: int = 512, page_size: int = 16,
                 policy: Policy = Policy.MASA, interleave_pages: bool = True):
        self.model = model
        self.cache = PagedKVCache(n_pages=n_pages, page_size=page_size)
        if not interleave_pages:
            # sequential page ids cluster banks (max conflict pressure; the
            # serving analogue of the paper's lockstep-array workloads)
            alloc = self.cache.allocator.alloc
            self.cache.allocator.alloc = lambda n, interleave=True: alloc(n, False)
        self.sched = SalpScheduler(self.cache, max_batch, policy=policy)
        self.stats = EngineStats()
        self._seq_tokens: dict[int, list[int]] = {}
        self._device_cache: dict[int, Any] = {}   # per-seq model cache

    def submit(self, rid: int, prompt: list[int], max_new: int,
               shared_prefix_of: int | None = None) -> None:
        self.sched.submit(Request(rid, len(prompt), max_new,
                                  shared_prefix_of=shared_prefix_of))
        self._seq_tokens[rid] = list(prompt)

    def _tokens(self, toks: list[int]) -> torch.Tensor:
        return torch.tensor(toks, dtype=torch.long,
                            device=self.model.device)[None, :]

    def _prefill(self, req: Request, max_len: int) -> None:
        toks = self._tokens(self._seq_tokens[req.rid])
        batch = {"tokens": toks, "labels": toks}
        logits, cache = self.model.prefill(batch)
        self._device_cache[req.rid] = grow_cache(cache, toks.shape[1],
                                                 max_len)
        nxt = int(torch.argmax(logits[0, -1]))
        self._seq_tokens[req.rid].append(nxt)

    def run(self, max_steps: int = 64, max_len: int = 256) -> EngineStats:
        while (self.sched.waiting or self.sched.running) and self.stats.steps < max_steps:
            for req in self.sched.admit():
                self._prefill(req, max_len)

            if not self.sched.running:
                break
            order = self.sched.schedule_step()
            fifo = sorted(order)
            self.stats.scheduled_cost += self.sched.order_cost(order)
            self.stats.fifo_cost += self.sched.order_cost(fifo)

            # decode one token per running sequence, in scheduled order
            for sid in order:
                toks = self._seq_tokens[sid]
                cur = len(toks)
                logits, cache = self.model.decode_step(
                    self._tokens(toks[-1:]), self._device_cache[sid], cur - 1)
                self._device_cache[sid] = cache
                self._seq_tokens[sid].append(int(torch.argmax(logits[0, -1])))
                self.stats.tokens += 1

            for sid in self.sched.step_done(order):
                del self._device_cache[sid]
            self.stats.steps += 1
        return self.stats

    def output(self, rid: int) -> list[int]:
        return self._seq_tokens[rid]
