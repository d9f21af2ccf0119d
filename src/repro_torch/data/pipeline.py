"""Deterministic, host-shardable, prefetching data pipeline.

The counterpart of ``repro.data.pipeline``. Batch contents are a pure
function of (seed, step, host shard): resuming from a checkpoint at step k
regenerates exactly the stream the failed run would have seen. The seed of
step k is ``hash((seed, step, host_index)) & 0x7FFFFFFF``, the reference's
expression (CPython hashes a tuple of ints alike in every process), so both
packages draw the same batches. Prefetch fills a small queue of ready
batches from a background thread. ``launch.train --distributed`` sets
``host_index`` / ``n_hosts`` to the rank and the world size.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

from repro_torch.compat import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synth import make_batch


class DataPipeline:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *,
                 seed: int = 0, host_index: int = 0, n_hosts: int = 1,
                 prefetch: int = 2, dtype=None, device=None):
        if batch % n_hosts:
            raise ValueError(f"global batch {batch} does not divide across "
                             f"{n_hosts} hosts")
        self.cfg = cfg
        self.local_batch = batch // n_hosts
        self.seq = seq
        self.seed = seed
        self.host_index = host_index
        self.n_hosts = n_hosts
        self.prefetch = prefetch
        self.dtype = dtype
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._heartbeat = 0  # incremented by the worker; watched by fault.watchdog

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step, host): the restart guarantee."""
        kwargs = {} if self.dtype is None else {"dtype": self.dtype}
        return make_batch(self.cfg, self.local_batch, self.seq,
                          seed=hash((self.seed, step, self.host_index)) & 0x7FFFFFFF,
                          device=self.device, **kwargs)

    # ------------------------------------------------------------ prefetch
    def _worker(self, start_step: int):
        step = start_step
        while not self._stop.is_set():
            b = self.batch_at(step)
            self._heartbeat += 1
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self, start_step: int = 0) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, args=(start_step,),
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        if self._thread is None:
            self.start()
        while True:
            yield self._q.get()

    @property
    def heartbeat(self) -> int:
        return self._heartbeat
