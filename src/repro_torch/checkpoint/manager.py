"""Checkpoint manager: async saves off the critical path, keep-K retention,
resume-from-latest.

The counterpart of ``repro.checkpoint.manager``. ``save`` gathers the
tree's DTensor leaves (every rank takes part) and copies it to host
memory before it returns (the trainer updates its parameters in
place, so the writer thread must not read them), then writes it in a
thread; ``wait`` joins that thread and raises the error it met, if any.
``latest_step`` and ``restore`` join a save in flight first (not raising
its error, which the next ``wait`` does): a restart right after a save
then resumes from that save, where the reference reads the directory while
its writer may still run. With a process group up only rank 0 writes and
prunes (``store.writes``), and ``latest_step`` / ``restore`` end their
join in a barrier, so every rank reads the directory after rank 0's save
is done; every rank must then call them together.
"""
from __future__ import annotations

import pathlib
import shutil
import threading
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.store import (latest_step, load_checkpoint,
                                          save_checkpoint, writes)
from repro_torch.tree import tree_map


def _host_copy(x):
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return x


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True,
                 host_index: int = 0):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self.async_save = async_save
        self.host_index = host_index
        self._thread: threading.Thread | None = None
        self._last_error: Exception | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, *, pspecs: Any = None,
             extra_meta: dict | None = None, block: bool = False) -> None:
        # snapshot to host memory synchronously, write async
        host_tree = tree_map(_host_copy, tree)

        def _write():
            try:
                save_checkpoint(self.directory, step, host_tree,
                                pspecs=pspecs, host_index=self.host_index,
                                extra_meta=extra_meta)
                if writes():
                    self._gc()
            except Exception as e:  # noqa: BLE001 — surfaced on next wait()
                self._last_error = e

        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _settle(self) -> None:
        """Join this rank's writer, then (under a process group) wait for
        every rank's: rank 0's save is then on disk for all."""
        self._join()
        if dist.is_initialized():
            dist.barrier()

    def wait(self) -> None:
        self._join()
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.directory.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:06d}", ignore_errors=True)

    # ------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        self._settle()
        return latest_step(self.directory)

    def restore(self, template: Any, step: int | None = None):
        self._settle()
        return load_checkpoint(self.directory, step, template=template)
