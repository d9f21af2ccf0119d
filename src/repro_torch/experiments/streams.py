"""The sweep layer's CUDA streams: where a sweep call issues its launches,
and how it collects them.

A sweep call issues each kernel launch on the next stream of a pool made
once for each card (:class:`Issuer`) and records an event behind it. It
collects the launch later by waiting on that event alone, then copies the
launch's results to the host (:func:`to_host`), so the chains of
independent buckets run side by side on the card while the host prepares
the next one. Nothing here waits for the whole device.

The copies wait for the collect: a copy to the host queued at issue, behind
a chain, held up other streams' copies (an H100 stalled 2 of a scheduler
sweep's 14 launches 20-40 ms each in their range checks' reads).

On the CPU a launch has run by the time it is issued: the same calls keep
today's order there.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Iterator

import numpy as np
import torch

from repro_torch import obs

#: Streams in a card's pool, and so the buckets a sweep keeps in flight
#: there: no more than the card's default count of hardware queues
#: (``CUDA_DEVICE_MAX_CONNECTIONS``).
WINDOW = 8


def window(device: torch.device) -> int:
    """Buckets a sweep keeps in flight on ``device``: :data:`WINDOW` on a
    card, 1 on the CPU."""
    return WINDOW if device.type == "cuda" else 1


@functools.cache
def _pool(device: torch.device) -> tuple[torch.cuda.Stream, ...]:
    return tuple(torch.cuda.Stream(device=device) for _ in range(WINDOW))


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t``, made by a launch already collected, copied to the host on the
    caller's stream."""
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t.cpu().numpy()


class Launch:
    """One kernel launch of a sweep call, and the event behind it."""

    def __init__(self, issuer: "Issuer"):
        self._issuer = issuer
        self._event: torch.cuda.Event | None = None
        self._open = True

    def wait(self) -> None:
        """Wait for this launch alone (once): after it, the tensors its
        block made hold their values."""
        if not self._open:
            return
        with obs.span("sweep.wait"):
            if self._event is not None:
                self._event.synchronize()
        self._open = False
        self._issuer._open -= 1


class Issuer:
    """The launches of one sweep call, each on the next stream of its
    card's pool in turn.

    While tracing, a launch issued while an earlier launch of the same
    issuer is not yet collected counts one ``sweep.overlapped_launches``.
    """

    def __init__(self) -> None:
        self._turn = 0
        self._open = 0

    @contextlib.contextmanager
    def launch(self, device: torch.device) -> Iterator[Launch]:
        """A block that issues one launch: on a card, the next stream of the
        pool is current inside it, and an event is recorded on it at its
        end. Tensors the block makes belong to that stream."""
        if self._open:
            obs.count("sweep.overlapped_launches")
        launch = Launch(self)
        self._open += 1
        try:
            if device.type != "cuda":
                yield launch
                return
            stream = _pool(device)[self._turn % WINDOW]
            self._turn += 1
            with torch.cuda.stream(stream):
                yield launch
                launch._event = torch.cuda.Event()
                launch._event.record(stream)
        except BaseException:
            launch._open = False
            self._open -= 1
            raise
