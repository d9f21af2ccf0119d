"""Fault tolerance: straggler detection + supervised restart policy.

A framework-free copy of ``repro.fault.watchdog`` (the port never imports
the JAX package).

``StepWatchdog`` tracks per-unit wall time with an EWMA; a unit slower than
``threshold x`` the EWMA is flagged as a straggler event (on real clusters:
trigger checkpoint-and-rebalance / hot-spare swap; here: recorded + surfaced).
The "unit" is whatever the caller feeds it — originally train steps, now also
the sweep runner's simulation buckets
(:func:`repro_torch.experiments.resilience.execute_buckets` surfaces straggler
events in every ``repro.sweep/v1`` artifact's stats). It also watches
data-pipeline heartbeats to detect a wedged input thread.

``SupervisedRun`` wraps the train loop in a bounded-restart supervision policy:
on an exception the loop resumes from the latest checkpoint (the data pipeline
is step-keyed, so the replay is exact — DESIGN.md Sec. 7).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    ewma: float


class StepWatchdog:
    def __init__(self, *, threshold: float = 2.5, ewma_alpha: float = 0.1,
                 heartbeat_timeout: float = 60.0):
        self.threshold = threshold
        self.alpha = ewma_alpha
        self.heartbeat_timeout = heartbeat_timeout
        self.ewma: float | None = None
        self.events: list[StragglerEvent] = []
        self._last_beat = time.monotonic()
        self._last_beat_count = -1

    def observe_step(self, step: int, step_time: float) -> bool:
        """Record one step; returns True if this step is a straggler."""
        straggler = False
        if self.ewma is not None and step_time > self.threshold * self.ewma:
            self.events.append(StragglerEvent(step, step_time, self.ewma))
            straggler = True
        self.ewma = (step_time if self.ewma is None
                     else (1 - self.alpha) * self.ewma + self.alpha * step_time)
        return straggler

    def summary(self) -> dict:
        """Artifact-friendly digest (embedded in sweep stats by the runner)."""
        return {
            "ewma_s": None if self.ewma is None else round(self.ewma, 6),
            "n_stragglers": len(self.events),
            "threshold": self.threshold,
        }

    def observe_heartbeat(self, count: int) -> bool:
        """Feed the data-pipeline heartbeat counter; True if wedged."""
        now = time.monotonic()
        if count != self._last_beat_count:
            self._last_beat_count = count
            self._last_beat = now
            return False
        return (now - self._last_beat) > self.heartbeat_timeout


class SupervisedRun:
    """Bounded-restart supervision around a resumable body.

    body(start_step) -> final_step; raises on failure. resume() -> start step
    (e.g. CheckpointManager.latest_step).
    """

    def __init__(self, body: Callable[[int], int], resume: Callable[[], int | None],
                 *, max_restarts: int = 3):
        self.body = body
        self.resume = resume
        self.max_restarts = max_restarts
        self.restarts = 0
        self.failures: list[str] = []

    def run(self) -> int:
        while True:
            start = self.resume() or 0
            try:
                return self.body(start)
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001
                self.failures.append(f"step>={start}: {type(e).__name__}: {e}")
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts; failures: "
                        f"{self.failures}") from e
