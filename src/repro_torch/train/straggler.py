"""Straggler detection & mitigation for multi-host synchronous training.

Synchronous SPMD training runs at the speed of the slowest worker.  The
monitor keeps a per-worker ring buffer of step durations and flags
workers whose recent median exceeds the fleet median by a factor — the
standard p99/median skew detector.  Mitigation is advisory (the launcher
decides): `exclude` (re-form mesh without the worker — elastic path),
`rebalance` (shrink its shard), or `wait` (transient).

In a real deployment each host reports its own step time through a tiny
all-gather side channel; here the monitor is host-side state fed by the
training loop (and by the synthetic-delay tests).  Port of
`repro.train.straggler`; `StepTimer` synchronizes the CUDA device on
exit, so that it times the step and not its enqueue.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class StragglerReport:
    step: int
    fleet_median_s: float
    worker_median_s: dict[int, float]
    stragglers: dict[int, float]       # worker -> slowdown factor
    action: str                        # "none" | "wait" | "exclude"


@dataclass
class StragglerMonitor:
    num_workers: int
    window: int = 32                   # ring-buffer length per worker
    slow_factor: float = 1.5           # flag if median > fleet * factor
    persist_steps: int = 8             # consecutive flags before "exclude"
    _times: list[deque] = field(default_factory=list, repr=False)
    _flagged: dict[int, int] = field(default_factory=dict, repr=False)
    _step: int = 0

    def __post_init__(self):
        self._times = [deque(maxlen=self.window) for _ in range(self.num_workers)]

    # ------------------------------------------------------------ feeding

    def record(self, worker: int, duration_s: float):
        self._times[worker].append(duration_s)

    def record_step(self, durations: dict[int, float]) -> StragglerReport:
        """One synchronous step: every worker's duration."""
        for w, d in durations.items():
            self.record(w, d)
        self._step += 1
        return self.report()

    # ----------------------------------------------------------- analysis

    @staticmethod
    def _median(xs) -> float:
        s = sorted(xs)
        n = len(s)
        if n == 0:
            return 0.0
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def report(self) -> StragglerReport:
        worker_median = {
            w: self._median(self._times[w]) for w in range(self.num_workers)
            if self._times[w]
        }
        fleet = self._median(list(worker_median.values()))
        stragglers = {}
        for w, m in worker_median.items():
            if fleet > 0 and m > self.slow_factor * fleet:
                stragglers[w] = m / fleet
                self._flagged[w] = self._flagged.get(w, 0) + 1
            else:
                self._flagged.pop(w, None)
        action = "none"
        if stragglers:
            action = "wait"
            if any(self._flagged.get(w, 0) >= self.persist_steps
                   for w in stragglers):
                action = "exclude"     # persistent: hand to the elastic path
        return StragglerReport(
            step=self._step, fleet_median_s=fleet,
            worker_median_s=worker_median, stragglers=stragglers, action=action,
        )

    def excluded_workers(self) -> list[int]:
        return [w for w, n in self._flagged.items() if n >= self.persist_steps]


class StepTimer:
    """Context-manager timing for the local worker's steps.  On a CUDA
    `device` it synchronizes before reading the clock on exit: PyTorch
    returns before the card finishes."""

    def __init__(self, monitor: StragglerMonitor, worker: int = 0,
                 device=None):
        self.monitor = monitor
        self.worker = worker
        self.device = torch.device(device) if device is not None else None
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.monitor.record(self.worker, time.perf_counter() - self._t0)
        return False
