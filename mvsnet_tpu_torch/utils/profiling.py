"""Profiling and tracing utilities (counterpart of
mvsnet_tpu/utils/profiling.py).

The reference had only wall-clock prints (SURVEY §5; train.py:480-487).
Here: a context manager around `torch.profiler` that writes a Chrome /
TensorBoard trace (host ops, and the card's kernels and copies where CUDA
is available) into a directory, a step timer, and the current card's
memory counters.

Usage:
  with trace("/tmp/trace") as prof:      # view with tensorboard --logdir,
      predictor.predict(...)             # or chrome://tracing
  prof.key_averages()                    # the same events, summed by name
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write `<host>_<pid>.<ms>.pt.trace.json` into
    `log_dir` (torch.profiler's TensorBoard handler) when it ends; the
    card's activity is recorded where CUDA is available."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


class StepTimer:
    """Rolling step-duration stats (time_per_step parity: train.py:487,511)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._durations = []
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._durations.append(dt)
        if len(self._durations) > self.window:
            self._durations.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return sum(self._durations) / max(len(self._durations), 1)


def device_memory_stats() -> Optional[dict]:
    """The current card's allocator counters (`torch.cuda.memory_stats`),
    as ints; None without CUDA."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(torch.cuda.current_device())
    return {k: int(v) for k, v in stats.items()}
