"""Profiling and tracing utilities (counterpart of
mvsnet_tpu/utils/profiling.py).

The reference had only wall-clock prints (SURVEY §5; train.py:480-487).
Here, one tracing system built on `torch.profiler`:

- `span(name, **ids)`: a `record_function` range around a stage of the
  program while a profiler records, one shared no-op context otherwise (a
  flag read, against some microseconds for a range). Kineto records the
  ranges on the clock of the card's kernels and copies, so each device
  operation and each idle gap can be put down to the span open on the
  host. The serving path's spans: `mvsnet.predict` (ids: `request`),
  `mvsnet.predict.stage`, `mvsnet.predict.forward`, `mvsnet.features`,
  `mvsnet.cost_volume`, `mvsnet.regularizer`, `mvsnet.gru.capture`,
  `mvsnet.depth_tail`, and on the output writer's thread
  `mvsnet.writer.job` (ids: `job`).
- `count(name, n)` / `counters()`: the program's counters (`SERVING`,
  `LAUNCHES`), read at call time.
- `traced()`: what the spans and counters recorded while a profiler
  recorded: each span's calls and host seconds, each counter's increments.
- `start` / `stop` / `trace(log_dir)`: a profiler of the host and, where
  CUDA is available, the card, written as a Chrome / TensorBoard trace.
- `device_memory_stats()`: the current card's allocator counters.

Usage:
  with trace("/tmp/trace") as prof:      # view with tensorboard --logdir,
      predictor.predict(...)             # or chrome://tracing
  prof.key_averages()                    # the same events, summed by name
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from typing import Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# One context for every span while no profiler records.
NO_SPAN = contextlib.nullcontext()

# The serving path's counters: `Predictor.predict` calls and the float32
# bytes of the inputs they staged for the forward (from host arrays, the
# bytes copied onto the card); on a card, the requests staged through the
# Predictor's ring of page-locked areas, the areas made or grown, and the
# host seconds spent waiting on an area's event before refilling it; the
# output writer's jobs and the seconds each waited from `write` to the
# start of its run.
SERVING = ("predict.requests", "predict.staged_bytes", "predict.pinned_stages",
           "predict.pinned_allocs", "predict.stage_wait_s", "writer.jobs", "writer.wait_s")

# The hand-written kernels' counters, which their wrappers in `ops/kernels/`
# count on a card: each kernel's launches (`launches.<kernel>`) and, for the
# kernels with a tensor-core and a CUDA-core edition, each edition's
# (`editions.<kernel>.<edition>`). A CUDA graph's replays count the launches
# its capture holds (`ops.kernels.CountedGraph`).
LAUNCHES = tuple(f"launches.{k}" for k in (
    "cost_volume", "cost_volume_sharded", "cost_volume_pixel", "conv", "deconv", "group_norm",
    "gru_step", "warp", "warp_transpose", "warp_sharded", "warp_transpose_sharded",
    "wgrad")) + tuple(
    f"editions.{k}.{e}" for k in ("conv", "deconv", "wgrad") for e in ("tc", "simt"))

_lock = threading.Lock()
_counts = dict.fromkeys(SERVING + LAUNCHES, 0)
_traced_counts = dict.fromkeys(SERVING + LAUNCHES, 0)
_traced_spans = {}           # name -> [calls, host ns]


def _recording() -> bool:
    # torch's own process-wide flag: `torch.autograd._profiler_enabled()`
    # reads the calling thread's state, which the writer's thread and a
    # profiler of all threads leave unset
    return _autograd_profiler._is_profiler_enabled


class _Span:
    """A `record_function` range whose ids are its recorded inputs (a
    profiler with `record_shapes=True` keeps them as the range's concrete
    inputs, in the order given), tallied on the host clock when it ends."""

    __slots__ = ("name", "ids", "_handle", "_t0")

    def __init__(self, name: str, ids: tuple):
        self.name = name
        self.ids = ids

    def __enter__(self):
        self._handle = torch.autograd._record_function_with_args_enter(self.name, *self.ids)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        took = time.perf_counter_ns() - self._t0
        torch.autograd._record_function_with_args_exit(self._handle)
        with _lock:
            tally = _traced_spans.setdefault(self.name, [0, 0])
            tally[0] += 1
            tally[1] += took
        return False


def span(name: str, **ids: int):
    """A range `name` around the `with` block while a profiler records,
    on whichever thread runs it; `NO_SPAN` otherwise. `ids` are ints,
    such as the request's number."""
    if not _recording():
        return NO_SPAN
    return _Span(name, tuple(ids.values()))


def count(name: str, n=1) -> None:
    """Add `n` to the program's counter `name`, and to its traced tally
    while a profiler records (`traced()`)."""
    on = _recording()
    with _lock:
        _counts[name] = _counts.get(name, 0) + n
        if on:
            _traced_counts[name] = _traced_counts.get(name, 0) + n


def counters() -> dict:
    """Every counter of the program, read now, in one flat dict: the
    serving path's (`SERVING`) and the kernels' (`LAUNCHES`), each from 0
    when the process started."""
    with _lock:
        return dict(_counts)


def traced() -> dict:
    """What the program recorded while a profiler recorded, since the
    process started: under `spans`, each span name's `calls` and `host_s`
    (the seconds its spans were open, on the host clock); under `counters`,
    what each counter of `count` counted meanwhile."""
    with _lock:
        return {"spans": {name: {"calls": c, "host_s": ns / 1e9}
                          for name, (c, ns) in _traced_spans.items()},
                "counters": dict(_traced_counts)}


def start(device=None) -> torch.profiler.profile:
    """A started profiler of the host and, on a card (`device`, or where
    CUDA is available when None), of its kernels and copies."""
    from torch.profiler import ProfilerActivity, profile

    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop(prof: torch.profiler.profile, log_dir: str, file_name: str) -> str:
    """Stop `prof` and write its Chrome / TensorBoard trace to
    `<log_dir>/<file_name>`; returns that path."""
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, file_name)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write `<host>_<pid>.<ns>.pt.trace.json` (the
    naming TensorBoard's profiler plugin reads) into `log_dir` when it
    ends; the card's activity is recorded where CUDA is available."""
    prof = start()
    try:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        stop(prof, log_dir,
             f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")


def device_memory_stats() -> Optional[dict]:
    """The current card's allocator counters (`torch.cuda.memory_stats`),
    as ints; None without CUDA."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(torch.cuda.current_device())
    return {k: int(v) for k, v in stats.items()}
