"""The traced run's readings: the device's kernels and copies from
`torch.profiler`, attributed to the modules that launched them through
`record_function` ranges that forward hooks open and close, and the
reduction of both to what the per-layer readers and the result's
`breakdown` need."""

from __future__ import annotations

import bisect
import contextlib

import numpy as np
import torch

PREFIX = "mvs_bench."


def _get(ev, attr):
    v = getattr(ev, attr)
    return v() if callable(v) else v


class ModuleRanges:
    """A `record_function` range `mvs_bench.<name>` around each call of the
    named modules (forward pre- and post-hooks), and with `stage` = (first,
    second, name) a range `mvs_bench.<name>` from the end of each call of
    `first` to the start of the next call of `second`: the profiler's
    device operations are attributed to a range by the runtime call that
    launched them (`read_profile`), so a range's device time is the work
    its module queued, not the interval between its ends."""

    def __init__(self, modules: dict, stage: tuple | None = None):
        self._open = {}
        self._hooks = []
        first, second, between = stage or (None, None, None)
        for name, m in modules.items():
            def pre(mod, args, name=name):
                if name == second and between in self._open:
                    self._exit(between)
                self._enter(name)

            def post(mod, args, out, name=name):
                self._exit(name)
                if name == first and between is not None:
                    self._enter(between)
            self._hooks += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]

    def _enter(self, name):
        rf = torch.profiler.record_function(PREFIX + name)
        rf.__enter__()
        self._open[name] = rf

    def _exit(self, name):
        self._open.pop(name).__exit__(None, None, None)

    def close(self):
        for name in reversed(list(self._open)):
            self._exit(name)
        for h in self._hooks:
            h.remove()


def start_profiler(device):
    """A started `torch.profiler` of host and device, after the device is
    idle: its start-up (seconds, the first time in a process) stays
    outside the traced window."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return prof


def span(name: str, on: bool):
    """A `record_function` range in traced runs, nothing otherwise."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _attribute(dev, host):
    """Device seconds and calls of each `mvs_bench.*` range: a device
    operation belongs to the range in which the runtime call that launched
    it (the CUDA runtime or driver call of the same correlation:
    cudaLaunchKernel, cudaGraphLaunch, cudaMemcpyAsync, ...) started. The
    ranges are the main thread's; the only work another thread launches is
    the writer's device-to-host fetch, which is left out."""
    rs = sorted((t0, t1, name[len(PREFIX):]) for t0, t1, name, _ in host
                if name.startswith(PREFIX))
    starts = [r[0] for r in rs]
    calls = {}
    for _, _, name in rs:
        calls[name] = calls.get(name, 0) + 1
    launch = {corr: t0 for t0, _, name, corr in host if name.startswith("cu")}
    seconds = dict.fromkeys(calls, 0.0)
    launched_ns = 0
    for t0, t1, name, corr in dev:
        at = launch.get(corr)
        if at is None or name.startswith("Memcpy DtoH"):
            continue
        launched_ns += t1 - t0
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and rs[i][1] >= at:
            seconds[rs[i][2]] += (t1 - t0) / 1e9
    return {"range_s": seconds, "range_calls": calls, "launched_s": launched_ns / 1e9}


def read_profile(prof, gaps_named: int = 200) -> dict:
    """From the profiler's raw events: the device's busy seconds (the union
    of kernel, copy and set intervals), the number of kernels, the ten
    device operations that took most time, the idle gaps between device
    work by the innermost host range or op running at each gap's middle
    (the `gaps_named` longest gaps named; the rest summed as "(shorter
    gaps)"), and the device seconds and calls of each `mvs_bench.*` range
    (`_attribute`)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        t0 = _get(ev, "start_ns")
        t1 = t0 + _get(ev, "duration_ns")
        name = _get(ev, "name")
        if _get(ev, "device_type") == DeviceType.CUDA:
            if not _get(ev, "is_user_annotation"):
                dev.append((t0, t1, name, _get(ev, "correlation_id")))
        else:
            host.append((t0, t1, name, _get(ev, "correlation_id")))
    if not dev:
        return {"busy_s": 0.0, "kernels": 0, "device_ops": [], "idle_gaps": [],
                "range_s": {}, "range_calls": {}, "launched_s": 0.0}
    dev.sort()
    starts = np.array([d[0] for d in dev], dtype=np.int64)
    ends = np.array([d[1] for d in dev], dtype=np.int64)
    # union of the intervals
    run_end = np.maximum.accumulate(ends)
    new = np.ones(len(dev), dtype=bool)
    new[1:] = starts[1:] > run_end[:-1]
    seg_start = starts[new]
    seg_end = np.append(run_end[np.flatnonzero(new)[1:] - 1], run_end[-1])
    busy_ns = int((seg_end - seg_start).sum())
    by_name = {}
    for t0, t1, name, _ in dev:
        by_name[name] = by_name.get(name, 0) + (t1 - t0)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    kernels = sum(1 for _, _, n, _ in dev if not n.startswith(("Memcpy", "Memset")))

    gap_start, gap_end = seg_end[:-1], seg_start[1:]
    gap_len = gap_end - gap_start
    order = np.argsort(-gap_len)
    named = order[:gaps_named]
    h_start = np.array([h[0] for h in host], dtype=np.int64)
    h_end = np.array([h[1] for h in host], dtype=np.int64)
    idle = {}
    for g in named:
        mid = (gap_start[g] + gap_end[g]) // 2
        inside = np.flatnonzero((h_start <= mid) & (h_end >= mid))
        name = "(no host range)" if not len(inside) else \
            host[inside[np.argmin(h_end[inside] - h_start[inside])]][2]
        idle[name] = idle.get(name, 0) + int(gap_len[g])
    rest = int(gap_len[order[gaps_named:]].sum())
    if rest:
        idle["(shorter gaps)"] = rest
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_ns / 1e9, "kernels": kernels,
            "device_ops": [[n[:160], t / 1e9] for n, t in ops],
            "idle_gaps": [[n[:160], t / 1e9] for n, t in gaps],
            **_attribute(dev, host)}
