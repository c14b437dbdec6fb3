"""The program's own spans and counters (`mvsnet_tpu_torch.utils.profiling`),
as the per-layer readers and a traced run's diagnosis read them.

- `traced()`: what the program recorded while the traced window's
  profiler recorded (each span's calls and host seconds, each counter's
  increments), or None where the program has no such read-out.
- `program_spans(dev, host, seg_start, seg_end)`: the program's `mvsnet.*`
  spans reduced from a profiler's raw events: per span name its calls,
  host seconds, the device seconds of what it launched and the device's
  idle seconds while it was open.
- `python3 -m mvs_bench.spans --workload <cell> --seed <n> --seconds <s>`:
  one traced run of the cell, as `python3 -m mvs_bench.run ... --trace 1`
  makes it, with a `diag spans` line on standard error that reduces the
  program's spans from the same events (the harness's `diag` line beside
  it gives the device seconds of its own `mvs_bench.*` ranges).
"""

from __future__ import annotations

import json
import sys

import numpy as np

PROGRAM = "mvsnet."        # the program's spans


def traced():
    """`mvsnet_tpu_torch.utils.profiling.traced()`, or None where the
    program has none."""
    from mvsnet_tpu_torch.utils import profiling

    read = getattr(profiling, "traced", None)
    return read() if read is not None else None


def traced_span(name: str):
    """The traced calls and host seconds of the program's span `name`, or
    None where it was not recorded."""
    got = traced()
    s = (got or {}).get("spans", {}).get(name)
    return s if s and s["calls"] else None


def traced_counter(name: str):
    """What the program's counter `name` counted while the profiler
    recorded, or None where the program has no such counter."""
    return ((traced() or {}).get("counters") or {}).get(name)


def _busy_before(t, seg_start, seg_end, busy_cum):
    """The device's busy nanoseconds before each time of `t`: the union's
    segments (sorted, disjoint) clipped at it."""
    i = np.searchsorted(seg_start, t, side="right")
    last = np.maximum(i - 1, 0)
    past = np.where(i > 0, np.maximum(seg_end[last] - t, 0), 0) if len(seg_end) else 0
    return busy_cum[i] - past


def program_spans(dev, host, seg_start, seg_end) -> dict:
    """For each name of the program's `mvsnet.*` spans: `calls`; `host_s`,
    the seconds its spans were open; `device_s`, the device seconds of the
    operations whose launching runtime call started inside one of them on
    the span's own thread (the correlation rule of `trace._attribute`; a
    span holds what its nested spans launched); `copy_s`, the part of
    `device_s` in copies; and `idle_s`, the seconds its spans were open
    while the device ran nothing. `host`: (start, end, name, correlation,
    thread) of the host's ranges, ops and runtime calls; `dev`: (start,
    end, name, correlation) of the device's operations; `seg_start`,
    `seg_end`: the union of the device's intervals, sorted and disjoint."""
    spans = {}
    for t0, t1, name, _, tid in host:
        if name.startswith(PROGRAM):
            spans.setdefault(name, []).append((t0, t1, tid))
    if not spans:
        return {}
    launch = {corr: (t0, tid) for t0, _, name, corr, tid in host if name.startswith("cu")}
    ops = [(*launch[corr], t1 - t0, name.startswith("Memcpy"))
           for t0, t1, name, corr in dev if corr in launch]
    at = np.array([o[0] for o in ops], dtype=np.int64)
    op_tid = np.array([o[1] for o in ops], dtype=np.int64)
    dur = np.array([o[2] for o in ops], dtype=np.int64)
    copy = np.array([o[3] for o in ops], dtype=bool)
    seg_start = np.asarray(seg_start, dtype=np.int64)
    seg_end = np.asarray(seg_end, dtype=np.int64)
    busy_cum = np.concatenate([[0], np.cumsum(seg_end - seg_start)])
    out = {}
    for name, rows in sorted(spans.items()):
        rows.sort()
        t0 = np.array([r[0] for r in rows], dtype=np.int64)
        t1 = np.array([r[1] for r in rows], dtype=np.int64)
        tid = np.array([r[2] for r in rows], dtype=np.int64)
        busy = (_busy_before(t1, seg_start, seg_end, busy_cum)
                - _busy_before(t0, seg_start, seg_end, busy_cum))
        inside = np.zeros(len(at), dtype=bool)
        for thread in np.unique(tid):
            mine = tid == thread
            s0, s1 = t0[mine], t1[mine]
            on = np.flatnonzero(op_tid == thread)
            i = np.searchsorted(s0, at[on], side="right") - 1
            inside[on] = (i >= 0) & (s1[np.maximum(i, 0)] >= at[on])
        out[name] = {"calls": len(rows), "host_s": int((t1 - t0).sum()) / 1e9,
                     "device_s": int(dur[inside].sum()) / 1e9,
                     "copy_s": int(dur[inside & copy].sum()) / 1e9,
                     "idle_s": int((t1 - t0 - busy).sum()) / 1e9}
    return out


def device_union(dev):
    """The union of the device's intervals as sorted, disjoint (starts, ends)."""
    if not dev:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    dev = sorted(dev)
    starts = np.array([d[0] for d in dev], dtype=np.int64)
    ends = np.array([d[1] for d in dev], dtype=np.int64)
    run_end = np.maximum.accumulate(ends)
    new = np.ones(len(dev), dtype=bool)
    new[1:] = starts[1:] > run_end[:-1]
    return starts[new], np.append(run_end[np.flatnonzero(new)[1:] - 1], run_end[-1])


def events(prof):
    """(dev, host) of a stopped `torch.profiler`: the device's operations
    (start, end, name, correlation) and the host's ranges, ops and runtime
    calls (start, end, name, correlation, thread)."""
    from torch.autograd import DeviceType

    from mvs_bench.trace import _get

    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        t0 = _get(ev, "start_ns")
        t1 = t0 + _get(ev, "duration_ns")
        name, corr = _get(ev, "name"), _get(ev, "correlation_id")
        if _get(ev, "device_type") == DeviceType.CUDA:
            if not _get(ev, "is_user_annotation"):
                dev.append((t0, t1, name, corr))
        else:
            host.append((t0, t1, name, corr, _get(ev, "device_resource_id")))
    return dev, host


def main(argv=None) -> int:
    from mvs_bench import run, trace

    read_profile = trace.read_profile

    def read_and_reduce(prof, *args, **kwargs):
        dev, host = events(prof)
        spans = program_spans(dev, host, *device_union(dev))
        print(f"diag spans {json.dumps(spans)}", file=sys.stderr, flush=True)
        return read_profile(prof, *args, **kwargs)

    trace.read_profile = read_and_reduce
    try:
        return run.main([*(sys.argv[1:] if argv is None else argv), "--trace", "1"])
    finally:
        trace.read_profile = read_profile


if __name__ == "__main__":
    sys.exit(main())
