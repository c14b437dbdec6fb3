"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line's contents.

The system under test is `mvsnet_tpu_torch`, driven as its users' drivers
drive it: serving through `predict.Predictor.predict(..., fetch=False)`
with the maps fetched by the port's `AsyncOutputWriter` (one thread, in
order, at most `max_pending` waiting). What belongs to a configuration, a
traffic mix or a metric is read from its own file, by the name
`BENCHMARK.json` gives.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import resource
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mvs_bench import generate, trace
from mvs_bench.counts import HBM_BYTES_PER_S, PEAK_FLOPS, cost_volume_bytes, model_flops
from mvs_bench.reference import common
from mvs_bench.weights import make_weights

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mvsnet_tpu")
MAX_REQUESTS = 100_000     # more than any window serves: the kept ones are drawn among these


class Cell:
    """A workload of `BENCHMARK.json` with its configuration, traffic mix,
    limits and metrics, read from their files by name."""

    def __init__(self, spec: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
        self.name = name
        self.workload = cells[name]
        self.config = json.loads((root / "configs" / f"{self.workload['config']}.json")
                                 .read_text())
        self.mix = json.loads((root / "traffic" / f"{self.workload['traffic']}.json")
                              .read_text())
        self.limits = json.loads((root / "limits" / f"{name}.json").read_text())["limits"]
        self.op = dict(self.config["operating_point"])
        self.reference = importlib.import_module(self.config["reference"])

        def mine(m):
            return name in m.get("workloads", [name])
        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]
        self.root = root

    def reader(self, metric: str):
        """The `read(ctx)` of `metrics/<metric>.py`."""
        path = self.root / "metrics" / f"{metric}.py"
        mod_spec = importlib.util.spec_from_file_location(f"mvs_bench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read

    def model_config(self, **overrides):
        from mvsnet_tpu_torch.config import ModelConfig

        fields = {k: v for k, v in self.config["model"].items() if k != "base_filters"}
        for k in ("view_num", "max_d", "width", "height", "interval_scale"):
            fields[k] = self.op[k]
        fields.update(overrides)
        return ModelConfig(**fields)


def load_spec(path: Path = ROOT.parent / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def forbidden_modules(modules) -> list:
    """The names in `modules` whose top-level name is a forbidden package's, whole."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def _peak_reset(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# --- serving ------------------------------------------------------------------

def kept_requests(mix: dict, seed: int, pool: int) -> set:
    """The window's requests whose answers are kept and compared: the first
    request of each pool entry and a share `compare_share` of the later
    ones, drawn from the seed (the rest are fetched, timed and dropped, so
    that the harness holds few maps on the host)."""
    draw = np.random.default_rng([seed, pool]).random(MAX_REQUESTS)
    return set(range(pool)) | set(np.flatnonzero(draw < mix["compare_share"]).tolist())


def serve(cell: Cell, weights: dict, seed: int, seconds: float, traced: bool, device,
          t_start: float, cfg_overrides: dict):
    """Set-up, warm-up and the closed loop of requests for `seconds`.
    Returns the window's record, the kept answers (pool index, depth,
    prob) and the pool."""
    from mvsnet_tpu_torch.predict import AsyncOutputWriter, Predictor

    mix = cell.mix
    cfg = cell.model_config(**cfg_overrides)
    predictor = Predictor(cfg, num_devices=1, state_dict=weights, device=device)
    pool = generate.serve_pool(mix, cell.op, seed, device)
    P = len(pool)
    kept = kept_requests(mix, seed, P)
    done, latencies = {}, []

    def fetch(i, t_sent, out):
        with trace.span("writer.fetch", traced):
            depth, prob = (o.float().cpu().numpy()[0, ..., 0] for o in out[:2])
        latencies.append(time.perf_counter() - t_sent)
        if i in kept:
            done[i] = (depth, prob)

    def request(writer, i, host_ms, write_ms):
        t_sent = time.perf_counter()
        with trace.span("predict", traced):
            out = predictor.predict(*pool[i % P], fetch=False)
        t_queued = time.perf_counter()
        host_ms.append((t_queued - t_sent) * 1e3)
        writer.write(i, t_sent, out)
        write_ms.append((time.perf_counter() - t_queued) * 1e3)

    with AsyncOutputWriter(max_pending=mix["max_pending"], write_fn=fetch) as writer:
        for i in range(mix["warmup_requests"]):
            request(writer, -1 - i, [], [])
        writer.flush()
    _sync(device)
    done.clear()
    latencies.clear()

    model = predictor.model
    regularizer = "gru_sweep" if hasattr(model, "gru_sweep") else "regnet"
    ranges = trace.ModuleRanges(
        {"features": model.feature_net, "regularizer": getattr(model, regularizer)},
        stage=("features", "regularizer", "cost_volume")) if traced else None
    peak_setup = _peak(device)
    _peak_reset(device)
    gc.collect()
    gc.freeze()           # set-up's objects stay out of the window's collections
    prof = trace.start_profiler(device) if traced else None
    host_ms, write_ms, attempted = [], [], 0
    usage = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    with AsyncOutputWriter(max_pending=mix["max_pending"], write_fn=fetch) as writer:
        while time.perf_counter() - t0 < seconds:
            attempted += 1
            try:
                request(writer, attempted - 1, host_ms, write_ms)
            except RuntimeError:      # a failed request is counted, not fatal
                pass
        writer.flush()
    _sync(device)
    window_s = time.perf_counter() - t0
    usage_end = resource.getrusage(resource.RUSAGE_SELF)
    if prof is not None:
        prof.__exit__(None, None, None)
    gc.unfreeze()
    record = {"setup_s": setup_s, "window_s": window_s, "attempted": attempted,
              "completed": len(latencies), "failed": attempted - len(latencies),
              "latencies_s": list(latencies),
              "peak_bytes": _peak(device), "peak_setup_bytes": peak_setup,
              "host_ms": host_ms}
    n = max(1, len(latencies))
    print(f"diag maps {len(latencies)} window_s {window_s:.4f} "
          f"host_ms_per_map {sum(host_ms) / n:.4f} write_wait_ms_per_map {sum(write_ms) / n:.4f} "
          f"cpu_user_s {usage_end.ru_utime - usage.ru_utime:.3f} "
          f"cpu_sys_s {usage_end.ru_stime - usage.ru_stime:.3f} "
          f"ctx_switches_involuntary {usage_end.ru_nivcsw - usage.ru_nivcsw} "
          f"ctx_switches_voluntary {usage_end.ru_nvcsw - usage.ru_nvcsw} "
          f"load1 {os.getloadavg()[0]:.2f} cpus {len(os.sched_getaffinity(0))}",
          file=sys.stderr, flush=True)
    if traced:
        ranges.close()
        record["profile"] = prof = trace.read_profile(prof)
        print(f"diag busy_s {prof['busy_s']:.4f} launched_s {prof['launched_s']:.4f} "
              f"range_s {json.dumps(prof['range_s'])} range_calls "
              f"{json.dumps(prof['range_calls'])}", file=sys.stderr, flush=True)
    answers = [(i % P, *done[i]) for i in sorted(done)]
    del predictor, model, ranges, prof
    return record, answers, pool


def repeat_gap(answers) -> float:
    """The widest difference between two answers to the same request (a
    deterministic program answers a request alike every time)."""
    first, gap = {}, 0.0
    for idx, depth, prob in answers:
        if idx in first:
            d0, p0 = first[idx]
            gap = max(gap, float(np.abs(depth - d0).max()), float(np.abs(prob - p0).max()))
        else:
            first[idx] = (depth, prob)
    return gap


def serve_numbers(cell: Cell, weights, pool, answers, device) -> dict:
    """The worst answer's errors against the float32 reference, and for
    each of the reference's `RATIO_KEYS` the worst answer's error over the
    error of a faithful bfloat16 computation of the same request (the plain
    reference rounded where the program rounds: how far the configuration's
    precision itself lands on this request and these weights), and the
    widest difference between two answers to one request."""
    ref = cell.reference
    D = cell.op["max_d"]
    exact = ref.serve_reference(weights, pool, D, device)
    faithful = ref.control_answers(ref.serve_reference(weights, pool, D, device, common.bf16),
                                   range(len(pool)))
    base = {a[0]: ref.answer_errors(exact, a, device) for a in faithful}
    worst = {}
    for a in answers:
        errors = ref.answer_errors(exact, a, device)
        for k, v in errors.items():
            worst[k] = max(worst.get(k, 0.0), v)
        for k in ref.RATIO_KEYS:
            ratio = errors[k] / max(base[a[0]][k], 1e-30)
            worst[k + "_ratio"] = max(worst.get(k + "_ratio", 0.0), ratio)
    worst["repeat_gap"] = repeat_gap(answers)
    return worst


# --- one run ------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile of all values (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             cfg_overrides: dict | None = None):
    """The result line's contents of one run (correct, attempted, failed,
    metrics, device, with a trace the breakdown, and last the numbers
    compared beside their limits, "checks"), and every number the
    reference's comparison gives, compared or not."""
    device = torch.device(device)
    cfg_overrides = cfg_overrides or {}
    weights = make_weights(cell.reference.param_specs(cell.config["model"]), seed, device)
    window = min(seconds, cell.mix["trace_seconds"]) if traced else seconds
    record, answers, pool = serve(cell, weights, seed, window, traced, device, t_start,
                                  cfg_overrides)
    found = forbidden_modules(list(sys.modules))
    if found:
        raise ForbiddenImport(found)
    _free(device)
    common.no_tf32()
    numbers = serve_numbers(cell, weights, pool, answers, device)
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()
              if k in cell.limits}
    correct = (record["failed"] == 0 and record["attempted"] > 0 and bool(checks)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    ctx = Context(cell, record)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cell.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": max(record["peak_bytes"], record["peak_setup_bytes"])}
    out = {"correct": bool(correct), "attempted": record["attempted"],
           "failed": record["failed"], "metrics": metrics, "device": dev}
    if traced:
        prof = record["profile"]
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = record["window_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    out["checks"] = checks
    return out, numbers


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__("modules of JAX or of the JAX package were loaded: " + ", ".join(found))
        self.found = found


class Context:
    """What a metric's reader reads: the window's record and the cell's
    counts from shapes."""

    def __init__(self, cell: Cell, record: dict):
        self.cell = cell
        self.record = record
        self.window_s = record["window_s"]
        self.dtype = cell.config["model"]["compute_dtype"]
        self.peak_flops = PEAK_FLOPS[self.dtype]
        self.hbm_bytes_per_s = HBM_BYTES_PER_S
        op = cell.op
        self.flops_per_cluster = model_flops(cell.config, op)
        self.cost_volume_bytes = cost_volume_bytes(
            op["view_num"], op["height"] // 4, op["width"] // 4,
            4 * cell.config["model"]["base_filters"], op["max_d"], self.dtype)
        self.profile = record.get("profile")

    @property
    def maps(self) -> int:
        return self.record.get("completed", 0)

    def range_ms(self, name: str):
        """Device ms a call of the `mvs_bench.<name>` range (`trace.read_profile`),
        or None where the trace attributes no device time to it."""
        prof = self.profile or {}
        seconds = prof.get("range_s", {}).get(name)
        calls = prof.get("range_calls", {}).get(name)
        return 1e3 * seconds / calls if seconds and calls else None
