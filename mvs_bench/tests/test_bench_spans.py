"""The program's spans and counters as the benchmark reads them
(`mvs_bench/spans.py` and the readers `stage_host_ms.serve`,
`h2d_gbps.serve`, `stage_idle.serve`, `forward_host_ms.serve`,
`writer_wait_ms.serve`): the span reduction on a synthetic event list,
each reader on a synthetic record and on a program without the spans or
counters, and a traced run of the harness on the CPU."""

import json
import time
from pathlib import Path

import pytest
import torch

from mvs_bench import harness, spans
from mvsnet_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ["stage_host_ms.serve", "h2d_gbps.serve", "stage_idle.serve",
           "forward_host_ms.serve", "writer_wait_ms.serve"]


def test_program_spans_take_their_threads_launches_and_the_idle_inside():
    # host events (start, end, name, correlation, thread); device events
    # (start, end, name, correlation): a span holds the device time that
    # runtime calls started inside it on its own thread launched (its
    # nested spans' too, whenever the operation ran), and the device's idle
    # time while it was open, clipped to its ends
    host = [(0, 100, "mvsnet.predict", 0, 1), (0, 30, "mvsnet.predict.stage", 0, 1),
            (5, 25, "cudaMemcpyAsync", 11, 1), (30, 100, "mvsnet.predict.forward", 0, 1),
            (35, 60, "mvsnet.features", 0, 1), (40, 41, "cudaLaunchKernel", 12, 1),
            (70, 71, "cuLaunchKernel", 13, 1), (120, 130, "mvsnet.predict.stage", 0, 1),
            (20, 95, "mvsnet.writer.job", 0, 2), (22, 94, "cudaMemcpyAsync", 14, 2),
            (0, 200, "mvs_bench.features", 1, 1)]
    dev = [(10, 25, "Memcpy HtoD (Pageable -> Device)", 11), (50, 80, "conv", 12),
           (80, 90, "k1", 13), (90, 94, "Memcpy DtoH (Device -> Pageable)", 14),
           (94, 99, "lost", 99)]
    seg_start, seg_end = spans.device_union(dev)
    assert (list(seg_start), list(seg_end)) == ([10, 50], [25, 99])
    got = spans.program_spans(dev, host, seg_start, seg_end)
    assert set(got) == {"mvsnet.predict", "mvsnet.predict.stage", "mvsnet.predict.forward",
                        "mvsnet.features", "mvsnet.writer.job"}
    want = {  # calls, host, device, copy, idle
        "mvsnet.predict": (1, 100, 55, 15, 41 - 5),
        "mvsnet.predict.stage": (2, 40, 15, 15, 15 + 10),
        "mvsnet.predict.forward": (1, 70, 40, 0, 26 - 5),
        "mvsnet.features": (1, 25, 30, 0, 15),
        "mvsnet.writer.job": (1, 75, 4, 4, 75 - 5 - 45),
    }
    for name, (calls, host_ns, dev_ns, copy_ns, idle_ns) in want.items():
        s = got[name]
        assert s["calls"] == calls, name
        assert (s["host_s"], s["device_s"], s["copy_s"], s["idle_s"]) == pytest.approx(
            (host_ns * 1e-9, dev_ns * 1e-9, copy_ns * 1e-9, idle_ns * 1e-9)), name
    # with no device activity a span is idle while it is open
    bare = spans.program_spans([], host, *spans.device_union([]))
    assert bare["mvsnet.predict"]["idle_s"] == pytest.approx(100e-9)
    assert bare["mvsnet.predict"]["device_s"] == 0
    assert spans.program_spans(dev, [h for h in host if h[2].startswith("cu")], [10], [99]) == {}


def _ctx(profile):
    record = {"window_s": 2.0, "completed": 10, "host_ms": [100.0] * 10, "profile": profile}
    return harness.Context(harness.Cell(SPEC, "mvsnet.serve"), record)


PROFILE = {"busy_s": 1.0, "range_s": {}, "range_calls": {},
           "device_ops": [["conv", 0.5], ["Memcpy HtoD (Pageable -> Device)", 0.06],
                          ["Memcpy HtoD (Pinned -> Device)", 0.02],
                          ["Memcpy DtoH (Device -> Pageable)", 0.01]],
           "idle_gaps": [["mvsnet.predict.stage", 0.5], ["mvsnet.predict", 0.2],
                         ["(shorter gaps)", 0.1]]}
PARENT_PROFILE = {**PROFILE, "idle_gaps": [["predict", 0.5]]}
TRACED = {"spans": {"mvsnet.predict.stage": {"calls": 4, "host_s": 0.2},
                    "mvsnet.predict.forward": {"calls": 4, "host_s": 0.24}},
          "counters": {"predict.requests": 4, "predict.staged_bytes": 4e8,
                       "writer.jobs": 10, "writer.wait_s": 0.02}}


@pytest.mark.parametrize("metric,value", [
    ("stage_host_ms.serve", 50.0), ("h2d_gbps.serve", 5.0), ("stage_idle.serve", 25.0),
    ("forward_host_ms.serve", 60.0), ("writer_wait_ms.serve", 2.0)])
def test_program_metrics_read_the_spans_and_counters(metric, value, monkeypatch):
    read = harness.Cell(SPEC, "mvsnet.serve").reader(metric)
    monkeypatch.setattr(profiling, "traced", lambda: TRACED)
    assert read(_ctx(PROFILE)) == pytest.approx(value)
    # nothing recorded while the profiler ran: nothing to read, no error
    monkeypatch.setattr(profiling, "traced", lambda: {"spans": {}, "counters": {}})
    assert read(_ctx(PARENT_PROFILE)) is None
    # a program without the read-out (the parent's tree): None, no error
    monkeypatch.delattr(profiling, "traced")
    assert read(_ctx(PARENT_PROFILE)) is None
    assert read(_ctx(None)) is None


def test_a_traced_cpu_run_reads_the_programs_spans_and_counters():
    cell = harness.Cell(SPEC, "mvsnet.serve")
    cell.op.update(height=64, width=64, max_d=8)
    cell.mix.update(pool=2, warmup_requests=1)
    before = profiling.traced()
    out, _ = harness.run_cell(cell, 2 ** 31 + 77, 0.5, True, "cpu", time.perf_counter(),
                              {"compute_dtype": "float32"})
    after = profiling.traced()
    assert out["correct"] is True
    requests = after["counters"]["predict.requests"] - before["counters"]["predict.requests"]
    assert requests == out["attempted"] > 0        # the window's requests, not the warm-up's
    stage = after["spans"]["mvsnet.predict.stage"]["calls"] - \
        before["spans"].get("mvsnet.predict.stage", {"calls": 0})["calls"]
    assert stage == requests
    # the CPU has no device trace: the readers of the program's clock read
    for metric in ("stage_host_ms.serve", "forward_host_ms.serve", "writer_wait_ms.serve"):
        assert out["metrics"][metric]["value"] >= 0, metric
    assert "h2d_gbps.serve" not in out["metrics"]


def test_the_spans_run_without_a_card_exits_without_a_result(capsys):
    from mvs_bench import trace

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    read_profile = trace.read_profile
    assert spans.main(["--workload", "mvsnet.serve", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
    assert trace.read_profile is read_profile
