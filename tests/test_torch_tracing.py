"""The serving path's spans and counters (`utils/profiling.py`): the spans
`Predictor.predict` and the output writer open under `torch.profiler`,
their nesting and ids, that nothing is built with no profiler recording,
the counters of requests, staged bytes and the writer's jobs, and the
maps bit-equal with a profiler on and off. CPU, tiny: 64x64, D=8, V=3,
float32, the graphs of `tests/golden/regenerate.py`."""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.ops import kernels
from mvsnet_tpu_torch.predict import AsyncOutputWriter, Predictor
from mvsnet_tpu_torch.utils import profiling

GRAPHS = [("3DCNN", "ultralite"), ("GRU", "lite")]
FORWARD = ["mvsnet.features", "mvsnet.cost_volume", "mvsnet.regularizer", "mvsnet.depth_tail"]


def _inputs(V=3, H=64, W=64, D=8):
    rng = np.random.default_rng(42)
    images = rng.standard_normal((1, V, H, W, 3)).astype(np.float32)
    cam = np.zeros((2, 4, 4), np.float32)
    cam[0] = np.eye(4)
    cam[0, 0, 3] = 2.0
    cam[1, :3, :3] = [[15.0, 0, W / 8], [0, 15.0, H / 8], [0, 0, 1]]
    cam[1, 3] = [5.0, 0.5, D, 8.5]
    cams = np.stack([cam] * V)[None]
    return images, cams, np.array([5.0]), np.array([0.5]), np.array([8.5])


@pytest.fixture(scope="module", params=GRAPHS, ids=[g[0] for g in GRAPHS])
def predictor(request):
    reg, mode = request.param
    cfg = ModelConfig(view_num=3, max_d=8, width=64, height=64, network_mode=mode,
                      regularization=reg, compute_dtype="float32")
    return Predictor(cfg, seed=7, device="cpu")


def _spans(prof):
    """(start, end, name, ids, thread) of every `mvsnet.*` range, by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("mvsnet."):
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                        list(e.concrete_inputs()), e.device_resource_id()))
    return sorted(out)


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_predict_writes_the_spans_nested_with_request_ids(predictor):
    inputs = _inputs()
    first = predictor._requests
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        for _ in range(2):
            predictor.predict(*inputs)
    spans = _spans(prof)
    calls = [s for s in spans if s[2] == "mvsnet.predict"]
    assert [s[3] for s in calls] == [[first], [first + 1]]
    for call in calls:
        mine = [s for s in spans if _inside(s, call) and s is not call]
        assert [s[2] for s in mine] == ["mvsnet.predict.stage", "mvsnet.predict.forward",
                                        *FORWARD]
        stage, forward = mine[:2]
        assert stage[1] <= forward[0]
        assert all(_inside(s, forward) for s in mine[2:])
        assert all(a[1] <= b[0] for a, b in zip(mine[2:], mine[3:]))    # one after another
        assert len({s[4] for s in mine + [call]}) == 1                   # on the caller's thread
    assert len(spans) == 2 * (3 + len(FORWARD))


def test_predict_builds_no_span_without_a_profiler(predictor, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was built with no profiler recording")

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    depth, prob, _ = predictor.predict(*_inputs())
    assert np.isfinite(depth).all() and np.isfinite(prob).all()


def test_predict_counts_a_request_and_its_staged_bytes(predictor):
    inputs = _inputs()
    before = profiling.counters()
    predictor.predict(*inputs, fetch=False)
    after = profiling.counters()
    assert after["predict.requests"] - before["predict.requests"] == 1
    assert after["predict.staged_bytes"] - before["predict.staged_bytes"] == \
        sum(np.asarray(a, np.float32).nbytes for a in inputs)


def test_maps_are_bit_equal_with_a_profiler_on_and_off(predictor):
    inputs = _inputs()
    off = predictor.predict(*inputs)
    with profile(activities=[ProfilerActivity.CPU]):
        on = predictor.predict(*inputs)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


def test_writer_counts_each_job_and_its_wait():
    before = profiling.counters()
    done = []
    with AsyncOutputWriter(max_pending=2, write_fn=done.append) as writer:
        for i in range(5):
            writer.write(i)
    after = profiling.counters()
    assert done == list(range(5))
    assert after["writer.jobs"] - before["writer.jobs"] == 5
    assert after["writer.wait_s"] - before["writer.wait_s"] >= 0


def test_writer_counters_lose_no_update_across_writers():
    """Writers on eight threads, each its own worker, with the interpreter
    switching threads as often as it can: every job is counted."""
    writers, jobs = 8, 200
    before = profiling.counters()["writer.jobs"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def feed():
            with AsyncOutputWriter(max_pending=4, write_fn=lambda i: i) as writer:
                for i in range(jobs):
                    writer.write(i)
        threads = [threading.Thread(target=feed) for _ in range(writers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.counters()["writer.jobs"] - before == writers * jobs


def test_writer_job_span_runs_on_the_writers_thread():
    """A profiler of every thread records `mvsnet.writer.job` on the
    worker's thread, one a job, with the writer's running count as `job`."""
    from torch._C._profiler import _ExperimentalConfig

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        with profiling.span("mvsnet.predict", request=0):
            with AsyncOutputWriter(max_pending=1, write_fn=lambda i: i) as writer:
                for i in range(3):
                    writer.write(i)
    spans = _spans(prof)
    jobs = [s for s in spans if s[2] == "mvsnet.writer.job"]
    main = next(s for s in spans if s[2] == "mvsnet.predict")
    assert [s[3] for s in jobs] == [[1], [2], [3]]
    assert {s[4] for s in jobs} != {main[4]} and len({s[4] for s in jobs}) == 1


def test_counters_hold_the_kernels_launch_counts():
    got = profiling.counters()
    assert {f"launches.{k}": n for k, n in kernels.launch_counts().items()}.items() <= got.items()
    for k, editions in kernels.edition_counts().items():
        assert all(got[f"editions.{k}.{e}"] == n for e, n in editions.items())
    assert set(profiling.SERVING) <= set(got)
    assert all(isinstance(v, (int, float)) for v in got.values())


def test_traced_tallies_only_what_ran_while_a_profiler_recorded(predictor):
    """`profiling.traced()` adds a request's spans (calls, host seconds)
    and counts only while a profiler records; `counters()` counts always."""
    inputs = _inputs()
    first, total = profiling.traced(), profiling.counters()
    predictor.predict(*inputs, fetch=False)
    assert profiling.traced() == first
    with profile(activities=[ProfilerActivity.CPU]):
        predictor.predict(*inputs, fetch=False)
    after = profiling.traced()
    for name in ["mvsnet.predict", "mvsnet.predict.stage", "mvsnet.predict.forward", *FORWARD]:
        was = first["spans"].get(name, {"calls": 0, "host_s": 0.0})
        assert after["spans"][name]["calls"] == was["calls"] + 1, name
        assert after["spans"][name]["host_s"] > was["host_s"], name
    outer = after["spans"]["mvsnet.predict"]["host_s"] - \
        first["spans"].get("mvsnet.predict", {"host_s": 0.0})["host_s"]
    inner = sum(after["spans"][n]["host_s"] - first["spans"].get(n, {"host_s": 0.0})["host_s"]
                for n in ("mvsnet.predict.stage", "mvsnet.predict.forward"))
    assert inner <= outer
    staged = sum(np.asarray(a, np.float32).nbytes for a in inputs)
    assert after["counters"]["predict.requests"] - first["counters"]["predict.requests"] == 1
    assert after["counters"]["predict.staged_bytes"] - \
        first["counters"]["predict.staged_bytes"] == staged
    assert profiling.counters()["predict.requests"] - total["predict.requests"] == 2
