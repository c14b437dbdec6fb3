"""The serving path's spans and counters (`utils/profiling.py`): the spans
`Predictor.predict` and the output writer open under `torch.profiler`,
their nesting and ids, that nothing is built with no profiler recording,
the counters of requests, staged bytes and the writer's jobs, and the
maps bit-equal with a profiler on and off; the staging of the inputs: on
the CPU as plain as before, the float32 conversion of the card's staging
against numpy's, and its ring of page-locked areas driven with stand-ins
for the page-locked memory and the CUDA events. CPU, tiny: 64x64, D=8,
V=3, float32, the graphs of `tests/golden/regenerate.py`."""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvsnet_tpu_torch.config import ModelConfig
from mvsnet_tpu_torch.ops.kernels import conv, deconv, sweep, warp, wgrad
from mvsnet_tpu_torch.predict import AsyncOutputWriter, PinnedStaging, Predictor, fill_float32
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


KERNEL_COUNTERS = [f"launches.{k}" for k in (
    "cost_volume", "cost_volume_sharded", "cost_volume_pixel", "conv", "deconv", "group_norm",
    "gru_step", "warp", "warp_transpose", "warp_sharded", "warp_transpose_sharded", "wgrad")] + [
    f"editions.{k}.{e}" for k in ("conv", "deconv", "wgrad") for e in ("tc", "simt")]


def test_counters_hold_the_kernels_launch_counts():
    """`counters()` lists every kernel's launches and every edition's from
    the start, and the wrappers' plain path on the CPU counts nothing."""
    got = profiling.counters()
    assert set(KERNEL_COUNTERS) <= set(got) and set(profiling.SERVING) <= set(got)
    assert all(isinstance(v, (int, float)) for v in got.values())
    x, k = torch.zeros(1, 8, 8, 8, dtype=torch.bfloat16), torch.zeros(3, 3, 8, 8)
    conv.conv(x, k, edition="tc")
    deconv.deconv(x, k)
    wgrad.wgrad(x, x, (3, 3), 1)
    sweep.cost_volume(x[0], x, torch.zeros(1, 2, 3, 3))
    warp.warp_all_depths(x[0], torch.zeros(2, 3, 3))
    assert profiling.counters() == got


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


PINNED = ("predict.pinned_stages", "predict.pinned_allocs", "predict.stage_wait_s")


def test_cpu_predictor_stages_as_before(predictor):
    """On the CPU the inputs pass through `np.array(a, dtype=np.float32)`
    and `torch.as_tensor` as before the ring: the staged bytes as before,
    no pinned counter moves, and the maps equal, bit for bit, the forward
    on inputs staged that way."""
    inputs = _inputs()
    before = profiling.counters()
    got = predictor.predict(*inputs)
    after = profiling.counters()
    assert predictor._staging is None
    assert after["predict.staged_bytes"] - before["predict.staged_bytes"] == \
        sum(np.array(a, dtype=np.float32).nbytes for a in inputs)
    assert all(after[k] == before[k] for k in PINNED)
    with torch.inference_mode():
        want = predictor._forward(*[torch.as_tensor(np.array(a, dtype=np.float32))
                                    for a in inputs])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())


def _sources():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 5)) * 10.0 ** rng.integers(-45, 37, (3, 4, 5))
    x.flat[:5] = [np.inf, -np.inf, 3.4028234663852886e38, 1e-40, 1e-46]
    big = x.astype(">f8")
    readonly = x.copy()
    readonly.flags.writeable = False
    return {
        "float64": x,
        "float32": x.astype(np.float32),
        "uint8": rng.integers(0, 256, (3, 4, 5)).astype(np.uint8),
        "int64": rng.integers(-2 ** 40, 2 ** 40, (3, 4, 5)),
        "float16": np.clip(x, -6e4, 6e4).astype(np.float16),
        "bool": x > 0,
        "transposed": x.transpose(2, 0, 1),
        "reversed": x[::-1, :, ::-2],
        "read-only": readonly,
        "big-endian": big,
        "list": x[0].tolist(),
        "scalar": 0.1,
        "tensor float64": torch.from_numpy(x.copy()),
        "tensor uint8 strided": torch.arange(120, dtype=torch.uint8).reshape(3, 4, 10)[..., ::2],
    }


@pytest.mark.parametrize("name", list(_sources()))
def test_fill_float32_gives_numpys_float32(name):
    """The card's staging writes each input into its page-locked area with
    the bits of `np.array(a, dtype=np.float32)`, whatever the source's
    dtype, layout or kind."""
    a = _sources()[name]
    want = np.array(a.numpy() if torch.is_tensor(a) else a, dtype=np.float32)
    dst = torch.full(want.shape, -1.0)
    fill_float32(dst, a)
    np.testing.assert_array_equal(dst.numpy().view(np.uint32), want.view(np.uint32))


class _Event:
    """A stand-in for `torch.cuda.Event` that logs what is done to it."""

    log = []

    def record(self, stream):
        self.log.append(("record", self))

    def synchronize(self):
        self.log.append(("wait", self))


@pytest.fixture
def ring(monkeypatch):
    """A `PinnedStaging` on the CPU: plain memory for the page-locked
    areas, `_Event` for the CUDA events (the device copies are the areas'
    own views on the CPU)."""
    _Event.log = []
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    page_locked = PinnedStaging._page_locked

    def plain(n):
        with monkeypatch.context() as m:
            m.setattr(torch, "empty", lambda n, dtype, pin_memory: torch.zeros(n, dtype=dtype))
            return page_locked(n)
    monkeypatch.setattr(PinnedStaging, "_page_locked", staticmethod(plain))
    return PinnedStaging("cpu")


def test_ring_waits_on_each_areas_own_event_and_grows_only_when_needed(ring):
    """Requests take the two areas in turn; each refill waits on the event
    recorded after that area's copies and on nothing else; after the first
    two requests no area is made over six more, and a larger request grows
    the one area it takes."""
    images, cams, *rest = _inputs()
    before = profiling.counters()
    for _ in range(8):
        ring.stage([images, cams, *rest])
    mid = profiling.counters()
    assert mid["predict.pinned_allocs"] - before["predict.pinned_allocs"] == 2
    assert mid["predict.pinned_stages"] - before["predict.pinned_stages"] == 8
    assert mid["predict.stage_wait_s"] >= before["predict.stage_wait_s"]
    events = [e for _, e in _Event.log]
    assert len({id(e) for e in events}) == 2
    first, second = events[0], events[1]
    assert [(op, e is first) for op, e in _Event.log] == \
        [("record", True), ("record", False)] + \
        [("wait", i % 2 == 0) if j == 0 else ("record", i % 2 == 0)
         for i in range(6) for j in range(2)]
    ring.stage([np.concatenate([images, images], axis=2), cams, *rest])
    assert profiling.counters()["predict.pinned_allocs"] - mid["predict.pinned_allocs"] == 1


def test_ring_copies_the_callers_arrays_before_it_returns(ring):
    """What `stage` returns holds the values the arrays had when it was
    called, float32, whatever the caller writes into them afterwards; areas
    made inside `torch.inference_mode` (as `predict` runs) are refilled
    outside it; a request whose copy fails still records its area's
    event."""
    images, cams, *rest = _inputs()
    want = [np.array(a, dtype=np.float32) for a in (images, cams, *rest)]
    with torch.inference_mode():
        ring.stage([images, cams, *rest])
        ring.stage([images, cams, *rest])
    got = ring.stage([images, cams, *rest])
    images[...] = 7.0
    cams[...] = -1.0
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError):
        ring.stage([images, np.array(["not a number"])])
    assert [op for op, _ in _Event.log][-4:] == ["wait", "record", "wait", "record"]


def test_predict_through_the_ring_gives_the_plain_maps(predictor, ring, monkeypatch):
    """`Predictor.predict` with its inputs staged through the ring (the
    card's path, here with the CPU's stand-ins) counts each request once
    and gives maps bit-equal to the plain staging's, while the caller
    overwrites its arrays after each call."""
    inputs = _inputs()
    want = predictor.predict(*inputs)
    monkeypatch.setattr(predictor, "_staging", ring)
    before = profiling.counters()
    for _ in range(3):
        mine = [np.array(a) for a in inputs]
        got = predictor.predict(*mine)
        for a in mine:
            a[...] = 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    after = profiling.counters()
    assert after["predict.pinned_stages"] - before["predict.pinned_stages"] == 3
    assert after["predict.staged_bytes"] - before["predict.staged_bytes"] == \
        3 * sum(np.array(a, dtype=np.float32).nbytes for a in inputs)
