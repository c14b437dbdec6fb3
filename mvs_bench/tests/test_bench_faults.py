"""A run of each cell at a tiny size on the CPU (float32, the port's plain
path) is correct, and the same run with the timed path broken underneath
is not: an answer altered where it is produced (each kind of number a
cell compares, once). The cells serve on one chip: no exchange to leave
out, no training state or batch to break."""

import json
import time
from pathlib import Path

import pytest

from mvs_bench import harness

SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())


def _run(name, seed=2 ** 31 + 17):
    cell = harness.Cell(SPEC, name)
    cell.op.update(height=64, width=64, max_d=8)
    cell.mix.update(pool=2, warmup_requests=1)
    out, _ = harness.run_cell(cell, seed, 0.5, False, "cpu", time.perf_counter(),
                              {"compute_dtype": "float32"})
    return out


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_unbroken_run_is_correct(name):
    assert _run(name)["correct"] is True


def test_mvsnet_depth_altered_where_produced(monkeypatch):
    import mvsnet_tpu_torch.models.mvsnet as m

    real = m.soft_argmin_prob_map

    def altered(reg, depth_start, depth_interval, *a, **k):
        depth, prob = real(reg, depth_start, depth_interval, *a, **k)
        return depth + 0.5 * depth_interval.reshape(-1, 1, 1, 1), prob
    monkeypatch.setattr(m, "soft_argmin_prob_map", altered)
    assert _run("mvsnet.serve")["correct"] is False


def test_mvsnet_prob_altered_where_produced(monkeypatch):
    import mvsnet_tpu_torch.models.mvsnet as m

    real = m.soft_argmin_prob_map

    def altered(*a, **k):
        depth, prob = real(*a, **k)
        return depth, prob * 0.9
    monkeypatch.setattr(m, "soft_argmin_prob_map", altered)
    assert _run("mvsnet.serve")["correct"] is False


def test_rmvsnet_depth_altered_where_produced(monkeypatch):
    import mvsnet_tpu_torch.models.mvsnet as m

    real = m.winner_take_all_update
    last = []

    def off_by_one(carry, prob, depth_value):
        # each plane's winner is recorded with the plane before's depth
        before = last[-1] if last else depth_value
        last.append(depth_value)
        return real(carry, prob, before)
    monkeypatch.setattr(m, "winner_take_all_update", off_by_one)
    assert _run("rmvsnet.serve")["correct"] is False


def test_rmvsnet_prob_altered_where_produced(monkeypatch):
    import mvsnet_tpu_torch.models.mvsnet as m

    real = m.MVSNet.forward_gru_wta

    def altered(*a, **k):
        depth, prob = real(*a, **k)
        return depth, prob * 0.9
    monkeypatch.setattr(m.MVSNet, "forward_gru_wta", altered)
    assert _run("rmvsnet.serve")["correct"] is False
