"""The harness on the CPU: traffic by seed, counts against hand counts,
the result line's keys, `BENCHMARK.json` against the contract, and every
cell's files found by name."""

import json
import math
import re
import statistics
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mvs_bench import counts, generate, harness, trace

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _mix(name):
    return json.loads((ROOT / "mvs_bench" / "traffic" / f"{name}.json").read_text())


OP = {"height": 64, "width": 96, "max_d": 8, "interval_scale": 1.06, "view_num": 3}


def test_traffic_is_fixed_by_the_seed():
    m = {**_mix("serve_stream"), "pool": 3}
    a, b, c = (generate.serve_pool(m, OP, s, "cpu") for s in (2 ** 31 + 5, 2 ** 31 + 5,
                                                               2 ** 31 + 6))
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert not np.array_equal(a[0][1], c[0][1])          # other cams
    assert [t.shape for t in a[0]] == [t.shape for t in c[0]]   # the same sizes


def test_serve_depth_range_inside_dtu():
    m = _mix("serve_stream")
    for _, cams, ds, di, de in generate.serve_pool({**m, "pool": 4}, OP, 3, "cpu"):
        assert ds[0] >= 425.0 and de[0] <= 935.0 + 1e-3
        assert abs(de[0] - (ds[0] + (OP["max_d"] - 1) * di[0])) < 1e-3


def test_conv_flops_hand_count():
    # 3x3x3 SAME conv, 4 -> 2 channels over 2x3x4: per axis the (output,
    # tap) pairs inside are 3n - 2 (the two border outputs lose one tap)
    assert counts.conv_flops((2, 3, 4), 4, 2, 3) == 2 * 4 * 2 * (4 * 7 * 10)
    # stride 2 over 5: outputs 0..2 read 2o-1..2o+1 (SAME low pad 1): 2+3+2
    assert counts.valid_pairs(5, 3, 2) == 7


def test_deconv_flops_hand_count():
    # k3 s2 transposed conv over n inputs, output 2n: 3n taps less the one
    # that lands at 2n
    assert counts.deconv_flops((2, 3, 4), 8, 4) == 2 * 8 * 4 * (5 * 8 * 11)


def test_cost_volume_bytes_hand_count():
    # V=3 maps of 2x2x8 bf16 read once, 2 x 4 homographies of 9 float32,
    # 4 planes of 2x2x8 bf16 written once
    assert counts.cost_volume_bytes(3, 2, 2, 8, 4, "bfloat16") == \
        3 * 32 * 2 + 2 * 4 * 36 + 4 * 32 * 2


def test_unet_flops_of_the_serving_point():
    # the 3D U-Net at 1152x864, D=192 does about 270 GFLOP a map
    assert 2.5e11 < counts.unet_flops(192, 216, 288) < 3.0e11


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 2 + 14 * 24 <= 43200
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in SPEC["configs"]]
    cells = [w["name"] for w in SPEC["workloads"]]
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
    assert {"setup_s"} <= {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower",
                                                                                 "higher")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and w["config"] in names
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_by_name(cell):
    c = harness.Cell(SPEC, cell)
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m["name"]))
    assert c.end_to_end and c.per_layer
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2
    assert c.limits and all(math.isfinite(v) for v in c.limits.values())
    config_file = next(x["file"] for x in SPEC["configs"] if x["name"] == c.workload["config"])
    assert (ROOT / config_file).is_file()


def test_the_result_line_has_the_contract_keys():
    cell = harness.Cell(SPEC, "mvsnet.serve")
    cell.op.update(height=64, width=64, max_d=8)
    cell.mix.update(pool=2, warmup_requests=1)
    out, numbers = harness.run_cell(cell, 2 ** 31 + 99, 0.5, False, "cpu", time.perf_counter(),
                                    {"compute_dtype": "float32"})
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    # every end-to-end metric but the card's peak, which the CPU has not
    assert set(out["metrics"]) == {"maps_per_s", "setup_s"}
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(cell.limits) and set(numbers) >= set(cell.limits)
    json.dumps(out)


def test_run_without_a_card_exits_without_a_result(capsys):
    from mvs_bench import run

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "mvsnet.serve", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_percentile_is_of_all_values():
    v = list(range(1, 101))
    assert harness.percentile(v, 95) == pytest.approx(statistics.quantiles(v, n=20,
                                                                            method="inclusive")[-1])


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["mvsnet_tpu_torch.models", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "mvsnet_tpu.ops", "flax"]) == \
        ["flax", "jax.numpy", "mvsnet_tpu.ops"]


def test_kept_requests_are_fixed_by_the_seed():
    m = _mix("serve_stream")
    a, b, c = (harness.kept_requests(m, s, 8) for s in (2 ** 40 + 1, 2 ** 40 + 1, 2 ** 40 + 2))
    assert a == b and a != c
    assert set(range(8)) <= a
    later = len(a) - 8
    assert abs(later / harness.MAX_REQUESTS - m["compare_share"]) < 0.01


def test_device_time_is_attributed_to_the_launching_range():
    # host events (start, end, name, correlation); device events (start,
    # end, name, correlation): an operation belongs to the range in which
    # the runtime call of its correlation started, whenever it ran; the
    # writer's device-to-host fetch belongs to none
    host = [(0, 100, "mvs_bench.features", 1), (10, 12, "cudaLaunchKernel", 11),
            (100, 150, "mvs_bench.cost_volume", 2), (120, 121, "cuLaunchKernel", 12),
            (150, 400, "mvs_bench.regularizer", 3), (160, 161, "cudaGraphLaunch", 13),
            (50, 60, "cudaMemcpyAsync", 14), (500, 510, "cudaLaunchKernel", 15),
            (20, 30, "aten::add", 11)]
    dev = [(300, 340, "conv", 11), (340, 350, "k1", 12), (350, 370, "cell", 13),
           (370, 380, "cell", 13), (380, 390, "Memcpy DtoH (Device -> Pageable)", 14),
           (600, 610, "mul", 15), (610, 620, "lost", 99)]
    got = trace._attribute(dev, host)
    assert got["range_calls"] == {"features": 1, "cost_volume": 1, "regularizer": 1}
    assert got["range_s"] == pytest.approx({"features": 40e-9, "cost_volume": 10e-9,
                                            "regularizer": 30e-9})
    assert got["launched_s"] == pytest.approx(90e-9)
