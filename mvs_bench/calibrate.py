"""The readings a cell's limits are set from, at the cell's own size, on the card.

    python3 -m mvs_bench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 [--seconds 5] [--out readings.jsonl]

For each of `--seeds`, one run of the program as `run` makes it (set-up,
a window of `--seconds`, the comparison): its numbers, the lower readings.
For each of `--control-seeds`, the control: the plain reference computed
in float8 (e4m3, one scale a tensor), the precision below the
configuration's bfloat16, put in the program's place and compared with
the float32 reference by the same numbers, the upper readings. One JSON
line per reading goes to `--out` and standard output, then a summary: each
number's largest program reading and smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from mvs_bench import generate, harness
from mvs_bench.reference import common
from mvs_bench.weights import make_weights


def control_numbers(cell: harness.Cell, seed: int, device) -> dict:
    """The control's numbers on `seed`."""
    common.no_tf32()
    weights = make_weights(cell.reference.param_specs(cell.config["model"]), seed, device)
    ref = cell.reference
    pool = generate.serve_pool(cell.mix, cell.op, seed, device)
    low = ref.serve_reference(weights, pool, cell.op["max_d"], device, common.fp8)
    answers = ref.control_answers(low, range(len(pool)))
    del low
    return harness.serve_numbers(cell, weights, pool, answers, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("mvs_bench.calibrate: the readings are taken on a CUDA card", file=sys.stderr)
        return 2
    from mvsnet_tpu_torch.ops.kernels import _lib

    _lib.build_all()
    device = torch.device("cuda", 0)
    cell = harness.Cell(harness.load_spec(), args.workload)
    sink = open(args.out, "a") if args.out else None
    readings = {}

    def emit(line):
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()

    for s in [int(x) for x in args.seeds.split(",") if x]:
        result, numbers = harness.run_cell(cell, s, args.seconds, False, device,
                                           time.perf_counter())
        readings.setdefault("program", []).append(numbers)
        emit({"reading": "program", "seed": s, "numbers": numbers,
              "correct": result["correct"], "attempted": result["attempted"],
              "metrics": result["metrics"]})
        harness._free(device)
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        numbers = control_numbers(cell, s, device)
        readings.setdefault("control", []).append(numbers)
        emit({"reading": "control", "seed": s, "numbers": numbers})
        harness._free(device)
    summary = {}
    for kind, rows in readings.items():
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(r[k] for r in rows) for k in rows[0]}
    emit({"summary": summary, "workload": cell.name})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
