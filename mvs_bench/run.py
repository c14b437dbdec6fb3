"""One run of one benchmark cell on the card this process starts on.

    python3 -m mvs_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with a trace `breakdown`, and
last `checks`, each number compared with the reference beside its limit;
the same numbers are the last lines of standard error, after a line of
every number the comparison gives, compared or not. Exits non-zero
without a result when there is no CUDA card (or fewer than the cell asks
for), when the program or its kernels cannot be loaded, or when JAX or the
JAX package was loaded into this process.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402


def build_parser():
    p = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from mvs_bench import harness

    spec = harness.load_spec()
    cell = harness.Cell(spec, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"mvs_bench: {args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from mvsnet_tpu_torch.ops.kernels import _lib

    _lib.build_all()
    try:
        result, numbers = harness.run_cell(cell, args.seed % 2 ** 63, args.seconds,
                                     bool(args.trace), torch.device("cuda", 0), T_START)
    except harness.ForbiddenImport as e:
        print(f"mvs_bench: {e}", file=sys.stderr)
        return 3
    found = harness.forbidden_modules(list(sys.modules))
    if found:
        print("mvs_bench: modules of JAX or of the JAX package were loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print("numbers " + json.dumps(numbers), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
        if not math.isfinite(c["value"]):
            c["value"] = None           # JSON has no infinity: a missing number failed
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
