"""Data-pipeline prototyping harness (a copy of tools/prototype_datagen.py;
parity: mvs_data_generation/scripts/prototype_datagen.py, "not a unit
test"): pumps the port's cluster generator through its prefetching loader
and reports throughput, for tuning loader workers and prefetch against the
host's IO.

`python -m mvsnet_tpu_torch.tools.prototype_datagen <data_root> [--mode train] [--batches 50]`
"""

from __future__ import annotations

import argparse
import time

from mvsnet_tpu_torch.data import ClusterGenerator, PrefetchingLoader


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_root")
    p.add_argument("--mode", default="train", choices=["train", "val", "test", "inference"])
    p.add_argument("--batches", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--view_num", type=int, default=3)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--max_d", type=int, default=192)
    p.add_argument("--prefetch", type=int, default=2)
    args = p.parse_args(argv)

    def factory():
        return ClusterGenerator(args.data_root, args.view_num, args.width,
                                args.height, args.max_d, mode=args.mode,
                                flip_cams=False, base_image_size=32)

    loader = PrefetchingLoader(factory, batch_size=args.batch_size,
                               prefetch=args.prefetch)
    t0 = time.time()
    n = 0
    last = t0
    for batch in loader:
        n += 1
        now = time.time()
        if n % 10 == 0:
            print(f"batch {n}: {10 / (now - last):.2f} batches/s")
            last = now
        if n >= args.batches:
            break
    dt = time.time() - t0
    print(f"{n} batches in {dt:.2f}s -> {n / dt:.2f} batches/s "
          f"({n * args.batch_size / dt:.2f} samples/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
