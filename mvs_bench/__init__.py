"""The benchmark of `mvsnet_tpu_torch` on NVIDIA H100s.

`python3 -m mvs_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json`: its configuration
(`configs/<name>.json`), its traffic mix (`traffic/<name>.json`), the
limits of its comparison with the plain reference (`limits/<cell>.json`)
and its metrics (`metrics/<name>.py`), each found by name.
"""
