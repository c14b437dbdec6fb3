"""Host ms a map waited in `AsyncOutputWriter`'s queue, from `write` to
the start of its job on the writer's thread: the program's `writer.wait_s`
over its `writer.jobs`, as counted while the traced window's profiler
recorded."""

from mvs_bench.spans import traced_counter


def read(ctx):
    jobs = traced_counter("writer.jobs")
    waited = traced_counter("writer.wait_s")
    return 1e3 * waited / jobs if jobs and waited is not None else None
