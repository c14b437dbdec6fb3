"""The port's hand-written CUDA kernels, one module per source, with their
plain PyTorch versions. Their wrappers count each launch in
`utils.profiling`'s counters (`profiling.LAUNCHES`)."""

from __future__ import annotations

import torch

from mvsnet_tpu_torch.utils import profiling


class CountedGraph:
    """`body`, calls of the kernel wrappers, captured as a CUDA graph whose
    replays count the launches they make. `body` runs `warmup` times on a
    side stream first (the wrappers build their kernels and make their tile
    plans there), then once under capture. The capture launches nothing, so
    what its wrapper calls counted is taken back and kept in `counts`;
    `count(replays)` adds it again for a run of `replay` calls, so that a
    caller that replays many times counts once. A failed capture or replay
    raises."""

    def __init__(self, body, device, warmup: int = 2):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                body()
        torch.cuda.current_stream(device).wait_stream(side)
        before = profiling.counters()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            body()
        self.counts = {k: n - before[k] for k, n in profiling.counters().items()
                       if k in profiling.LAUNCHES and n != before[k]}
        self.count(-1)

    def replay(self) -> None:
        self.graph.replay()

    def count(self, replays: int) -> None:
        """Add the launches of `replays` replays to the counters."""
        for name, n in self.counts.items():
            profiling.count(name, replays * n)
