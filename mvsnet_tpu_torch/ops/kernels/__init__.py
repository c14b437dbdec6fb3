"""The port's hand-written CUDA kernels, one module per source, with their
plain PyTorch versions and launch counts."""

from __future__ import annotations

import torch

from mvsnet_tpu_torch.ops.kernels import conv, deconv, sweep, warp, wgrad

# kernels with a tensor-core and a CUDA-core edition
EDITIONED = {"conv": conv, "deconv": deconv, "wgrad": wgrad}

# kernel name -> (module, name of its launch counter)
COUNTERS = {
    "cost_volume": (sweep, "launches"),
    "cost_volume_sharded": (sweep, "launches_sharded"),
    "conv": (conv, "launches"),
    "deconv": (deconv, "launches"),
    "warp": (warp, "launches"),
    "warp_transpose": (warp, "transpose_launches"),
    "warp_sharded": (warp, "launches_sharded"),
    "warp_transpose_sharded": (warp, "transpose_launches_sharded"),
    "wgrad": (wgrad, "launches"),
}


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def edition_counts() -> dict:
    """{kernel: {edition: launches}} of the kernels with two editions."""
    return {name: dict(mod.launches_by_edition) for name, mod in EDITIONED.items()}


def reset_launch_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    for mod in EDITIONED.values():
        for e in mod.launches_by_edition:
            mod.launches_by_edition[e] = 0


def _add_counts(launches: dict, editions: dict, sign: int) -> None:
    for name, n in launches.items():
        mod, attr = COUNTERS[name]
        setattr(mod, attr, getattr(mod, attr) + sign * n)
    for name, eds in editions.items():
        for e, n in eds.items():
            EDITIONED[name].launches_by_edition[e] += sign * n


class CountedGraph:
    """`body`, calls of the kernel wrappers, captured as a CUDA graph whose
    replays count the launches they make. `body` runs `warmup` times on a
    side stream first (the wrappers build their kernels and make their tile
    plans there), then once under capture. The capture launches nothing, so
    the launches its wrapper calls counted are taken back, and each
    `replay` adds them again. A failed capture or replay raises."""

    def __init__(self, body, device, warmup: int = 2):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                body()
        torch.cuda.current_stream(device).wait_stream(side)
        before = launch_counts(), edition_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            body()
        after = launch_counts(), edition_counts()
        self.launches = {k: n - before[0][k] for k, n in after[0].items()}
        self.editions = {k: {e: n - before[1][k][e] for e, n in eds.items()}
                         for k, eds in after[1].items()}
        _add_counts(self.launches, self.editions, -1)

    def replay(self) -> None:
        self.graph.replay()
        _add_counts(self.launches, self.editions, 1)
