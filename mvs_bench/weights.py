"""Seeded parameters for a configuration, made on the device in two calls.

The names, shapes and kinds come from the configuration's plain reference
(`param_specs`), never from the program: the same dict goes to the
program (as a state dict) and to the reference.
"""

from __future__ import annotations

import math

import torch


def make_weights(specs, seed: int, device) -> dict:
    """{name: float32 tensor on `device`}: conv kernels lecun-normal
    (std 1/sqrt(fan-in)), conv biases and norm shifts N(0, 0.1^2) and
    N(0, 0.2^2), norm scales and running variances U(0.5, 1.5), running
    means N(0, 0.2^2). One normal and one uniform draw of the total size
    from a generator on the device seeded with `seed`."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        z, u = normal[at:at + n].reshape(shape), uniform[at:at + n].reshape(shape)
        at += n
        if kind == "kernel":
            out[name] = z / math.sqrt(math.prod(shape[:-1]))
        elif kind in ("scale", "var"):
            out[name] = 0.5 + u
        elif kind == "bias":
            out[name] = 0.1 * z
        elif kind in ("shift", "mean"):
            out[name] = 0.2 * z
        else:
            raise ValueError(f"unknown parameter kind {kind!r} of {name}")
    return out
