"""The row- and depth-sliced cost kernel K1s (`ops/kernels/sweep.py`, with a
row offset) and `sweep_cost_volume_sharded` against the JAX package's
`pallas_sweep_cost_volume_sharded` in interpret mode, on the shapes of
tests/test_pallas_sweep.py:586-613. Four gloo ranks (mesh (1, 2, 2)) run
the port's side (`parallel/rank_checks.py`) while JAX runs on the 8-device
CPU mesh of tests/conftest.py.

Tolerances: the plain version's row blocks stitch to the whole volume to
1e-6 (the same float32 arithmetic per element); the stitched rank blocks
match JAX to 1e-5 (float32 sums in another order).
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvsnet_tpu.ops.pallas.sweep import pallas_sweep_cost_volume_sharded
from mvsnet_tpu.parallel import make_mesh as jax_make_mesh
from mvsnet_tpu_torch.ops.kernels import sweep
from mvsnet_tpu_torch.parallel import rank_checks
from mvsnet_tpu_torch.parallel.launch import spawn


def _sweep_inputs():
    """tests/test_pallas_sweep.py:586-613's shapes and homographies."""
    rng = np.random.default_rng(7)
    B, H, W, C, D = 2, 16, 24, 8, 4

    def homs(rot=0.02, shift_range=12.0):
        h = np.tile(np.eye(3, dtype=np.float32), (D, 1, 1))
        c, s = np.cos(rot), np.sin(rot)
        for d in range(D):
            h[d] = [[c, -s, shift_range * (d / max(D - 1, 1) - 0.5)],
                    [s, c, 0.3 * d / max(D - 1, 1)], [1e-5, -5e-6, 1.0]]
        return h
    per_view = [np.stack([homs(), homs(rot=-0.03, shift_range=8.0)]),
                np.stack([homs(rot=0.05), homs(shift_range=4.0)]),
                np.stack([homs(rot=-0.02), homs(shift_range=2.0)])]
    out = {}
    for vm1 in (2, 3):
        ref = rng.standard_normal((B, H, W, C)).astype(np.float32)
        views = rng.standard_normal((vm1, B, H, W, C)).astype(np.float32)
        out[vm1] = (ref, views, np.stack(per_view[:vm1]))
    return out


@pytest.fixture(scope="module")
def ranks():
    """The four ranks' blocks, computed in the background while JAX runs."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cases = [("sweep", {"shape": (1, 2, 2), "volumes": _sweep_inputs()})]
        future = pool.submit(spawn, rank_checks.run, 4, "gloo", cases)
        yield lambda: [r[0] for r in future.result()]


def test_cost_volume_plain_rows_stitch():
    ref, views, homs = _sweep_inputs()[2]
    ref, views, homs = torch.from_numpy(ref[0]), torch.from_numpy(views[:, 0]), \
        torch.from_numpy(homs[:, 0])
    whole = sweep.cost_volume_plain(ref, views, homs)
    rows = [sweep.cost_volume_plain(ref[r0:r0 + 4], views, homs, row_offset=r0)
            for r0 in range(0, 16, 4)]
    np.testing.assert_allclose(torch.cat(rows, dim=1).numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("vm1", [2, 3])
def test_sharded_cost_volume_matches_jax(ranks, vm1):
    ref, views, homs = _sweep_inputs()[vm1]
    want = np.asarray(pallas_sweep_cost_volume_sharded(
        jnp.asarray(ref), jnp.asarray(views), jnp.asarray(homs),
        jax_make_mesh(4, shape=(1, 2, 2)), interpret=True))
    got = np.zeros_like(want)
    for r in ranks():
        _, d, s = r["coords"]
        block = r[vm1]
        Dl, hl = block.shape[1:3]
        got[:, d * Dl:(d + 1) * Dl, s * hl:(s + 1) * hl] = block
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
