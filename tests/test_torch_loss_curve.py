"""The port's training loop tracks the JAX package's: five adam steps from
the same initial weights (the JAX init, converted) on the same
`ClusterGenerator` batches, the port's `train_lib` against
`mvsnet_tpu.train_lib` ("ultralite", 64x64, D=8, float32, adam at the
default rate 1e-3, "original" loss, as `tests/test_train.py` trains).

Tolerances. The first step's loss is the forward alone: 1e-4 relative, as
`tests/test_torch_train.py` holds one step. Every later loss follows
updates from gradients that agree to about 1e-3 of each leaf's largest
entry (`tests/test_torch_train.py`), and adam's first updates are close to
lr * sign(g), so a parameter whose gradient is near zero can move by up to
2 lr the other way. The curve amplifies such differences step by step: on
the port alone, a 1e-7 perturbation of the initial weights moves the
losses of steps 2-5 by 1e-5, 2e-4, 1.6e-3 and 4e-3 relative, and JAX and
the port differ by 1.6e-6, 5.9e-5, 8.4e-4 and 1.8e-2 (CPU runs of this
test's setup). Each later step has its own limit, above its reading:
1e-4, 1e-3, 1e-2 and 5e-2 relative. Two planted faults show that the
limits see a wrong update: no update at all (rate 0) is off by 9.7e-2,
0.24, 0.39 and 0.56 at steps 2-5, half the rate by 7.5e-3, 7.2e-2, 0.13
and 0.29, and each is rejected at every later step. The curve must also
fall on both sides.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))
from synthetic_session import make_dataset  # noqa: E402

from mvsnet_tpu import train_lib as jax_train  # noqa: E402
from mvsnet_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from mvsnet_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from mvsnet_tpu.data import ClusterGenerator as JaxGenerator  # noqa: E402
from mvsnet_tpu.data import batch_iterator as jax_batches  # noqa: E402
from mvsnet_tpu.models import MVSNet as JaxMVSNet  # noqa: E402
from mvsnet_tpu_torch import train_lib  # noqa: E402
from mvsnet_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from mvsnet_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from mvsnet_tpu_torch.data import ClusterGenerator, batch_iterator  # noqa: E402
from mvsnet_tpu_torch.models import MVSNet  # noqa: E402

TINY = dict(view_num=3, max_d=8, width=64, height=64, network_mode="ultralite",
            compute_dtype="float32")
TRAIN = dict(optimizer="adam", base_lr=1e-3, loss_type="original", grad_loss=False)
GEN = dict(view_num=3, image_width=64, image_height=64, depth_num=8, base_image_size=32,
           mode="train", flip_cams=False)
STEPS = 5
# relative limit of each later step's loss (steps 2-5)
LIMITS = {1: 1e-4, 2: 1e-3, 3: 1e-2, 4: 5e-2}
# planted faults in the port's update, which the limits must reject
FAULTS = {"no_update": dict(base_lr=0.0), "half_rate": dict(base_lr=TRAIN["base_lr"] / 2)}


@pytest.fixture(scope="module")
def curves(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_dataset(root, n_sessions=1, split="train", n_images=5)
    batches = list(jax_batches(JaxGenerator(root, **GEN).iterate_once(), 1))[:STEPS]
    port_batches = list(batch_iterator(ClusterGenerator(root, **GEN).iterate_once(), 1))
    assert len(batches) == STEPS
    for a, b in zip(batches, port_batches):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))

    cfg, tcfg = JaxModelConfig(**TINY), JaxTrainConfig(**TRAIN)
    model = JaxMVSNet(cfg)
    images, cams = jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1])
    ds, di, _ = jax_train.batch_depth_params(cams)
    init = jax.jit(lambda key: model.init(key, images, cams, ds, di, training=True))
    v = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    state = jax_train.TrainState.create(apply_fn=model.apply, params=v["params"],
                                        batch_stats=v["batch_stats"],
                                        tx=jax_train.make_optimizer(tcfg))
    step = jax_train.make_train_step(model, cfg, tcfg, donate=False)
    want = []
    for b in batches:
        state, m = step(state, b)
        want.append(float(m["loss"]))

    def port_curve(**train):
        pcfg, ptcfg = ModelConfig(**TINY), TrainConfig(**{**TRAIN, **train})
        pmodel = MVSNet(pcfg)
        pmodel.load_state_dict(state_dict_from_jax(v))
        pstate = train_lib.create_train_state(pmodel, pcfg, ptcfg, device="cpu")
        pstep = train_lib.make_train_step(pmodel, pcfg, ptcfg)
        return np.array([pstep(pstate, b)[1]["loss"].item() for b in port_batches[:STEPS]])

    faults = {name: port_curve(**train) for name, train in FAULTS.items()}
    return port_curve(), np.array(want), faults


def test_first_step_loss(curves):
    got, want, _ = curves
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)


@pytest.mark.parametrize("step", range(1, STEPS))
def test_later_losses_track_jax(curves, step):
    got, want, _ = curves
    np.testing.assert_allclose(got[step], want[step], rtol=LIMITS[step])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_limits_reject_a_wrong_update(curves, fault):
    _, want, faults = curves
    off = np.abs(faults[fault] - want) / np.abs(want)
    for step, limit in LIMITS.items():
        assert off[step] > limit, (fault, step, off[step])


def test_both_curves_fall(curves):
    got, want, _ = curves
    assert got[-1] < got[0] and want[-1] < want[0]
