"""Convert a JAX (orbax) training checkpoint into a checkpoint of the
PyTorch port.

    python tools/jax_ckpt_to_torch.py --model_dir <JAX model dir> \
        --out_dir <port model dir> [--regularization 3DCNN] \
        [--network_mode lite] [--ckpt_step N] [--optimizer rmsprop]

Runs where JAX and orbax are installed (never on the card machine, which
has neither). It reads `<model_dir>/<regularization>/<network_mode>/<step>`
with `mvsnet_tpu.checkpoint.restore_tree` and writes the same step under
`<out_dir>` with `mvsnet_tpu_torch.checkpoint.save_checkpoint`:
  * params and batch_stats through `mvsnet_tpu_torch.convert.state_dict_from_jax`;
  * the optimizer state, by parameter name and then by position in
    `model.parameters()`: optax rmsprop's `nu` -> the port RMSprop's
    "nu"; adam's `mu`, `nu`, `count` -> torch Adam's "exp_avg",
    "exp_avg_sq", "step"; sgd's momentum `trace` -> "momentum_buffer".
    Any other optimizer state raises;
  * the TrainState's step.
The model and optimizer configs come from the JAX run's `config.json` when
the model dir has one, else from the flags.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from mvsnet_tpu_torch import checkpoint as port_ckpt  # noqa: E402
from mvsnet_tpu_torch import train_lib  # noqa: E402
from mvsnet_tpu_torch.config import ModelConfig, TrainConfig, load_config  # noqa: E402
from mvsnet_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from mvsnet_tpu_torch.models import MVSNet  # noqa: E402

# optax state field -> the port optimizer's per-parameter state key
_SLOTS = {"rmsprop": {"nu": "nu"},
          "adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
          "momentum": {"trace": "momentum_buffer"}}


def _optax_state(opt_state, optimizer: str) -> dict:
    """The entry of optax's chained state that holds `optimizer`'s slots:
    {field: tree} (plus "count" for adam)."""
    want = set(_SLOTS[optimizer])
    entries = opt_state if isinstance(opt_state, (list, tuple)) else [opt_state]
    for entry in entries:
        if isinstance(entry, dict) and want <= set(entry):
            slots = set(entry) - {"count"}
            if slots != want:
                raise ValueError(f"optimizer state {sorted(entry)} is not optax {optimizer}'s")
            return entry
    raise ValueError(f"no optax {optimizer} state ({sorted(want)}) in the checkpoint's "
                     f"opt_state")


def convert_tree(tree: dict, mcfg: ModelConfig, tcfg: TrainConfig) -> train_lib.TrainState:
    """A restored JAX TrainState tree ({"params", "batch_stats",
    "opt_state", "step"}) -> a port `TrainState` on the CPU holding the
    same weights, statistics, optimizer state and step."""
    if tcfg.optimizer not in _SLOTS:
        raise NotImplementedError(f"no mapping for optimizer {tcfg.optimizer!r}")
    model = MVSNet(mcfg)
    model.load_state_dict(state_dict_from_jax(
        {"params": tree["params"], "batch_stats": tree.get("batch_stats") or {}}))
    state = train_lib.create_train_state(model, mcfg, tcfg, device="cpu")
    state.step = int(np.asarray(tree["step"]))

    entry = _optax_state(tree["opt_state"], tcfg.optimizer)
    index = {name: i for i, (name, _) in enumerate(model.named_parameters())}
    per_param = {i: {} for i in index.values()}
    for field, key in _SLOTS[tcfg.optimizer].items():
        slots = state_dict_from_jax({"params": entry[field]})
        if set(slots) != set(index):
            raise ValueError(f"optax {field} covers {sorted(set(slots) ^ set(index))[:4]}... "
                             "beyond or short of the model's parameters")
        for name, value in slots.items():
            per_param[index[name]][key] = value
    if tcfg.optimizer == "adam":
        count = float(np.asarray(entry["count"]))
        for slot in per_param.values():
            slot["step"] = torch.tensor(count, dtype=torch.float32)
    opt = state.optimizer.state_dict()
    state.optimizer.load_state_dict({"state": per_param, "param_groups": opt["param_groups"]})
    return state


def configs(model_dir: str, args) -> tuple:
    """(ModelConfig, TrainConfig): the JAX run's config.json when present,
    with the flags' regularization, network mode and optimizer otherwise."""
    path = os.path.join(model_dir, "config.json")
    if os.path.exists(path):
        loaded = load_config(path)
        return loaded["model"], loaded["train"]
    mcfg = ModelConfig(regularization=args.regularization, network_mode=args.network_mode)
    return mcfg, TrainConfig(optimizer=args.optimizer)


def convert(model_dir: str, out_dir: str, mcfg: ModelConfig, tcfg: TrainConfig,
            step=None) -> str:
    """Convert one checkpoint step (default the latest); returns the port
    checkpoint's directory."""
    from mvsnet_tpu import checkpoint as jax_ckpt

    reg, mode = mcfg.regularization, mcfg.network_mode
    if step is None:
        step = jax_ckpt.latest_step(model_dir, reg, mode)
        if step is None:
            raise FileNotFoundError(f"no JAX checkpoints under {model_dir}/{reg}/{mode}")
    state = convert_tree(jax_ckpt.restore_tree(model_dir, reg, mode, step), mcfg, tcfg)
    return port_ckpt.save_checkpoint(out_dir, reg, mode, step, state)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_dir", required=True, help="the JAX run's --model_dir")
    p.add_argument("--out_dir", required=True, help="the port's model dir to write")
    p.add_argument("--regularization", default="3DCNN")
    p.add_argument("--network_mode", default="lite")
    p.add_argument("--optimizer", default="rmsprop", choices=sorted(_SLOTS))
    p.add_argument("--ckpt_step", type=int, default=None, help="default: the latest")
    args = p.parse_args(argv)
    mcfg, tcfg = configs(args.model_dir, args)
    print(convert(args.model_dir, args.out_dir, mcfg, tcfg, args.ckpt_step))
    return 0


if __name__ == "__main__":
    sys.exit(main())
