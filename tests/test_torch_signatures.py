"""A call to the port in JAX's positional order never binds a JAX argument
to a different port parameter.

Both packages are read by their syntax trees (neither is imported, so
this costs well under a second). For each module that the port has under
the JAX package's path (`mvsnet_tpu/x.py` -> `mvsnet_tpu_torch/x.py`,
and the repository's `tools/` and `scripts/` -> the port's), every
public function and method present in both is compared by its positional
parameters:
  * for every number of positional arguments that a JAX call may pass
    (from JAX's required ones to all of them), the port either binds each
    to the parameter of the same name (or of a name listed in `RENAMED`,
    which means the same thing), or raises TypeError (too many, or a
    required port parameter left out);
  * a pair whose positional parameters are not the same list (after the
    renames) stands in `FLAX`, where JAX's extra argument is flax's or
    optax's and has no counterpart in the port, or in `PORT_TAIL`, where
    the port adds parameters after JAX's last, which a JAX-order call
    never reaches; each with its reason;
  * each entry of those lists still names a pair that differs.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# "<pre-port file>:<qualified name>" -> {JAX's name: the port's}
RENAMED = {
    "mvsnet_tpu/checkpoint.py:restore_checkpoint": {"state_template": "state"},
    "mvsnet_tpu/tf_import.py:import_tf_vars": {"variables": "template"},
}

# JAX's extra positional parameters are flax's or optax's idioms; a call in
# JAX's order raises TypeError in the port
FLAX = {
    "mvsnet_tpu/models/mvsnet.py:apply_forward_3dcnn":
        "`variables`: the port's model holds its weights",
    "mvsnet_tpu/models/mvsnet.py:MVSNet.forward_3dcnn":
        "`training`: flax's per-call mode; the port's module has train()/eval()",
    "mvsnet_tpu/models/mvsnet.py:MVSNet.refine":
        "`training`: flax's per-call mode; the port's module has train()/eval()",
    "mvsnet_tpu/train_lib.py:compute_loss":
        "`params`, `batch_stats`: the port's model holds them; `training` is keyword-only",
    "mvsnet_tpu/train_lib.py:create_train_state":
        "`rng`, `sample_batch`: flax's init; the port's model is built with its weights",
    "mvsnet_tpu/train_lib.py:make_train_step":
        "`donate`: jit's buffer donation; the port's step updates the state in place",
    "mvsnet_tpu/train.py:make_vis_writer":
        "`mcfg`: JAX's writer applies flax variables by config; the port's model carries it",
    "mvsnet_tpu/train.py:make_loader":
        "`workers`: the port's driver gives the worker count to `make_batches`, which "
        "must read with one producer inside a process group",
}

# the port's own parameters after JAX's last positional one
PORT_TAIL = {
    "mvsnet_tpu/fusion.py:fuse_session": "`device`: the card or the CPU",
    "mvsnet_tpu/losses.py:gaussian_loss": "`batch_sum`: the sums over 'data' ranks",
    "mvsnet_tpu/losses.py:gradient_loss": "`batch_sum`: the sums over 'data' ranks",
    "mvsnet_tpu/losses.py:less_one_percentage": "`batch_sum`: the sums over 'data' ranks",
    "mvsnet_tpu/losses.py:less_three_percentage": "`batch_sum`: the sums over 'data' ranks",
    "mvsnet_tpu/losses.py:power_loss": "`batch_sum`: the sums over 'data' ranks",
    "mvsnet_tpu/losses.py:mvsnet_regression_loss": "`batch_sum`: the sums over 'data' ranks",
    "mvsnet_tpu/losses.py:mvsnet_classification_loss":
        "`batch_sum`, `rows`, `gather`: the sums over 'data' and a rank's rows over 'space'",
    "mvsnet_tpu/models/mvsnet.py:MVSNet.forward_gru_wta": "`with_regs`: the sweep's regs too",
    "mvsnet_tpu/models/mvsnet.py:MVSNet.forward_prob_recurrent":
        "`blocks`: this rank's rows over 'space' (the blocked train step)",
    "mvsnet_tpu/ops/warp.py:projected_coords": "`row_offset`: a block of rows' first row",
    "mvsnet_tpu/tf_import.py:import_tf_vars":
        "`transposed`: the state dict's transposed-conv kernels, found by module type",
    "mvsnet_tpu/train_lib.py:lr_schedule":
        "`step`, required: JAX returns an optax schedule, the port the rate at a step",
    "mvsnet_tpu/train_lib.py:make_optimizer":
        "`params`, required: JAX returns an optax transformation, the port an optimizer "
        "over the parameters it updates",
    "scripts/utils.py:fuse": "`device`: the card or the CPU",
    "scripts/utils.py:test": "`device`: the card or the CPU",
}


def _module_pairs():
    pairs = [(p, ROOT / "mvsnet_tpu_torch" / p.relative_to(ROOT / "mvsnet_tpu"))
             for p in sorted((ROOT / "mvsnet_tpu").rglob("*.py"))]
    for d in ("tools", "scripts"):
        pairs += [(p, ROOT / "mvsnet_tpu_torch" / d / p.name)
                  for p in sorted((ROOT / d).glob("*.py"))]
    return [(str(p.relative_to(ROOT)), q) for p, q in pairs if q.exists()]


PAIRS = _module_pairs()


def _public_defs(path):
    """{qualified name: ast function} of the module's public functions and
    the public methods (and __init__) of its public classes."""
    out = {}

    def walk(body, prefix):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not node.name.startswith("_") or node.name == "__init__":
                    out[prefix + node.name] = node
            elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                walk(node.body, prefix + node.name + ".")
    walk(ast.parse(path.read_text()).body, "")
    return out


def _positional(fn, method):
    """(names, required count, takes *args) of fn's positional parameters,
    without self or cls."""
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args]
    decorators = {getattr(d, "id", getattr(d, "attr", None)) for d in fn.decorator_list}
    if method and "staticmethod" not in decorators:
        names = names[1:]
    return names, len(names) - len(a.defaults), a.vararg is not None


def _signatures(jax_file, port_file):
    jax_defs, port_defs = _public_defs(ROOT / jax_file), _public_defs(port_file)
    for name in sorted(set(jax_defs) & set(port_defs)):
        method = "." in name
        yield (f"{jax_file}:{name}", _positional(jax_defs[name], method),
               _positional(port_defs[name], method))


@pytest.mark.parametrize("jax_file,port_file", PAIRS, ids=[p for p, _ in PAIRS])
def test_jax_order_calls_bind_or_raise(jax_file, port_file):
    for key, (jax_names, jax_required, _), (port_names, port_required, port_var) in \
            _signatures(jax_file, port_file):
        renamed = RENAMED.get(key, {})
        meaning = [renamed.get(n, n) for n in jax_names]
        for k in range(jax_required, len(jax_names) + 1):
            if (k > len(port_names) and not port_var) or k < port_required:
                continue                                  # TypeError
            wrong = [(j, p) for j, p in zip(meaning[:k], port_names[:k]) if j != p]
            assert not wrong, (f"{key}: a JAX-order call with {k} positional arguments "
                               f"binds JAX's {wrong[0][0]!r} to the port's {wrong[0][1]!r}")
        same = meaning == port_names
        tail = not same and port_names[:len(meaning)] == meaning
        assert same or key in (PORT_TAIL if tail else FLAX), (
            f"{key}: JAX {jax_names}, port {port_names}: take JAX's order or list the "
            f"pair with its reason in {'PORT_TAIL' if tail else 'FLAX'}")
        assert not (same and (key in FLAX or key in PORT_TAIL)), f"{key} no longer differs"


def test_listed_differences_name_real_pairs():
    keys = {key for jax_file, port_file in PAIRS
            for key, _, _ in _signatures(jax_file, port_file)}
    for listed in (RENAMED, FLAX, PORT_TAIL):
        assert set(listed) <= keys, sorted(set(listed) - keys)
    for key, renames in RENAMED.items():
        jax_file, name = key.split(":")
        defs = _public_defs(ROOT / jax_file)
        assert set(renames) <= set(_positional(defs[name], "." in name)[0]), key
