"""Hyperparameter search driver (a copy of tools/hp_search.py that trains
with the port: `-m mvsnet_tpu_torch.train --device ...`).

Replaces the reference's ML-Engine Bayesian tuning service
(machines/1p100_hptuning.yaml:1-26: objective val_less_one, params
base_lr/stepvalue/alpha) with an in-repo Bayesian optimizer: a numpy
Gaussian-process surrogate (RBF kernel over the unit-cube-normalized
space, log-scaled params handled in log space) with Expected-Improvement
acquisition; the first `--init_trials` trials are random (space-filling),
the rest maximize EI. `--strategy random` recovers plain random search.

`python -m mvsnet_tpu_torch.tools.hp_search --train_data_root ... --model_root ...
[--trials 6] [--device cuda:0]`. Any extra arguments are forwarded to the
train driver.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np

# the repository's search space (configs/hp_tuning.json)
DEFAULT_SPACE = Path(__file__).resolve().parents[2] / "configs" / "hp_tuning.json"


# -- search space -----------------------------------------------------------

def _to_unit(space, params):
    """Parameter dict -> point in the unit cube (log-space where declared)."""
    u = []
    for p in space["params"]:
        lo, hi, v = p["min"], p["max"], params[p["name"]]
        if p.get("scale") == "log":
            u.append((math.log(v) - math.log(lo)) / (math.log(hi) - math.log(lo)))
        else:
            u.append((v - lo) / (hi - lo))
    return np.asarray(u)


def _from_unit(space, u):
    out = {}
    for p, x in zip(space["params"], u):
        lo, hi = p["min"], p["max"]
        if p.get("scale") == "log":
            v = math.exp(math.log(lo) + float(x) * (math.log(hi) - math.log(lo)))
        else:
            v = lo + float(x) * (hi - lo)
        if p["type"] == "integer":
            v = int(round(v))
        out[p["name"]] = v
    return out


def sample_params(space, rng: random.Random):
    return _from_unit(space, [rng.random() for _ in space["params"]])


# -- GP surrogate + EI acquisition -------------------------------------------

def _rbf(a, b, length):
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / length ** 2)


def gp_posterior(X, y, Xs, length=0.25, noise=1e-4):
    """GP(0, RBF) posterior mean/std at Xs given observations (X, y).

    y is standardized internally; returns (mu, sigma) in y units.
    """
    X, y, Xs = np.asarray(X, float), np.asarray(y, float), np.asarray(Xs, float)
    mu0, s0 = y.mean(), max(y.std(), 1e-9)
    yn = (y - mu0) / s0
    K = _rbf(X, X, length) + noise * np.eye(len(X))
    Ks = _rbf(Xs, X, length)
    L = np.linalg.cholesky(K)
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
    mu = Ks @ alpha
    v = np.linalg.solve(L, Ks.T)
    var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
    return mu * s0 + mu0, np.sqrt(var) * s0


def expected_improvement(mu, sigma, best, xi=0.01):
    """EI for MAXIMIZATION."""
    z = (mu - best - xi) / sigma
    # standard normal pdf/cdf without scipy
    pdf = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
    cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2)))
    return (mu - best - xi) * cdf + sigma * pdf


def suggest(space, observed_u, observed_y, rng: random.Random,
            n_candidates: int = 2048):
    """Next point: EI argmax over random candidates (unit cube)."""
    nprng = np.random.default_rng(rng.randrange(2 ** 31))
    cands = nprng.random((n_candidates, len(space["params"])))
    mu, sigma = gp_posterior(observed_u, observed_y, cands)
    ei = expected_improvement(mu, sigma, max(observed_y))
    return _from_unit(space, cands[int(np.argmax(ei))])


# -- driver -------------------------------------------------------------------

def best_metric(metrics_path: str, metric: str):
    best = None
    try:
        with open(metrics_path) as f:
            for line in f:
                rec = json.loads(line)
                if metric in rec:
                    best = rec[metric] if best is None else max(best, rec[metric])
    except OSError:
        pass
    return best


def run_search(space, trials, objective_fn, rng, strategy="bayes",
               init_trials=3):
    """Core loop, separated from subprocess plumbing for testability.

    objective_fn(trial_index, params) -> score or None (failed trial).
    Maximizes. Returns the results list (sorted best first).
    """
    results = []
    obs_u, obs_y = [], []
    for t in range(trials):
        if strategy == "bayes" and len(obs_y) >= max(2, init_trials):
            params = suggest(space, obs_u, obs_y, rng)
        else:
            params = sample_params(space, rng)
        score = objective_fn(t, params)
        results.append({"trial": t, "params": params, "score": score})
        if score is not None and math.isfinite(score):
            obs_u.append(_to_unit(space, params))
            obs_y.append(score)
    results.sort(key=lambda r: (r["score"] is not None, r["score"]),
                 reverse=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_data_root", required=True)
    p.add_argument("--model_root", required=True)
    p.add_argument("--space", default=str(DEFAULT_SPACE))
    p.add_argument("--trials", type=int, default=None)
    p.add_argument("--strategy", default="bayes", choices=["bayes", "random"])
    p.add_argument("--init_trials", type=int, default=3,
                   help="random trials seeding the GP before EI engages")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda:0",
                   help="where each trial trains: the card, or 'cpu' for the plain path")
    args, extra = p.parse_known_args(argv)

    with open(args.space) as f:
        space = json.load(f)
    metric = space["objective"]["metric"]
    trials = args.trials or space.get("max_trials", 6)
    rng = random.Random(args.seed)

    def objective(t, params):
        model_dir = os.path.join(args.model_root, f"trial_{t}")
        cmd = [sys.executable, "-m", "mvsnet_tpu_torch.train",
               "--train_data_root", args.train_data_root,
               "--model_dir", model_dir, "--device", args.device]
        for k, v in params.items():
            cmd += [f"--{k}", str(v)]
        cmd += extra
        print(f"[trial {t}] {params}")
        rc = subprocess.call(cmd)
        score = best_metric(os.path.join(model_dir, "metrics.jsonl"), metric)
        print(f"[trial {t}] rc={rc} {metric}={score}")
        return score

    results = run_search(space, trials, objective, rng,
                         strategy=args.strategy, init_trials=args.init_trials)
    summary_path = os.path.join(args.model_root, "hp_search_results.json")
    with open(summary_path, "w") as f:
        json.dump(results, f, indent=2)
    print("best:", results[0] if results else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
