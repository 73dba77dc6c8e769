"""Dense scaling sweep: Gram assembly, Cholesky and solve stage times
across problem sizes (``experiments/scaling_tpu.py`` of the JAX package).

The Gram is ``H k H*`` of the heat benchmark (``common.heat_kernels``) at
n uniform space-time points, by K1 (``ops/gram.gram_matrix``); then
``cholesky(G + 1e-5 I)`` and the solve against one right-hand side by the
factor, each stage timed apart: the least of ``reps`` host-clock runs after
a warm-up, each synchronized.  One JSON line per size, then the whole
table.

    python -m linpde_gp_tpu_torch.experiments.scaling [sizes ...] [--device cpu] [--mode f64]

The mode defaults to ``plain`` on the card (the JAX script runs float32 on
the TPU) and ``f64`` on the CPU.  A float32 Cholesky that breaks down
raises ``torch.linalg.LinAlgError`` (the JAX script's NaN weights fail its
finiteness check).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..config import mode_dtype, resolve_device
from ..ops.gram import gram_matrix
from .common import best_of, cli_args, default_mode, heat_kernels, card_branch, setup

SIZES = (4096, 8192, 16384, 32768)
#: Diagonal shift of the Gram before its Cholesky factorization.
JITTER = 1e-5


def stages(k_hh, mode: str):
    """The three timed stages: ``gram(X)``, ``chol(G)`` and ``solve(L, y)``."""

    def gram(X):
        return gram_matrix(k_hh, X, None, mode)

    def chol(G):
        A = G.clone()
        A.diagonal().add_(JITTER)
        return torch.linalg.cholesky(A)

    def solve(L, y):
        return torch.cholesky_solve(y[:, None], L)[:, 0]

    return gram, chol, solve


def main(sizes=SIZES, reps: int = 3, device=None, mode=None, branch=None):
    """Time the stages at each size; returns the JAX script's final payload
    ``{"experiment": "scaling_tpu", "results": [...]}`` (plus the mode).
    ``branch``: whose defaults the settings take, ``"card"`` (the JAX
    script's TPU branch) or ``"cpu"``; ``None``: the device's own.
    """
    with setup(device) as lgt:
        dev = resolve_device(device)
        mode = default_mode(mode, card_branch(branch, dev), "plain")
        dtype = mode_dtype(mode)
        k_hh, _ = heat_kernels(lgt)
        gram, chol, solve = stages(k_hh, mode)
        rng = np.random.default_rng(0)
        results = []
        for n in sizes:
            X = torch.tensor(np.stack([rng.uniform(0, 5, n), rng.uniform(-1, 1, n)], -1), device=dev).to(dtype)
            y = torch.tensor(rng.standard_normal(n), device=dev).to(dtype)
            t_gram, G = best_of(lambda: gram(X), reps)
            t_chol, L = best_of(lambda: chol(G), reps)
            t_solve, w = best_of(lambda: solve(L, y), reps)
            if not bool(torch.isfinite(w[:8]).all()):
                raise FloatingPointError(f"non-finite weights at n = {n} in mode {mode}")
            entry = {"n": n, "gram_s": t_gram, "chol_s": t_chol, "solve_s": t_solve,
                     "total_s": t_gram + t_chol + t_solve}
            results.append(entry)
            print(json.dumps(entry), flush=True)
            del G, L, w
        payload = {"experiment": "scaling_tpu", "results": results, "mode": mode}
        print(json.dumps(payload))
        return payload


if __name__ == "__main__":
    args = cli_args(__doc__.splitlines()[0], ints=None, mode=True)
    main(tuple(args.ints) or SIZES, device=args.device, mode=args.mode)
