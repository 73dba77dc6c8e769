"""Posterior variance at scale (``experiments/variance_tpu.py`` of the JAX
package): the heat problem conditioned at N = ``VT_N`` random points (card
1e5), then ``var`` at ``VT_NQ`` queries in blocks of ``VT_BS``, each block
one blocked CG on the ``(N, VT_BS)`` right-hand side whose matvec is one
K2 launch of the multi-column route a iteration (r > 4).

No dense oracle exists at N = 1e5 (an 80 GB Gram), so the checks are the
JAX script's: the variance is non-negative and at most the prior variance
(times 1 + 1e-3), and a second block partition (``VT_BS // 2`` on the
first ``4 VT_BS`` queries, other Krylov spaces per column) agrees with the
first (``partition_consistency_rel``, relative to the largest variance).

    python -m linpde_gp_tpu_torch.experiments.variance [--device cpu] [--mode f64]
    VT_N=32768 VT_NQ=1024 python -m linpde_gp_tpu_torch.experiments.variance

Settings (the JAX script's variables; card / CPU defaults): ``VT_N``
(100000 / 2048), ``VT_NQ`` (2048 / 128), ``VT_BS`` (256 / 32), ``VT_RANK``
(8192 / 128), ``VT_NOISE`` (1e-3), ``VT_TOL`` (1e-5 / 1e-8).  The mode
defaults to ``ff`` on the card (the JAX script is compensated on the TPU)
and ``f64`` on the CPU.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..config import resolve_device
from .common import (
    StageTimer, cli_args, default_mode, heat_kernels, heat_prior, kernel_diagonal, log, card_branch, setting, setup,
    to_np,
)


def _log(msg):
    log("variance", msg)


def main(device=None, mode=None, branch=None):
    """Condition, then the variance and its partition check; returns the
    JAX script's payload (plus the mode).
    ``branch``: whose defaults the settings take, ``"card"`` (the JAX
    script's TPU branch) or ``"cpu"``; ``None``: the device's own.
    """
    with setup(device) as lgt:
        dev = resolve_device(device)
        card = card_branch(branch, dev)
        mode = default_mode(mode, card, "ff")
        n = setting("VT_N", 100_000, 2048, card)
        nq = setting("VT_NQ", 2048, 128, card)
        bs = setting("VT_BS", 256, 32, card)
        rank = setting("VT_RANK", 8192, 128, card)
        noise_rel = setting("VT_NOISE", 1e-3, 1e-3, card, float)
        tol = setting("VT_TOL", 1e-5, 1e-8, card, float)
        dtype = np.float64 if mode == "f64" else np.float32

        prior = heat_prior(lgt)
        H = lgt.diffops.HeatOperator((2,), alpha=0.1)
        noise_variance = noise_rel * kernel_diagonal(heat_kernels(lgt)[0])

        rng = np.random.default_rng(0)
        X = np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], -1).astype(dtype)
        Y = rng.standard_normal(n).astype(dtype)
        Xq = torch.tensor(np.stack([rng.uniform(0.0, 5.0, nq), rng.uniform(-1.0, 1.0, nq)], -1).astype(dtype),
                          device=dev)

        _log(f"n={n} nq={nq} bs={bs} rank={rank} noise={noise_variance:.3e} mode={mode}")
        timer = StageTimer()
        with timer("condition"):
            reg = lgt.IterativeGPRegressor(
                prior, torch.tensor(X, device=dev), torch.tensor(Y, device=dev), L=H,
                noise_variance=noise_variance, tol=tol, maxiter=512, precond_rank=min(rank, n // 4), mode=mode,
            )
            w = to_np(reg.representer_weights[:4])
        if not np.all(np.isfinite(w)):
            raise FloatingPointError("non-finite representer weights")
        t_cond = timer.stages["condition"]
        iters, relres = reg.solve_info
        _log(f"conditioning: {t_cond:.3f} s, iters={iters} relres={relres:.3e}")

        with timer("variance"):
            var = to_np(reg.var(Xq, block_size=bs)).astype(np.float64)
        t_var = timer.stages["variance"]
        _log(f"variance at nq={nq} (bs={bs}): {t_var:.3f} s ({t_var / max(nq, 1) * 1e3:.2f} ms/query)")

        prior_var = float(prior.cov(Xq[:1].double())[0])
        if not np.all(var >= 0.0):
            raise AssertionError("negative posterior variance")
        if not np.all(var <= prior_var * (1.0 + 1e-3)):
            raise AssertionError("variance above the prior variance")

        # An independent block partition must agree.
        nq_chk = min(nq, 4 * bs)
        with timer("partition_check"):
            var_chk = to_np(reg.var(Xq[:nq_chk], block_size=bs // 2)).astype(np.float64)
        t_chk = timer.stages["partition_check"]
        rel = float(np.max(np.abs(var_chk - var[:nq_chk])) / max(np.max(var[:nq_chk]), 1e-12))
        _log(f"block-partition consistency on {nq_chk} queries: rel diff {rel:.3e} ({t_chk:.3f} s)")

        payload = {
            "experiment": "variance_large_scale",
            "n": n, "nq": nq, "block_size": bs, "rank": min(rank, n // 4),
            "noise_variance": noise_variance,
            "condition_s": t_cond, "pcg_iters": int(iters),
            "variance_s": t_var,
            "variance_s_per_query_ms": t_var / max(nq, 1) * 1e3,
            "partition_consistency_rel": rel,
            "partition_check_s": t_chk,
            "std_range": [float(np.sqrt(var.min())), float(np.sqrt(var.max()))],
            "mode": mode,
            "backend": dev.type,
        }
        print(json.dumps(payload))
        return payload


if __name__ == "__main__":
    args = cli_args(__doc__.splitlines()[0], mode=True)
    main(device=args.device, mode=args.mode)
