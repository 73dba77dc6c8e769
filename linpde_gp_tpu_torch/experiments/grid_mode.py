"""Grid mode at scale: the anchored heat problem collocated on an
(``GM_NT`` x ``GM_NX``) ``TensorProductGrid`` (card 500 x 200 = 1e5
points; ``experiments/grid_mode_tpu.py`` of the JAX package).

On a tensor-product grid the observation Gram is a sum of Kronecker
products of small factor tables, so the regressor's CG matvec is the
Kronecker operator (``ops/kron_ff.kron_linop``, ``reg._gram_linop``:
O(N (n_t + n_x)) work) in place of K2's O(N^2); the Nyström blocks, the
anchor blocks and the mean stay on K1 and K2.  Measured: the first
conditioning (kernel modules built or loaded at first use), a fresh
regressor's conditioning (``condition_steady_s``), ``refit`` on the same
data (one CG solve, the factors reused), and the posterior mean's RMSE
against u* at ``GM_NQ`` random queries.

    python -m linpde_gp_tpu_torch.experiments.grid_mode [--device cpu] [--mode f64]
    GM_NT=100 GM_NX=20 python -m linpde_gp_tpu_torch.experiments.grid_mode

Settings (the JAX script's variables; card / CPU defaults): ``GM_NT``
(500 / 64), ``GM_NX`` (200 / 32), ``GM_N_IC`` (96 / 48), ``GM_N_BC`` (48 /
24), ``GM_NQ`` (8192 / 512), ``GM_NOISE`` (1e-3 / 1e-6),
``GM_ANCHOR_NOISE`` (1e-5 / 1e-12), ``GM_RANK`` (2048 / 256), ``GM_TOL``
(1e-5 / 1e-6), ``GM_MAXITER`` (512 / 4000).  The mode defaults to ``ff``
on the card and ``f64`` on the CPU; as in the JAX script, ``GM_X64=0``
takes float32 on the CPU too, and there ``GM_COMP=0`` (default 1) takes
``plain`` for ``ff``.  ``GM_DEVICE_CG`` and ``GM_BUILD`` (paths the port
does not carry) raise.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..config import resolve_device
from .common import (
    StageTimer, cli_args, heat_ibvp, heat_prior, ibvp_anchors, kernel_diagonal, log, observed_kernel, card_branch,
    reject_dropped_knobs, setting, setup, to_np, u_star,
)


def _log(msg):
    log("grid_mode", msg)


def main(device=None, mode=None, branch=None):
    """Condition, re-condition, refit and evaluate; returns the JAX
    script's payload (plus the mode).
    ``branch``: whose defaults the settings take, ``"card"`` (the JAX
    script's TPU branch) or ``"cpu"``; ``None``: the device's own.
    """
    reject_dropped_knobs("GM_DEVICE_CG", "GM_BUILD")
    with setup(device) as lgt:
        dev = resolve_device(device)
        card = card_branch(branch, dev)
        if mode is None:
            f32 = card or not setting("GM_X64", False, True, card, bool)
            mode = ("ff" if setting("GM_COMP", True, True, card, bool) else "plain") if f32 else "f64"
        n_t = setting("GM_NT", 500, 64, card)
        n_x = setting("GM_NX", 200, 32, card)
        n_ic = setting("GM_N_IC", 96, 48, card)
        n_bc = setting("GM_N_BC", 48, 24, card)
        nq = setting("GM_NQ", 8192, 512, card)
        noise_rel = setting("GM_NOISE", 1e-3, 1e-6, card, float)
        anchor_noise = setting("GM_ANCHOR_NOISE", 1e-5, 1e-12, card, float)
        rank = setting("GM_RANK", 2048, 256, card)
        tol = setting("GM_TOL", 1e-5, 1e-6, card, float)
        maxiter = setting("GM_MAXITER", 512, 4000, card)
        dtype = np.float64 if mode == "f64" else np.float32

        ibvp = heat_ibvp(lgt)
        prior = heat_prior(lgt)
        H = ibvp.pde.diffop
        # Interior collocation grid, inset as the reference's config: the
        # factor structure is what the Kronecker matvec keys on.
        tg = np.linspace(0.0 + 1e-3, 5.0, n_t).astype(dtype)
        xg = np.linspace(-1.0, 1.0, n_x + 2)[1:-1].astype(dtype)
        X_pde = lgt.domains.TensorProductGrid(tg, xg)
        n_pde = n_t * n_x
        Y_pde = np.zeros(n_pde, dtype)
        X_anchor = ibvp_anchors(n_ic, n_bc).astype(dtype)
        Y_anchor = u_star(ibvp, X_anchor).astype(dtype)
        noise_variance = noise_rel * kernel_diagonal(observed_kernel(H, prior.cov))
        _log(f"grid=({n_t},{n_x}) N={n_pde} anchors={X_anchor.shape[0]} noise={noise_variance:.3e} rank={rank} "
             f"mode={mode}")

        def condition():
            reg = lgt.IterativeGPRegressor(
                prior, X_pde, Y_pde, L=H, noise_variance=noise_variance, tol=tol, maxiter=maxiter,
                precond_rank=min(rank, n_pde // 4), mode=mode, anchor_X=X_anchor, anchor_Y=Y_anchor,
                anchor_noise=anchor_noise,
            )
            if reg._gram_linop is None:
                raise RuntimeError("the Kronecker operator is not engaged")
            return reg, to_np(reg.representer_weights[:4])

        timer = StageTimer()
        with timer("condition_first"):
            reg, w = condition()
        if not np.all(np.isfinite(w)):
            raise FloatingPointError("non-finite representer weights")
        t_first = timer.stages["condition_first"]
        iters, relres = reg.solve_info
        _log(f"conditioning (incl. first use): {t_first:.3f} s, iters={iters} relres={relres:.3e}")

        # A fresh regressor: build and solve again, the kernels loaded.
        with timer("condition_steady"):
            reg2, _ = condition()
        t_steady = timer.stages["condition_steady"]
        iters2, relres2 = reg2.solve_info
        _log(f"steady-state conditioning: {t_steady:.3f} s, iters={iters2} relres={relres2:.3e}")

        # Same geometry, new data: one CG solve, the factors reused.
        with timer("refit"):
            reg2.refit(Y_pde, anchor_Y=Y_anchor).representer_weights
        t_refit = timer.stages["refit"]
        iters3, relres3 = reg2.solve_info
        _log(f"refit (cached factors): {t_refit:.3f} s, iters={iters3} relres={relres3:.3e}")

        rng = np.random.default_rng(7)
        Xq = np.stack([rng.uniform(0.0, 5.0, nq), rng.uniform(-1.0, 1.0, nq)], axis=-1).astype(dtype)
        with timer("posterior_eval"):
            mu = reg2.mean(torch.tensor(Xq, device=dev))
        t_eval = timer.stages["posterior_eval"]
        err = to_np(mu).astype(np.float64) - u_star(ibvp, Xq)
        rmse = float(np.sqrt(np.mean(err**2)))
        max_err = float(np.max(np.abs(err)))
        _log(f"posterior eval at nq={nq}: {t_eval:.3f} s; RMSE vs analytic: {rmse:.3e}")

        payload = {
            "experiment": "grid_mode_heat1d",
            "grid": [n_t, n_x],
            "n_pde": n_pde,
            "n_anchor": int(X_anchor.shape[0]),
            "noise_variance": noise_variance,
            "condition_first_s": t_first,
            "condition_steady_s": t_steady,
            "refit_s": t_refit,
            "pcg_iters": int(iters2),
            "pcg_relres": float(relres2),
            "posterior_eval_s": t_eval,
            "rmse_vs_analytic": rmse,
            "max_err_vs_analytic": max_err,
            "mode": mode,
            "backend": dev.type,
        }
        print(json.dumps(payload))
        return payload


if __name__ == "__main__":
    args = cli_args(__doc__.splitlines()[0], mode=True)
    main(device=args.device, mode=args.mode)
