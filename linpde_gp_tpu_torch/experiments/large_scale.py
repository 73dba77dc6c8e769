"""Heat IBVP accuracy at scale: the anchored heat problem conditioned at
N = ``LS_N`` collocation points (card 1e5), its posterior mean against
the analytic solution (``experiments/large_scale_tpu.py`` of the JAX
package).

The space-time Matérn prior (``common.heat_prior``) is conditioned on H u
= 0 at N uniform random points of [0, 5] x [-1, 1] jointly with the
initial and boundary values of u* at ``LS_N_IC`` + 2 x ``LS_N_BC``
anchors (``IterativeGPRegressor(..., anchor_X=, anchor_Y=)``: block
elimination, CG on the Schur complement, a Nyström preconditioner of rank
``min(LS_RANK, N // 4)``), with PDE noise ``LS_NOISE`` x k_HH(0); the RMSE
and largest error of the mean against u* at ``LS_NQ`` random queries.

Where the anchor Cholesky breaks down (``torch.linalg.LinAlgError``) or the
weights come out non-finite, the anchor noise is raised tenfold and the
conditioning retried, up to four attempts, as the JAX script does; each
retry is logged on stderr and the payload holds the final ``anchor_noise``.

    python -m linpde_gp_tpu_torch.experiments.large_scale [--device cpu] [--mode f64]
    LS_N=32768 python -m linpde_gp_tpu_torch.experiments.large_scale

Settings (the JAX script's variables; card / CPU defaults): ``LS_N``
(100000 / 2048), ``LS_N_IC`` (96 / 64), ``LS_N_BC`` (48 / 32), ``LS_NQ``
(8192 / 512), ``LS_NOISE`` (1e-3 / 1e-10), ``LS_ANCHOR_NOISE`` (1e-5 /
1e-12), ``LS_RANK`` (4096 / 256), ``LS_TOL`` (1e-5 / 1e-11),
``LS_MAXITER`` (512 / 4000).  The mode defaults to ``ff`` on the card
(``LS_COMPENSATED=0``: ``plain``) and ``f64`` on the CPU.  ``LS_HOST_CG``,
``LS_DEVICE_CG`` and ``LS_BUILD`` (paths the port does not carry) raise.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..config import resolve_device
from .common import (
    StageTimer, cli_args, default_mode, heat_ibvp, heat_prior, ibvp_anchors, kernel_diagonal, log, observed_kernel, card_branch,
    reject_dropped_knobs, setting, setup, to_np, u_star,
)

#: Conditioning attempts, the anchor noise raised tenfold after each failure.
ATTEMPTS = 4


def _log(msg):
    log("large_scale", msg)


def main(device=None, mode=None, branch=None):
    """Condition and evaluate; returns the JAX script's payload (plus the
    final ``anchor_noise`` and the mode).
    ``branch``: whose defaults the settings take, ``"card"`` (the JAX
    script's TPU branch) or ``"cpu"``; ``None``: the device's own.
    """
    reject_dropped_knobs("LS_HOST_CG", "LS_DEVICE_CG", "LS_BUILD")
    with setup(device) as lgt:
        dev = resolve_device(device)
        card = card_branch(branch, dev)
        mode = default_mode(mode, card, "ff" if setting("LS_COMPENSATED", True, True, card, bool) else "plain")
        n_pde = setting("LS_N", 100_000, 2048, card)
        n_ic = setting("LS_N_IC", 96, 64, card)
        n_bc = setting("LS_N_BC", 48, 32, card)
        nq = setting("LS_NQ", 8192, 512, card)
        noise_rel = setting("LS_NOISE", 1e-3, 1e-10, card, float)
        anchor_noise = setting("LS_ANCHOR_NOISE", 1e-5, 1e-12, card, float)
        rank = setting("LS_RANK", 4096, 256, card)
        tol = setting("LS_TOL", 1e-5, 1e-11, card, float)
        maxiter = setting("LS_MAXITER", 512, 4000, card)
        dtype = np.float64 if mode == "f64" else np.float32

        ibvp = heat_ibvp(lgt)
        prior = heat_prior(lgt)
        H = ibvp.pde.diffop

        rng = np.random.default_rng(0)
        X_pde = np.stack([rng.uniform(0.0, 5.0, n_pde), rng.uniform(-1.0, 1.0, n_pde)], axis=-1).astype(dtype)
        Y_pde = np.zeros(n_pde, dtype)
        X_anchor = ibvp_anchors(n_ic, n_bc).astype(dtype)
        Y_anchor = u_star(ibvp, X_anchor).astype(dtype)
        noise_variance = noise_rel * kernel_diagonal(observed_kernel(H, prior.cov))
        _log(f"n_pde={n_pde} anchors={X_anchor.shape[0]} nq={nq} noise={noise_variance:.3e} rank={rank} mode={mode}")

        timer = StageTimer()
        with timer("condition"):
            for _attempt in range(ATTEMPTS):
                try:
                    reg = lgt.IterativeGPRegressor(
                        prior, torch.tensor(X_pde, device=dev), torch.tensor(Y_pde, device=dev), L=H,
                        noise_variance=noise_variance, tol=tol, maxiter=maxiter,
                        precond_rank=min(rank, n_pde // 4), mode=mode, anchor_X=X_anchor, anchor_Y=Y_anchor,
                        anchor_noise=anchor_noise,
                    )
                    w = to_np(reg.representer_weights[:4])
                    iters0, relres0 = reg.solve_info
                    # iters 0 with a non-finite relres is a NaN right-hand side
                    # (weights left at the finite zero start); a finite relres
                    # at iters 0 is a right-hand side already below tol.
                    ok = bool(np.all(np.isfinite(w)) and np.isfinite(relres0) and (iters0 > 0 or relres0 <= tol))
                    why = "non-finite weights"
                except torch.linalg.LinAlgError as exc:
                    ok, why = False, f"LinAlgError ({exc})"
                if ok:
                    break
                anchor_noise *= 10.0
                _log(f"{why}; retrying with anchor_noise={anchor_noise:g}")
        if not ok:
            raise FloatingPointError(f"conditioning failed {ATTEMPTS} times: {why}")
        t_condition = timer.stages["condition"]
        iters, relres = reg.solve_info
        _log(f"conditioned in {t_condition:.3f} s (incl. first use): iters={iters} relres={relres:.3e}")

        Xq = np.stack([rng.uniform(0.0, 5.0, nq), rng.uniform(-1.0, 1.0, nq)], axis=-1).astype(dtype)
        with timer("posterior_eval"):
            mean_q = reg.mean(torch.tensor(Xq, device=dev))
        t_eval = timer.stages["posterior_eval"]
        err = to_np(mean_q).astype(np.float64) - u_star(ibvp, Xq)
        rmse = float(np.sqrt(np.mean(err**2)))
        max_err = float(np.max(np.abs(err)))
        _log(f"posterior mean at nq={nq}: {t_eval:.3f} s; RMSE={rmse:.3e} max|err|={max_err:.3e}")

        payload = {
            "experiment": "heat1d_accuracy_large_scale",
            "n_pde": n_pde,
            "n_anchor": int(X_anchor.shape[0]),
            "noise_variance": noise_variance,
            "compensated": mode == "ff",
            "pcg_iters": iters,
            "pcg_relres": relres,
            "condition_s": t_condition,
            "rmse_vs_analytic": rmse,
            "max_err_vs_analytic": max_err,
            "anchor_noise": anchor_noise,
            "mode": mode,
            "posterior_eval_s": t_eval,
            "backend": dev.type,
        }
        print(json.dumps(payload))
        return payload


if __name__ == "__main__":
    args = cli_args(__doc__.splitlines()[0], mode=True)
    main(device=args.device, mode=args.mode)
