"""Preconditioner spectroscopy of the heat benchmark's Gram
(``experiments/precond_spectroscopy.py`` of the JAX package).

The exact Gram of the heat benchmark (``H k H*`` of the space-time Matérn
prior at n uniform points, ``common.heat_kernels``) is formed in float64
by K1 on the device, and flexible PCG iterations to ``--tol`` are counted
under candidate preconditioners, all in float64 torch on the device:

- none (``plain_cg``);
- Nyström at the ``--ranks`` (strided landmarks);
- ``nystrom_f32``: Nyström whose factors are built from K1 in mode
  ``plain`` (float32), the error of a float32 build;
- ``nystrom_grid``: Nyström on a regular landmark grid;
- ``ideal2l``: the exact inverse of ``K + s I`` by Cholesky, for a larger
  nugget s, the limit of a two-level scheme;
- ``two_level``: a few inner Nyström-preconditioned CG iterations on
  ``K + s I`` inside the outer flexible CG;
- ``bj``: block Jacobi on Morton-ordered point blocks, and ``bj_deflated``
  with a Nyström coarse space.

One JSON line per config (``config``, ``n``, ``noise``, ``iters``,
``relres`` and the config's extras); ``main`` returns them as a list.
``--spectrum`` also logs the eigenvalues of K (``torch.linalg.eigvalsh``)
against the nugget; the port writes no file.

    python -m linpde_gp_tpu_torch.experiments.precond_spectroscopy [--n 8192] [--configs all] [--device cpu]

The script is float64 throughout, as the JAX script's numpy is, so it takes
no mode.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..config import resolve_device
from ..ops.gram import gram, kernel_term_specs
from ..ops.linalg.pcg import landmark_indices
from ..specs import spec_diagonal
from .common import StageTimer, heat_kernels, log, setup

#: The configs ``--configs all`` runs, in order (``nystrom_f32`` and
#: ``nystrom_grid`` run when named).
ALL_CONFIGS = ("none", "nystrom", "ideal2l", "two_level", "bj", "bj_deflated")


def _log(msg):
    log("precond_spectroscopy", msg)


def fpcg(matvec, b, M=None, tol=1e-5, maxiter=2000):
    """Flexible (Polak-Ribiere) PCG from zero: ``(x, iterations, relres)``."""
    if M is None:
        M = lambda r: r  # noqa: E731
    x = torch.zeros_like(b)
    r = b.clone()
    z = M(r)
    p = z
    rz = float(r @ z)
    b_norm = float(torch.linalg.norm(b))
    thr = tol * b_norm
    k = 0
    while float(torch.linalg.norm(r)) > thr and k < maxiter:
        Ap = matvec(p)
        alpha = rz / float(p @ Ap)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z = M(r_new)
        rz_new = float(r_new @ z)
        beta = max((rz_new - float(z @ r)) / rz, 0.0)
        p = z + beta * p
        r, rz = r_new, rz_new
        k += 1
    return x, k, float(torch.linalg.norm(r)) / b_norm


def nystrom(K, m, sigma_sq, K_XZ=None, K_ZZ=None):
    """The Nyström preconditioner ``r -> (r - B (C + delta I)^{-1} B^T r) /
    delta`` of rank ``m`` (strided landmarks of ``K`` unless ``K_XZ`` and
    ``K_ZZ`` are given), floored at 100 eps of the largest eigenvalue;
    returns ``(apply, lam_m)``."""
    n = K.shape[0]
    if K_XZ is None:
        idx = landmark_indices(n, m, K.device)
        K_XZ = K[:, idx]
        K_ZZ = K_XZ[idx]
    K_XZ = K_XZ.double()
    K_ZZ = K_ZZ.double()
    eye = torch.eye(m, dtype=torch.float64, device=K.device)
    stab = torch.finfo(torch.float64).eps * float(torch.trace(K_ZZ)) * m
    L = torch.linalg.cholesky(K_ZZ + stab * eye)
    B = torch.linalg.solve_triangular(L, K_XZ.T, upper=False).T
    C0 = B.T @ B
    C0 = 0.5 * (C0 + C0.T)
    lam = torch.linalg.eigvalsh(C0)
    lam_m = max(float(lam[0]), 100.0 * torch.finfo(torch.float64).eps * float(lam[-1]))
    delta = lam_m + sigma_sq
    chol_C = torch.linalg.cholesky(C0 + delta * eye)

    def apply(r):
        w = torch.cholesky_solve((B.T @ r)[:, None], chol_C)[:, 0]
        return (r - B @ w) / delta

    return apply, lam_m


def morton_order(X: np.ndarray) -> np.ndarray:
    """The points' order along a Morton (Z) curve of 16 bits a coordinate."""
    lo, hi = X.min(axis=0), X.max(axis=0)
    u = ((X - lo) / (hi - lo) * 0xFFFF).astype(np.uint64)
    code = np.zeros(X.shape[0], np.uint64)
    for i in range(16):
        code |= ((u[:, 0] >> np.uint64(i)) & np.uint64(1)) << np.uint64(2 * i + 1)
        code |= ((u[:, 1] >> np.uint64(i)) & np.uint64(1)) << np.uint64(2 * i)
    return np.argsort(code, kind="stable")


def block_jacobi(K, X, sigma_sq, nb):
    """Additive Schwarz block Jacobi on Morton-ordered blocks of ``nb``
    points: each block's ``K + sigma^2 I`` solved by its Cholesky factor."""
    order = torch.as_tensor(morton_order(X), device=K.device)
    factors = []
    for s in range(0, K.shape[0], nb):
        ids = order[s:s + nb]
        Kb = K[ids][:, ids] + sigma_sq * torch.eye(len(ids), dtype=K.dtype, device=K.device)
        factors.append((ids, torch.linalg.cholesky(Kb)))

    def apply(r):
        out = torch.zeros_like(r)
        for ids, L in factors:
            out[ids] = torch.cholesky_solve(r[ids][:, None], L)[:, 0]
        return out

    return apply


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--noise", type=float, default=1e-3)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--maxiter", type=int, default=2000)
    ap.add_argument("--spectrum", action="store_true", help="also compute the full eigenvalue spectrum")
    ap.add_argument("--configs", type=str, default="all")
    ap.add_argument("--ranks", type=str, default="1024,2048,4096")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None, device=None) -> list[dict]:
    """Run the configs of the command line ``argv`` (``None``: the
    process's); ``device=`` overrides ``--device``."""
    args = _parser().parse_args(argv)
    device = args.device if device is None else device
    with setup(device) as lgt:
        dev = resolve_device(device)
        scale, terms = kernel_term_specs(heat_kernels(lgt)[0])
        n = args.n
        rng = np.random.default_rng(0)
        X = np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], -1)
        Y = torch.tensor(rng.standard_normal(n), device=dev)
        Xd = torch.tensor(X, device=dev)

        timer = StageTimer()
        with timer("gram"):
            K = scale * gram(terms, Xd, Xd, "f64")
            K = 0.5 * (K + K.T)
        diag = spec_diagonal((scale, terms))
        sigma_sq = args.noise * diag
        _log(f"gram built n={n} in {timer.stages['gram']:.3f} s, diag={diag:.4g}, sigma_sq={sigma_sq:.4g}")

        results = []

        def record(name, iters, relres, extra=None):
            row = {"config": name, "n": n, "noise": args.noise, "iters": iters, "relres": relres}
            row.update(extra or {})
            results.append(row)
            print(json.dumps(row), flush=True)

        if args.spectrum:
            with timer("spectrum"):
                lam = torch.linalg.eigvalsh(K).cpu().numpy()
            above = int(np.sum(lam > sigma_sq))
            _log(f"spectrum in {timer.stages['spectrum']:.3f} s: lam_max={lam[-1]:.4g} lam_min={lam[0]:.4g}; "
                 f"#eigs > sigma_sq: {above} (= {above / n:.3f} n); lam[{n // 2}]={lam[n // 2]:.4g}")
            for frac in (0.5, 0.25, 0.125, 0.0625, 0.03125):
                m = int(n * frac)
                _log(f"  lam at rank {m} (from top): {lam[-m]:.5g} -> kappa_precond ~ {lam[-m] / sigma_sq:.1f}")

        def matvec(v):
            return K @ v + sigma_sq * v

        want = ALL_CONFIGS if args.configs == "all" else tuple(args.configs.split(","))
        ranks = tuple(int(r) for r in args.ranks.split(","))
        eye = torch.eye(n, dtype=torch.float64, device=dev)

        if "none" in want:
            _, it, rr = fpcg(matvec, Y, None, args.tol, args.maxiter)
            record("plain_cg", it, rr)

        if "nystrom" in want:
            for m in ranks:
                if m > n // 2:
                    continue
                build = StageTimer()
                with build("build"):
                    M, lam_m = nystrom(K, m, sigma_sq)
                _, it, rr = fpcg(matvec, Y, M, args.tol, args.maxiter)
                record(f"nystrom_m{m}", it, rr, {"lam_m": lam_m, "lam_m_over_sigma": lam_m / sigma_sq,
                                                 "build_s": build.stages["build"]})

        if "nystrom_f32" in want:
            # The factors from K1 in float32 (mode plain) at the float32
            # points: the evaluation error of a float32 build.
            X32 = Xd.float()
            for m in ranks:
                if m > n // 2:
                    continue
                idx = landmark_indices(n, m, dev)
                K_XZ32 = scale * gram(terms, X32, X32[idx], "plain")
                M, lam_m = nystrom(K, m, sigma_sq, K_XZ=K_XZ32, K_ZZ=K_XZ32[idx])
                _, it, rr = fpcg(matvec, Y, M, args.tol, args.maxiter)
                record(f"nystrom_f32build_m{m}", it, rr, {"lam_m": lam_m})

        if "nystrom_grid" in want:
            # Landmarks on a regular grid over the domain.
            for m in (1024, 2048, 4096):
                if m > n // 2:
                    continue
                mt = int(np.sqrt(m / 2.0) * np.sqrt(5.0 / 2.0))
                mx = max(1, m // max(mt, 1))
                tg = np.linspace(0.0, 5.0, mt + 2)[1:-1]
                xg = np.linspace(-1.0, 1.0, mx + 2)[1:-1]
                Z = torch.tensor(np.stack(np.meshgrid(tg, xg, indexing="ij"), -1).reshape(-1, 2), device=dev)
                K_XZ = scale * gram(terms, Xd, Z, "f64")
                K_ZZ = scale * gram(terms, Z, Z, "f64")
                M, lam_m = nystrom(K, Z.shape[0], sigma_sq, K_XZ=K_XZ, K_ZZ=0.5 * (K_ZZ + K_ZZ.T))
                _, it, rr = fpcg(matvec, Y, M, args.tol, args.maxiter)
                record(f"nystrom_grid_m{Z.shape[0]}", it, rr, {"lam_m": lam_m})

        if "ideal2l" in want:
            for s2p_rel in (0.3, 0.1, 0.03):
                L = torch.linalg.cholesky(K + s2p_rel * diag * eye)
                _, it, rr = fpcg(matvec, Y, lambda r, L=L: torch.cholesky_solve(r[:, None], L)[:, 0], args.tol,
                                 args.maxiter)
                record(f"ideal2l_s{s2p_rel:g}", it, rr)
                del L

        if "two_level" in want:
            for s2p_rel, k_inner in ((0.03, 5), (0.03, 10), (0.1, 10)):
                s2p = s2p_rel * diag
                Mi, _ = nystrom(K, min(2048, n // 4), s2p)

                def M(r, s2p=s2p, Mi=Mi, k_inner=k_inner):
                    return fpcg(lambda v: K @ v + s2p * v, r, Mi, tol=1e-12, maxiter=k_inner)[0]

                _, it, rr = fpcg(matvec, Y, M, args.tol, args.maxiter)
                record(f"two_level_s{s2p_rel:g}_k{k_inner}", it, rr)

        if "bj" in want:
            for nb in (512, 1024):
                _, it, rr = fpcg(matvec, Y, block_jacobi(K, X, sigma_sq, nb), args.tol, args.maxiter)
                record(f"block_jacobi_nb{nb}", it, rr)

        if "bj_deflated" in want:
            M_as = block_jacobi(K, X, sigma_sq, 1024)
            for m in (1024, 2048):
                if m > n // 2:
                    continue
                Q, _ = torch.linalg.qr(K[:, landmark_indices(n, m, dev)])
                A_c = Q.T @ (K @ Q) + sigma_sq * (Q.T @ Q)
                Lc = torch.linalg.cholesky(0.5 * (A_c + A_c.T))

                def M(r, Q=Q, Lc=Lc):
                    return M_as(r) + Q @ torch.cholesky_solve((Q.T @ r)[:, None], Lc)[:, 0]

                _, it, rr = fpcg(matvec, Y, M, args.tol, args.maxiter)
                record(f"bj1024_deflated_m{m}", it, rr)

        _log("done: " + json.dumps(results))
        return results


if __name__ == "__main__":
    main()
