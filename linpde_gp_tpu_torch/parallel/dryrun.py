"""Multi-rank dry run of the parallel layer, and the per-rank cases its
tests hold against the JAX package.

:func:`dryrun_multichip` is the port of ``__graft_entry__.dryrun_multichip``
(``__graft_entry__.py:117-392``): one full sharded conditioning step (the
rows of a 1-D Poisson collocation Gram on each rank, the distributed
factorization through the layout router, the distributed solve, a Schur
extension, the posterior mean and std against the distributed factor,
sharded query evaluation on the dense engine, the gram-free mesh CG and
its variance, and a banded Wendland mesh CG), every result held to a
dense float64 oracle of the port's own.  It runs on the world it is called
in, or spawns ``n_devices`` ranks (``launch.spawn``) when there is none
and more than one is asked for.

:func:`rank_cases` runs named cases (:data:`CASES`) on one rank of a world
and returns their results as numpy arrays: ``tests/test_torch_parallel.py``
spawns it on worlds of 1, 2 and 4 ranks and compares every rank's results
with the JAX package's ``parallel/`` on its virtual CPU mesh.  It lives
here, in a module without JAX, because spawned ranks import the module of
the function they run.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import config
from ..ops.gram import gram_matrix, gram_matvec, kernel_term_specs
from .cholesky import distributed_chol_solve, distributed_cholesky, distributed_cholesky_2d, distributed_tri_solve
from .extend import DistributedCholFactor
from .gram import gather_gram, sharded_gram
from .iterative import DistributedIterativeGPRegressor, distributed_gram_matvec
from .mesh import make_mesh, replicated, row_sharding
from .posterior import sharded_posterior_eval
from .solve import DistributedConditioner, _factorize, distributed_condition


def _np(t):
    if isinstance(t, tuple):
        return tuple(_np(x) for x in t)
    return t.detach().to("cpu", torch.float64).numpy() if isinstance(t, torch.Tensor) else t


# -- cases -------------------------------------------------------------------------


def _factor(mesh, A, nb, layout, unroll=None):
    if layout == "contiguous":
        return distributed_cholesky(A, mesh=mesh, block_size=nb, unroll=unroll)
    return _factorize(A, mesh=mesh, block_size=nb, layout=layout)


def case_mesh(mesh, x):
    """The mesh's shape and this rank's coordinates; ``x``'s rows split over
    the ranks (:func:`row_sharding`, gathered back) and rank 0's ``x`` on
    every rank (:func:`replicated`)."""
    rows = row_sharding(mesh, x)
    mine = torch.as_tensor(x) + mesh.rank  # differs per rank: replicated() must give rank 0's
    return {"shape": [mesh.shape[a] for a in mesh.axis_names], "coords": [mesh.coords[a] for a in mesh.axis_names],
            "rows": mesh.all_gather(rows), "replicated": replicated(mesh, mine)}


def case_sharded_gram(mesh, kernel, X0, X1):
    return gather_gram(sharded_gram(kernel, X0, X1, mesh=mesh), mesh)


def case_cholesky(mesh, A, nb, layout, unroll=None, b=None, B=None):
    """The factor (gathered), and with ``b`` / ``B`` the solves against it:
    ``chol_solve(b)``, ``tri_solve(B)`` and ``tri_solve(B, transpose)``."""
    L = _factor(mesh, A, nb, layout, unroll)
    out = {"L": L.full()}
    if b is not None:
        out["x"] = distributed_chol_solve(L, b, mesh=mesh)
    if B is not None:
        out["y"] = distributed_tri_solve(L, B, mesh=mesh)
        out["yT"] = distributed_tri_solve(L, B, mesh=mesh, transpose=True)
    return out


def case_chol_factor(mesh, A, nb, exts, b):
    """A :class:`DistributedCholFactor` on the cyclic factor of ``A``,
    extended by each ``(B, D)`` of ``exts``: its solve of ``b`` and logdet."""
    f = DistributedCholFactor(_factor(mesh, A, nb, "cyclic"), mesh=mesh)
    for B, D in exts:
        f.extend(B, D)
    return {"x": f.solve(b), "logdet": f.logdet()}


def case_condition(mesh, kernel, X, Y, noise, nb, layout):
    w, chol = distributed_condition(kernel, X, Y, mesh=mesh, noise_variance=noise, block_size=nb, layout=layout)
    return {"w": w, "n_pad": chol.n}


def case_conditioner(mesh, k_obs, X, Y, batches, xq, prior_kernel, cross_q, noise, jitter, nb, qblock):
    """Condition on ``(k_obs, X, Y)``, then each ``(cross_kernels, diag,
    Xb, Yb)`` of ``batches``; the weights after each step and the posterior
    mean and std at ``xq`` (``cross_q``: one query cross kernel per batch)."""
    cond = DistributedConditioner(mesh=mesh, block_size=nb)
    ws = [cond.condition(k_obs, X, Y, noise_variance=noise, jitter=jitter)]
    for cross, diag, Xb, Yb in batches:
        ws.append(cond.extend(cross, diag, Xb, Yb, noise_variance=noise, jitter=jitter))
    mean, std = cond.posterior_eval(cross_q, prior_kernel, xq, query_block_size=qblock)
    return {"w": ws, "mean": mean, "std": std}


def case_posterior(mesh, prior, X, Y, L, noise, xq):
    """The dense engine's posterior, evaluated over the mesh."""
    from ..models.randvars import Normal

    b = Normal(np.zeros(len(Y)), noise * np.eye(len(Y)))
    post = prior.condition_on_observations(Y, X=X, L=L, b=b)
    mean, std = sharded_posterior_eval(post, xq, mesh=mesh, with_std=True)
    return {"mean": mean, "std": std, "mean_only": sharded_posterior_eval(post, xq, mesh=mesh)}


def case_gram_matvec(mesh, spec, X0, X1, v, mode):
    return {"gathered": distributed_gram_matvec(spec, X0, X1, v, mesh=mesh, mode=mode, gather=True),
            "local": distributed_gram_matvec(spec, X0, X1, v, mesh=mesh, mode=mode)}


def case_iterative(mesh, prior, X, Y, xq, kw, var_block=None):
    reg = DistributedIterativeGPRegressor(prior, X, Y, mesh=mesh, **kw)
    out = {"w": reg.representer_weights, "mean": reg.mean(xq), "info": reg.solve_info,
           "banded": reg._banded is not None}
    if var_block:
        out["var"] = reg.var(xq, block_size=var_block)
    return out


def case_nystrom_indefinite(mesh, prior, X, Y, kw):
    """The regressor on an indefinite prior: the Nyström build must raise."""
    try:
        w = DistributedIterativeGPRegressor(prior, X, Y, mesh=mesh, **kw).representer_weights
    except torch.linalg.LinAlgError as exc:
        return {"raised": f"LinAlgError: {exc}"}
    return {"raised": None, "w": w}


def _true_relres(spec, X, Y, w, noise) -> float:
    """``||(K + sigma^2 I) w - Y|| / ||Y||`` by the float64 matvec."""
    X64 = torch.as_tensor(X, dtype=torch.float64)
    w = torch.as_tensor(w, dtype=torch.float64)
    Y = torch.as_tensor(Y, dtype=torch.float64)
    r = gram_matvec(spec, X64, X64, w, "f64") + noise * w - Y
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(Y))


def case_ff_sum(mesh, prior, X, Y, L, kw):
    """The mode-ff mesh CG's true relres (f64), and the same CG fed only
    the hi plane of K2's ff pair, the float32-rounded matvec the JAX
    package's mesh CG sums (the control)."""
    out = {}
    for name in ("ff", "hi_only"):
        reg = DistributedIterativeGPRegressor(prior, X, Y, mesh=mesh, L=L, mode="ff", **kw)
        if name == "hi_only":
            full = reg._local_mv
            reg._local_mv = lambda v, full=full: full(v)[0]
        w = reg.representer_weights
        out[name] = {"relres": _true_relres(reg._obs_spec, X, Y, w, reg.noise_variance), "info": reg.solve_info}
    return out


def case_dryrun(mesh, **sizes):
    """:func:`dryrun_multichip` on the world of ``mesh``."""
    return dryrun_multichip(mesh.size, **sizes)


CASES = {
    "mesh": case_mesh,
    "sharded_gram": case_sharded_gram,
    "cholesky": case_cholesky,
    "chol_factor": case_chol_factor,
    "condition": case_condition,
    "conditioner": case_conditioner,
    "posterior": case_posterior,
    "gram_matvec": case_gram_matvec,
    "iterative": case_iterative,
    "nystrom_indefinite": case_nystrom_indefinite,
    "ff_sum": case_ff_sum,
    "dryrun": case_dryrun,
}


def _tree(x):
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not (isinstance(x, tuple) and x and isinstance(x[0], torch.Tensor)):
        return type(x)(_tree(v) for v in x)
    return _np(x)


def rank_cases(cases: list, settings: dict | None = None) -> dict:
    """Run ``cases`` (``(key, case name, kwargs)`` triples) on this rank of
    the world, on one mesh over all of it, after ``config.set(**settings)``;
    returns ``{key: result}`` with tensors as float64 numpy arrays, plus
    ``"world"`` (the world size) and ``"jax_loaded"`` (modules of JAX or the
    JAX package this rank holds)."""
    import sys

    config.set(**(settings or {}))
    mesh = make_mesh()
    out = {key: _tree(CASES[name](mesh, **kw)) for key, name, kw in cases}
    out["world"] = dist.get_world_size()
    out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "linpde_gp_tpu"))
    return out


# -- the dry run ------------------------------------------------------------------------


def _gate(ok: bool, what: str) -> None:
    """A dry-run gate: raises ``AssertionError`` with ``what`` if not ``ok``."""
    if not ok:
        raise AssertionError(what)


def _relerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1.0))


def _dryrun(nb: int, blocks_per_rank: int, n_it_per_rank: int, n_wendland: int) -> dict:
    """One dry run on the current world (module docstring); returns the
    measured errors and raises ``AssertionError`` on a failed gate."""
    old_jitter = config.cholesky_jitter
    config.set(cholesky_jitter=1e-6)
    try:
        return _dryrun_checks(nb, blocks_per_rank, n_it_per_rank, n_wendland)
    finally:
        config.set(cholesky_jitter=old_jitter)


def _dryrun_checks(nb, blocks_per_rank, n_it_per_rank, n_wendland) -> dict:
    import linpde_gp_tpu_torch as lgt
    from ..ops.kernels.wendland import WendlandCovarianceFunction
    from ..ops.transforms import apply_operator_to_kernel

    mesh = make_mesh()
    dev = mesh.device
    P = mesh.size
    atol = 3e-6
    errs = {"world": P, "device": str(dev)}

    n = P * nb * blocks_per_rank
    prior = lgt.GaussianProcess(lgt.functions.Zero(()), 2.0**2 * lgt.kernels.Matern((), nu=2.5, lengthscales=1.0),
                                device=dev)
    D = -1.0 * lgt.diffops.Laplacian(())
    k_dd = apply_operator_to_kernel(D, apply_operator_to_kernel(D, prior.cov, argnum=1), argnum=0)
    k_cross = apply_operator_to_kernel(D, prior.cov, argnum=0)
    X = np.linspace(-1.0, 1.0, n)
    Y = np.full((n,), 2.0)
    noise = jitter = 1e-6

    def dense(k, a, b=None):
        a = torch.as_tensor(a, dtype=torch.float64, device=dev)
        return gram_matrix(k, a, a if b is None else torch.as_tensor(b, dtype=torch.float64, device=dev), "f64")

    G = dense(k_dd, X)
    bump0 = noise + jitter
    G_reg = G + (bump0 + jitter * (float(torch.mean(torch.diagonal(G))) + bump0)) * torch.eye(n, dtype=G.dtype,
                                                                                            device=dev)
    Yt = torch.as_tensor(Y, dtype=torch.float64, device=dev)
    w_ref = torch.linalg.solve(G_reg, Yt)
    cond = DistributedConditioner(mesh=mesh, block_size=nb)
    w = cond.condition(k_dd, X, Y, noise_variance=noise)
    errs["weights"] = _relerr(_np(w), _np(w_ref))
    _gate(errs["weights"] < atol, f"distributed weights diverge from the dense oracle: {errs['weights']:.3e}")

    X_bc, Y_bc = np.asarray([-1.0, 1.0]), np.asarray([0.0, 1.0])
    w_ext = cond.extend([k_cross], prior.cov, X_bc, Y_bc, noise_variance=noise)
    C = dense(k_cross, X, X_bc)
    D_blk = dense(prior.cov, X_bc)
    D_reg = D_blk + (noise + jitter + jitter * float(torch.mean(torch.diagonal(D_blk)))) * torch.eye(2, dtype=G.dtype,
                                                                                                   device=dev)
    K_full = torch.cat([torch.cat([G_reg, C], 1), torch.cat([C.T, D_reg], 1)])
    rhs = torch.cat([Yt, torch.as_tensor(Y_bc, dtype=torch.float64, device=dev)])
    w_ext_ref = torch.linalg.solve(K_full, rhs)
    errs["extended_weights"] = _relerr(_np(w_ext), _np(w_ext_ref))
    _gate(errs["extended_weights"] < atol, f"Schur-extended weights diverge: {errs['extended_weights']:.3e}")

    xq = np.linspace(-1.0, 1.0, 16 * P)
    mean, std = cond.posterior_eval([k_cross, prior.cov], prior.cov, xq, query_block_size=32)
    U = torch.cat([dense(k_cross, X, xq), dense(prior.cov, X_bc, xq)])
    y_ref = torch.linalg.solve_triangular(torch.linalg.cholesky(K_full), U, upper=False)
    prior_var = prior.cov(torch.as_tensor(xq, dtype=torch.float64, device=dev))
    var_ref = prior_var - torch.sum(y_ref**2, 0)
    errs["mean"] = float(torch.max(torch.abs(mean - U.T @ w_ext_ref)))
    errs["var"] = float(torch.max(torch.abs(std**2 - var_ref)) / torch.max(prior_var))
    _gate(errs["mean"] < atol, f"posterior mean diverges: {errs['mean']:.3e}")
    _gate(errs["var"] < 1e-5, f"posterior variance diverges: {errs['var']:.3e} of the prior variance")

    post = prior.condition_on_observations(Y, X=X, L=D)
    mean2 = sharded_posterior_eval(post, xq, mesh=mesh)
    errs["sharded_eval"] = float(torch.max(torch.abs(mean2 - post.mean(torch.as_tensor(xq, device=dev)))))
    _gate(errs["sharded_eval"] < atol, f"sharded query evaluation diverges: {errs['sharded_eval']:.3e}")

    n_it = P * n_it_per_rank
    X_it, Y_it = X[:n_it], Y[:n_it]
    reg = DistributedIterativeGPRegressor(prior, X_it, Y_it, mesh=mesh, L=D, noise_variance=1e-4, tol=1e-9,
                                          maxiter=1500, precond_rank=64, mode="f64")
    A_it = G[:n_it, :n_it] + 1e-4 * torch.eye(n_it, dtype=G.dtype, device=dev)
    w_it_ref = torch.linalg.solve(A_it, Yt[:n_it])
    errs["gram_free_weights"] = _relerr(_np(reg.representer_weights), _np(w_it_ref))
    _gate(errs["gram_free_weights"] < 1e-6, (
        f"gram-free mesh CG diverges from the dense oracle: {errs['gram_free_weights']:.3e} ({reg.solve_info})"))
    U2 = dense(k_cross, X_it, xq)
    errs["gram_free_mean"] = float(torch.max(torch.abs(reg.mean(xq) - U2.T @ w_it_ref)))
    _gate(errs["gram_free_mean"] < 1e-6, f"gram-free mesh posterior mean diverges: {errs['gram_free_mean']:.3e}")
    xq_v = xq[: 8 * P]
    U3 = U2[:, : 8 * P]
    v_ref = prior.cov(torch.as_tensor(xq_v, dtype=torch.float64, device=dev)) - torch.sum(
        U3 * torch.linalg.solve(A_it, U3), 0)
    errs["gram_free_var"] = float(torch.max(torch.abs(reg.var(xq_v, block_size=16) - v_ref)))
    _gate(errs["gram_free_var"] < 1e-6, f"gram-free mesh posterior variance diverges: {errs['gram_free_var']:.3e}")

    # A compactly supported prior: the internal sort and each rank's band.
    n_w = -(-n_wendland // P) * P
    w_scale, w_ls, noise_w = 2.0, 0.02, 1e-4
    prior_w = lgt.GaussianProcess(lgt.functions.Zero(()),
                                  w_scale * WendlandCovarianceFunction((), k=2, lengthscales=w_ls), device=dev)
    rng = np.random.default_rng(5)
    X_w = rng.uniform(0.0, 1.0, n_w)
    Y_w = np.sin(7 * X_w) + 0.1 * rng.standard_normal(n_w)
    reg_w = DistributedIterativeGPRegressor(prior_w, X_w, Y_w, mesh=mesh, noise_variance=noise_w, tol=1e-8,
                                            maxiter=800, precond_rank=min(1024, n_w // 4), mode="f64")
    w_w = reg_w.representer_weights
    errs["banded_ranks"] = int(mesh.all_reduce(torch.tensor([float(reg_w._banded is not None)], device=dev))[0])
    _gate(errs["banded_ranks"] == P, "the banded schedule is not engaged on every rank")
    spec_w = kernel_term_specs(prior_w.cov)
    errs["banded_true_relres"] = _true_relres(spec_w, torch.as_tensor(X_w, device=dev),
                                              torch.as_tensor(Y_w, device=dev), w_w, noise_w)
    _gate(errs["banded_true_relres"] < 1e-6, f"banded mesh weights fail the f64 residual: {errs['banded_true_relres']}")
    K_w = dense(prior_w.cov, X_w)
    w_w_ref = torch.linalg.solve(K_w + noise_w * torch.eye(n_w, dtype=K_w.dtype, device=dev),
                                 torch.as_tensor(Y_w, dtype=torch.float64, device=dev))
    Kq = dense(prior_w.cov, np.linspace(0.0, 1.0, 257), X_w)
    errs["banded_mean"] = _relerr(_np(Kq @ w_w), _np(Kq @ w_w_ref))
    _gate(errs["banded_mean"] < 1e-6, f"banded mesh posterior mean diverges: {errs['banded_mean']:.3e}")

    # The 2-D block-cyclic layout, forced on any mesh (a 1 x P mesh when P is prime).
    nb2 = 4
    n2 = nb2 * P * max(1, -(-130 // P))
    rng2 = np.random.default_rng(3)
    A2 = rng2.standard_normal((n2, n2))
    A2 = torch.as_tensor(A2 @ A2.T + n2 * np.eye(n2), device=dev)
    L2 = distributed_cholesky_2d(A2, mesh=mesh, block_size=nb2, jitter=0.0).full()
    errs["cholesky_2d"] = float(torch.max(torch.abs(L2 - torch.linalg.cholesky(A2))))
    _gate(errs["cholesky_2d"] < 1e-8, f"2-D block-cyclic factor diverges: {errs['cholesky_2d']:.3e}")
    return errs


def dryrun_multichip(n_devices: int | None = None, *, device=None, nb: int = 64, blocks_per_rank: int = 4,
                     n_it_per_rank: int = 128, n_wendland: int = 4096, timeout: float = 600.0) -> dict:
    """One sharded conditioning step over ``n_devices`` ranks, every result
    held to a dense float64 oracle (module docstring); returns rank 0's
    errors.  Inside a world (or for one rank), runs on it; otherwise spawns
    the ranks: gloo on the CPU, NCCL on cards (one card per rank)."""
    sizes = (nb, blocks_per_rank, n_it_per_rank, n_wendland)
    if dist.is_initialized() or (n_devices or 1) == 1:
        if device is not None:
            config.set(device=str(device))
        return _dryrun(*sizes)
    from .launch import spawn

    dev = str(device or config.device or "cuda")
    backend = "gloo" if dev == "cpu" else "nccl"
    return spawn(_dryrun, int(n_devices), sizes, timeout=timeout, backend=backend, device=dev)[0]
