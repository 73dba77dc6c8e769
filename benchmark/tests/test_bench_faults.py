"""A run whose timed path is broken underneath comes out not correct, for
each fault the cells can have: a step that returns its state unchanged, half
of a batch left out, an answer altered where it is produced.  (The cells run
on one card: there is no exchange between cards to leave out.)  The harness's
look for a card is skipped; the rest of the run is the benchmark's own."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import catalog
from benchmark.harness.runner import run_cell
from benchmark.tests.test_bench_control import SIZES


def run(cell):
    return run_cell(cell, 9_000_000_011, 0.5, False, t_process=time.perf_counter(), device="cpu", sizes=SIZES[cell])


def _unchanged_cg(matvec, precond, b, sigma_sq, **kw):
    from linpde_gp_tpu_torch.ops.linalg.pcg import PCGResult

    b = b[0] if isinstance(b, tuple) else b
    return PCGResult(torch.zeros_like(b), 0, 1.0, torch.zeros_like(b))


def _half_matvec(groups, X0, X1, v, mode, **kw):
    from linpde_gp_tpu_torch.ops import gram

    h = X1.shape[0] // 2
    return gram.gram_matvec(groups, X0, X1[:h], v[:h] if torch.is_tensor(v) else tuple(p[:h] for p in v), mode)


def _altered(fn, rel=1e-5):
    """``fn``'s answers, each raised by ``rel`` of its largest."""

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        if isinstance(out, tuple):
            return tuple(wrapped_one(o) for o in out)
        return wrapped_one(out)

    def wrapped_one(out):
        out = out.clone()
        out += rel * out.abs().max()
        return out

    return wrapped


def _half_var(fn):
    def wrapped(self, x, **kw):
        v = fn(self, x[: (x.shape[0] + 1) // 2], **kw)
        return torch.cat([v, v])[: x.shape[0]]

    return wrapped


def _unchanged_posterior(self, Y, X=None, **kw):
    return self


def _half_observations(fn):
    def wrapped(self, Y, X=None, *, L=None, b=None):
        if L is None:
            return fn(self, Y, X=X, L=L, b=b)
        import linpde_gp_tpu_torch as lgt

        h = X.shape[0] // 2
        noise = catalog.problem("heat").noise_variance(catalog.config("ibvp_dense_32k"))
        return fn(self, np.asarray(Y)[:h], X=X[:h], L=L, b=lgt.Normal(np.zeros(h), np.full(h, noise)))

    return wrapped


def _plant(monkeypatch, cell, fault):
    import linpde_gp_tpu_torch as lgt
    from linpde_gp_tpu_torch.models import gp, iterative

    reg, post = iterative.IterativeGPRegressor, gp.ConditionalGaussianProcess
    if cell == "heat.condition":
        {"unchanged": lambda: monkeypatch.setattr(iterative, "pcg_ff", _unchanged_cg),
         "half": lambda: monkeypatch.setattr(iterative, "gram_matvec", _half_matvec),
         "altered": lambda: monkeypatch.setattr(reg, "mean", _altered(reg.mean))}[fault]()
    elif cell == "heat.variance":
        {"unchanged": lambda: monkeypatch.setattr(iterative, "pcg_block_ff", _unchanged_cg),
         "half": lambda: monkeypatch.setattr(reg, "var", _half_var(reg.var)),
         # var_gap's limit is 3e-5: the configuration's CG tol 1e-5 leaves a
         # variance ~2.6e-6 of the largest off, so an alteration has to be larger.
         "altered": lambda: monkeypatch.setattr(reg, "var", _altered(reg.var, 1e-4))}[fault]()
    elif cell == "ibvp.condition":
        {"unchanged": lambda: monkeypatch.setattr(post, "condition_on_observations", _unchanged_posterior),
         "half": lambda: monkeypatch.setattr(post, "condition_on_observations",
                                             _half_observations(post.condition_on_observations)),
         "altered": lambda: monkeypatch.setattr(gp.ConditionalMean, "__call__",
                                                _altered(gp.ConditionalMean.__call__))}[fault]()
    else:
        {"unchanged": lambda: monkeypatch.setattr(post, "condition_on_observations", _unchanged_posterior),
         "half": lambda: monkeypatch.setattr(post, "std", _half_var(post.std)),
         "altered": lambda: monkeypatch.setattr(post, "std", _altered(post.std))}[fault]()
    return lgt


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", list(SIZES))
def test_fault_is_not_correct(cell, fault, cpu, monkeypatch):
    _plant(monkeypatch, cell, fault)
    res = run(cell)
    assert not res["correct"], res["checks"]
