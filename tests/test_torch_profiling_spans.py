"""The program's spans (``utils/profiling.span``) on the CPU in float64: free
and absent with no profiler running, every span of the module's list
emitted and nested under ``torch.profiler``, and the same outputs to the bit
with and without it.

Three small paths cover every span: the gram-free heat regressor (N = 800,
rank 64: ``representer_weights``, ``mean``, ``var`` at one block), the
dense engine on the anchored heat IBVP (``mean`` and ``std``), and the same
with panels of 64 rows, so that ``std``, taken twice, runs the blocked
substitution twice and builds its panel inverses once."""

import numpy as np
import pytest
import torch

import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.ops.linalg import chol as chol_ops
from linpde_gp_tpu_torch.utils import profiling

torch.set_num_threads(1)
config.set(device="cpu")

HEAT_SPANS = {"lgt.nystrom.build", "lgt.nystrom.apply", "lgt.pcg", "lgt.pcg_block", "lgt.pcg.matvec",
              "lgt.host_read", "lgt.chol.factor"}
DENSE_SPANS = {"lgt.chol.factor", "lgt.chol.extend", "lgt.gp.mean", "lgt.gp.var", "lgt.gp.var.solve",
               "lgt.gp.crosscov"}
PANEL_SPANS = DENSE_SPANS | {"lgt.chol.panel_inv", "lgt.chol.panel_solve"}
#: Each span and the spans one of which must hold it.
PARENTS = {"lgt.pcg.matvec": ("lgt.pcg", "lgt.pcg_block"), "lgt.nystrom.apply": ("lgt.pcg", "lgt.pcg_block"),
           "lgt.host_read": ("lgt.pcg", "lgt.pcg_block"), "lgt.gp.var.solve": ("lgt.gp.var",),
           "lgt.gp.crosscov": ("lgt.gp.mean", "lgt.gp.var"), "lgt.chol.panel_inv": ("lgt.gp.var.solve",),
           "lgt.chol.panel_solve": ("lgt.gp.var.solve",)}


def _prior():
    cov = lgt.kernels.TensorProduct(lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
                                    lgt.kernels.Matern((), nu=2.5, lengthscales=2.0))
    return lgt.GaussianProcess(lgt.functions.Zero((2,)), cov, device="cpu"), lgt.diffops.HeatOperator((2,), alpha=0.1)


def _points(rng, n):
    return torch.as_tensor(np.stack([rng.uniform(0, 5, n), rng.uniform(-1, 1, n)], -1))


def _heat():
    """``(outputs, host reads per lgt.pcg expected)`` of the gram-free path."""
    rng = np.random.default_rng(5)
    X, xq = _points(rng, 800), _points(rng, 64)
    Y = torch.as_tensor(rng.standard_normal(800))
    prior, H = _prior()
    reg = lgt.IterativeGPRegressor(prior, X, Y, L=H, noise_variance=1e-2, tol=1e-6, precond_rank=64, mode="f64",
                                   device="cpu")
    w = reg.representer_weights
    out = {"weights": w, "mean": reg.mean(xq), "var": reg.var(xq, block_size=64)}
    return out, [reg.solve_info[0] + 1]


def _dense_posterior():
    """The dense engine conditioned on three anchor sets, then on the PDE,
    and 40 query points."""
    rng = np.random.default_rng(6)
    prior, H = _prior()
    post = prior
    for xa in (torch.stack([torch.zeros(12), torch.linspace(-1, 1, 12)], -1).double(),
               torch.stack([torch.linspace(0, 5, 6), torch.full((6,), -1.0)], -1).double(),
               torch.stack([torch.linspace(0, 5, 6), torch.full((6,), 1.0)], -1).double()):
        ya = torch.sin(np.pi * (xa[:, 1] + 1) / 2) * torch.exp(-0.1 * (np.pi / 2) ** 2 * xa[:, 0])
        post = post.condition_on_observations(ya, X=xa, b=lgt.Normal(np.zeros(len(xa)), np.full(len(xa), 1e-8)))
    X, xq = _points(rng, 300), _points(rng, 40)
    post = post.condition_on_observations(np.zeros(300), X=X, L=H, b=lgt.Normal(np.zeros(300), np.full(300, 1e-6)))
    return post, xq


def _dense():
    post, xq = _dense_posterior()
    return {"mean": post.mean(xq), "std": post.std(xq)}, []


def _dense_panels():
    """``std`` twice with panels of 64 rows (the factor has 324)."""
    saved, chol_ops.PANEL_ROWS = chol_ops.PANEL_ROWS, 64
    try:
        post, xq = _dense_posterior()
        return {"mean": post.mean(xq), "std": post.std(xq), "std_again": post.std(xq[:7])}, []
    finally:
        chol_ops.PANEL_ROWS = saved


PATHS = {"heat": (_heat, HEAT_SPANS), "dense": (_dense, DENSE_SPANS), "dense_panels": (_dense_panels, PANEL_SPANS)}


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name.startswith("lgt.")]
    return out, spans


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(scope="module")
def runs():
    """Per path: the outputs under the profiler, its ``lgt.`` spans, the
    expected host reads per ``lgt.pcg``, and the outputs without it."""
    out = {}
    for name, (fn, _) in PATHS.items():
        (traced, reads), spans = _profiled(fn)
        out[name] = traced, spans, reads, fn()[0]
    return out


def test_span_off_is_the_shared_noop(monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function.__enter__
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        lambda self: entered.append(self.name) or real(self))
    assert profiling.span("lgt.pcg") is profiling._OFF
    from linpde_gp_tpu_torch.ops.linalg.pcg import pcg_ff

    d = torch.linspace(1.0, 2.0, 16, dtype=torch.float64)
    res = pcg_ff(lambda v: (d * v[0], d * v[1]), None, torch.ones(16, dtype=torch.float64), 0.0, tol=1e-12)
    assert res.iterations > 0 and entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pcg_ff(lambda v: (d * v[0], d * v[1]), None, torch.ones(16, dtype=torch.float64), 0.0, tol=1e-12)
    assert "lgt.pcg" in entered


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_emitted_and_nested(path, runs):
    _, spans, _, _ = runs[path]
    assert {s[0] for s in spans} == PATHS[path][1]
    for s in spans:
        parents = PARENTS.get(s[0])
        if parents:
            assert any(p[0] in parents and _inside(s, p) for p in spans), s


def test_host_reads_per_solve(runs):
    """``lgt.host_read`` inside each ``lgt.pcg``: ``||b||`` and one per
    iteration."""
    _, spans, expected, _ = runs["heat"]
    solves = [s for s in spans if s[0] == "lgt.pcg"]
    assert [sum(1 for r in spans if r[0] == "lgt.host_read" and _inside(r, s)) for s in solves] == expected


def test_panel_spans_per_solve(runs):
    """One ``lgt.chol.panel_solve`` in each ``lgt.gp.var.solve``, and one
    ``lgt.chol.panel_inv`` in the first only: the inverses are built once."""
    _, spans, _, _ = runs["dense_panels"]
    solves = [s for s in spans if s[0] == "lgt.gp.var.solve"]
    inside = [[r[0] for r in spans if r[0].startswith("lgt.chol.panel") and _inside(r, s)] for s in solves]
    assert [sorted(i) for i in inside] == [["lgt.chol.panel_inv", "lgt.chol.panel_solve"], ["lgt.chol.panel_solve"]]


@pytest.mark.parametrize("path", list(PATHS))
def test_outputs_bit_identical_with_and_without_profiler(path, runs):
    traced, _, _, plain = runs[path]
    assert traced.keys() == plain.keys()
    for key in plain:
        assert torch.equal(traced[key], plain[key]), key
