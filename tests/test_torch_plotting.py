"""The port's plotting layer (``linpde_gp_tpu_torch/utils/plotting.py``):
the cases of ``tests/test_plotting.py``, Agg backend, with the plotted
arrays (mean lines, the credible band's vertices, surfaces) held to the
JAX package's plots of the same inputs at 1e-10.  Samples come from a
torch generator in the port, so of them only count and shape are
checked."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import torch

import linpde_gp_tpu as jlgt
import linpde_gp_tpu.utils.plotting as jplt
import linpde_gp_tpu_torch as tlgt
import linpde_gp_tpu_torch.utils.plotting as lplt
from linpde_gp_tpu_torch.config import config

torch.set_num_threads(1)
config.set(device="cpu")

TOL = 1e-10


def _posterior(lgt):
    prior = lgt.GaussianProcess(lgt.functions.Zero(()), 2.0**2 * lgt.kernels.Matern((), nu=2.5, lengthscales=0.7))
    X = np.asarray([-0.6, 0.0, 0.8])
    return prior.condition_on_observations(np.sin(X), X=X)


def _close(a, b, scale=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= TOL * (np.max(np.abs(b)) if scale is None else scale)


def _band(ax):
    (band,) = ax.collections
    return band.get_paths()[0].vertices


def test_plot_methods_attached():
    grid = np.linspace(-1, 1, 30)
    axes = []
    for lgt, kw in ((jlgt, dict(rng=np.random.default_rng(0))), (tlgt, dict(generator=torch.Generator().manual_seed(0)))):
        fig, ax = plt.subplots()
        post = _posterior(lgt)
        post.plot(ax, grid, num_samples=3, **kw)
        post.mean.plot(ax, grid)
        lgt.functions.Polynomial((1.0, 2.0)).plot(ax, grid)
        axes.append((fig, ax))
    (jfig, jax_ax), (tfig, ax) = axes
    assert len(ax.lines) == len(jax_ax.lines) == 1 + 3 + 2
    # The mean line, the posterior mean's and the polynomial's.
    for i in (0, 4, 5):
        _close(ax.lines[i].get_xydata(), jax_ax.lines[i].get_xydata())
    _close(_band(ax), _band(jax_ax))
    for line in ax.lines[1:4]:
        assert line.get_xydata().shape == (30, 2) and np.all(np.isfinite(line.get_xydata()))
    plt.close(jfig)
    plt.close(tfig)


def test_plot_samples_method_and_deterministic_process():
    post = _posterior(tlgt)
    fig, ax = plt.subplots()
    lines = post.plot_samples(ax, np.linspace(-1, 1, 11), num_samples=4)
    assert len(lines) == 4 and lines[0].get_xydata().shape == (11, 2)
    again = lplt.plot_process_samples(post, ax, np.linspace(-1, 1, 11), num_samples=4)
    _close(np.stack([l.get_ydata() for l in again]), np.stack([l.get_ydata() for l in lines]))  # seed 0 both
    proc = tlgt.DeterministicProcess(tlgt.functions.Polynomial((0.5, 1.0)))
    proc.plot(ax, np.linspace(0, 1, 5))
    assert len(ax.collections) == 0
    plt.close(fig)


def test_plot_local_curvature():
    figs, axes = [], []
    for mod in (jplt, lplt):
        fig, ax = plt.subplots()
        mod.plot_local_curvature(
            ax, xs=np.asarray([0.0, 0.5]), f_xs=np.asarray([1.0, 1.2]), ddf_xs=np.asarray([-2.0, -2.0]), label="obs"
        )
        figs.append(fig)
        axes.append(ax)
    assert len(axes[1].lines) == 2
    for a, b in zip(axes[1].lines, axes[0].lines):
        _close(a.get_xydata(), b.get_xydata())
    assert axes[1].lines[0].get_label() == "obs"
    for fig in figs:
        plt.close(fig)


def test_plot_gaussian_pdf():
    figs, axes = [], []
    for lgt, mod in ((jlgt, jplt), (tlgt, lplt)):
        fig, ax = plt.subplots()
        mod.plot_gaussian_pdf(lgt.Normal(np.asarray(1.0), np.asarray([[0.25]])), ax)
        figs.append(fig)
        axes.append(ax)
    assert len(axes[1].lines) == 1
    _close(axes[1].lines[0].get_xydata(), axes[0].lines[0].get_xydata())
    for fig in figs:
        plt.close(fig)


def test_pdf_writer(tmp_path):
    writer = lplt.PDFWriter()
    fig, ax = plt.subplots()
    ax.plot([0, 1], [0, 1])
    writer.setup(fig, str(tmp_path / "frame_{}.pdf"))
    writer.grab_frame()
    writer.grab_frame()
    writer.finish()
    assert (tmp_path / "frame_0.pdf").exists()
    assert (tmp_path / "frame_1.pdf").exists()
    with writer.saving(fig, str(tmp_path / "again_{}.pdf")):
        writer.grab_frame()
    assert (tmp_path / "again_0.pdf").exists()
    plt.close(fig)


def test_plot_random_process_2d_surface_and_contour():
    """2-D posterior plotting (reference utils/plotting.py:72-185): mean
    surface + credible surfaces on a 3-D axis, contours on 2-D; the mean
    surface and the filled contours' levels held to the JAX plot's."""
    X = np.random.default_rng(0).uniform(-1, 1, (12, 2))
    Y = np.sin(X[:, 0]) * X[:, 1]
    xs = (np.linspace(-1, 1, 9), np.linspace(-1, 1, 8))
    out = []
    for lgt in (jlgt, tlgt):
        k = lgt.kernels.TensorProduct(
            lgt.kernels.Matern((), nu=1.5, lengthscales=1.0), lgt.kernels.Matern((), nu=2.5, lengthscales=1.0)
        )
        post = lgt.GaussianProcess(lgt.functions.Zero((2,)), k).condition_on_observations(Y, X=X)
        fig = plt.figure()
        ax3 = fig.add_subplot(1, 2, 1, projection="3d")
        surf = post.plot(ax3, xs, cred_int=0.95)
        ax2 = fig.add_subplot(1, 2, 2)
        cs = post.plot(ax2, xs)
        assert surf is not None and cs is not None
        assert len(ax3.collections) == 3
        out.append((fig, ax3, cs))
    (jfig, jax3, jcs), (tfig, ax3, cs) = out
    for a, b in zip(ax3.collections, jax3.collections):
        _close(a._vec, b._vec)
    _close(cs.levels, jcs.levels)
    plt.close(jfig)
    plt.close(tfig)


def test_plot_local_taylor_processes():
    xs = np.asarray([-0.5, 0.3])
    figs, axes = [], []
    for lgt, mod in ((jlgt, jplt), (tlgt, lplt)):
        post = _posterior(lgt)
        fig, ax = plt.subplots()
        lines = mod.plot_local_taylor_processes(ax, xs, [post, post], dx=0.1)
        assert len(lines) == 2
        figs.append(fig)
        axes.append(ax)
    for a, b in zip(axes[1].lines, axes[0].lines):
        _close(a.get_xydata(), b.get_xydata())
    for a, b in zip(axes[1].collections, axes[0].collections):
        _close(a.get_paths()[0].vertices, b.get_paths()[0].vertices)
    for fig in figs:
        plt.close(fig)
