"""Plotting utilities.

Port of ``linpde_gp_tpu/utils/plotting.py``: ``plot_function``,
``plot_random_process`` (1-D mean and credible band with optional
samples, 2-D surfaces and contours), ``plot_process_samples``,
``plot_local_curvature`` / ``plot_local_taylor_processes``,
``plot_gaussian_pdf`` and ``PDFWriter``; importing this module attaches
``.plot`` / ``.plot_samples`` to functions and processes, as the JAX
package (and the reference) do.

matplotlib is optional: the package imports without it and only this
module needs it (``utils.plotting`` is loaded lazily).  Values are moved
to numpy for matplotlib, from any device.  Samples are drawn with an
explicit ``torch.Generator`` (``None``: a generator seeded with 0, as the
JAX package's ``rng=None`` means seed 0).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

try:
    import matplotlib.pyplot as plt

    _HAVE_MPL = True
except ImportError:  # pragma: no cover
    _HAVE_MPL = False

from ..models.functions.base import Function
from ..models.gp import GaussianProcess
from ..models.randprocs import DeterministicProcess


def _require_mpl():
    if not _HAVE_MPL:
        raise ImportError("matplotlib is required for plotting (optional dependency)")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_function(f: Function, ax, xs, **kwargs):
    """Plot a scalar 1-D function on an axis."""
    _require_mpl()
    xs = _np(xs)
    return ax.plot(xs, _np(f(xs)), **kwargs)


def plot_random_process(
    rp,
    ax,
    xs,
    *,
    cred_int: float = 0.95,
    num_samples: int = 0,
    generator: torch.Generator | None = None,
    color=None,
    alpha: float = 1.0,
    rel_fill_alpha: float = 0.1,
    rel_sample_alpha: float = 0.2,
    label=None,
    samples_kwargs: dict | None = None,
    **kwargs,
):
    """1-D process plot: mean curve, credible band, optional samples
    (reference ``plot_random_process``/``plot_gp`` behavior)."""
    _require_mpl()
    import scipy.stats

    xs = _np(xs)
    mean = _np(rp.mean(xs))
    (mean_line,) = ax.plot(xs, mean, color=color, alpha=alpha, label=label, **kwargs)
    color = mean_line.get_color()

    if cred_int is not None and not isinstance(rp, DeterministicProcess):
        std = _np(rp.std(xs))
        z = scipy.stats.norm.ppf((1 + cred_int) / 2)
        ax.fill_between(xs, mean - z * std, mean + z * std, color=color, alpha=rel_fill_alpha * alpha)
    if num_samples > 0:
        plot_process_samples(
            rp,
            ax,
            xs,
            generator=generator,
            num_samples=num_samples,
            color=color,
            alpha=rel_sample_alpha * alpha,
            **(samples_kwargs or {}),
        )
    return mean_line


def plot_process_samples(rp, ax, xs, *, generator: torch.Generator | None = None, num_samples=1, **kwargs):
    """``num_samples`` sample paths of ``rp`` at ``xs``, drawn with
    ``generator`` (on the process's device; ``None``: seeded with 0)."""
    _require_mpl()
    xs = _np(xs)
    if generator is None:
        generator = torch.Generator(device=rp.device).manual_seed(0)
    samples = _np(rp.sample(generator, xs, (num_samples,)))
    return ax.plot(xs, samples.T, **kwargs)


def plot_local_curvature(ax, xs, f_xs, ddf_xs, df_xs=None, *, dx: float = 0.05, **kwargs):
    """Draw small parabola glyphs showing observed second derivatives
    (reference ``plot_local_curvature`` used by the Poisson notebooks)."""
    _require_mpl()
    xs, f_xs, ddf_xs = _np(xs), _np(f_xs), _np(ddf_xs)
    df_xs = np.zeros_like(xs) if df_xs is None else _np(df_xs)
    label = kwargs.pop("label", None)
    lines = []
    ts = np.linspace(-dx, dx, 21)
    for i, (x, fx, dfx, ddfx) in enumerate(zip(xs, f_xs, df_xs, ddf_xs)):
        ys = fx + dfx * ts + 0.5 * ddfx * ts**2
        (line,) = ax.plot(x + ts, ys, label=label if i == 0 else None, **kwargs)
        lines.append(line)
    return lines


def plot_local_taylor_processes(ax, xs, taylor_processes, *, dx: float = 0.05, **kwargs):
    """Plot local Taylor-polynomial process beliefs around points
    (reference ``plot_local_taylor_processes``)."""
    _require_mpl()
    return [
        plot_random_process(proc, ax, np.linspace(x - dx, x + dx, 21), **kwargs) for x, proc in zip(_np(xs), taylor_processes)
    ]


def _grid_2d(xs0, xs1):
    X0, X1 = np.meshgrid(_np(xs0), _np(xs1), indexing="ij")
    return X0, X1, np.stack([X0, X1], axis=-1)


def plot_function_2d(f, ax, xs0, xs1, **kwargs):
    """2-D function plot: surface on a 3-D axis, filled contours on a
    2-D axis (reference ``utils/plotting.py:72-185`` 2-D behavior)."""
    _require_mpl()
    X0, X1, pts = _grid_2d(xs0, xs1)
    Z = _np(f(pts))
    if hasattr(ax, "plot_surface"):
        return ax.plot_surface(X0, X1, Z, **kwargs)
    return ax.contourf(X0, X1, Z, **kwargs)


def plot_random_process_2d(rp, ax, xs0, xs1, *, cred_int: float = 0.95, rel_band_alpha: float = 0.25, **kwargs):
    """2-D process plot: posterior-mean surface plus translucent
    ``mean ± z·std`` credible surfaces on a 3-D axis; on a 2-D axis the
    mean as filled contours (std available via ``rp.std`` separately)."""
    _require_mpl()
    import scipy.stats

    X0, X1, pts = _grid_2d(xs0, xs1)
    mean = _np(rp.mean(pts))
    if not hasattr(ax, "plot_surface"):
        return ax.contourf(X0, X1, mean, **kwargs)
    surf = ax.plot_surface(X0, X1, mean, **kwargs)
    if cred_int is not None and not isinstance(rp, DeterministicProcess):
        std = _np(rp.std(pts))
        z = scipy.stats.norm.ppf((1 + cred_int) / 2)
        band_kwargs = dict(kwargs)
        band_kwargs.pop("label", None)
        band_kwargs["alpha"] = rel_band_alpha * kwargs.get("alpha", 1.0)
        ax.plot_surface(X0, X1, mean - z * std, **band_kwargs)
        ax.plot_surface(X0, X1, mean + z * std, **band_kwargs)
    return surf


def plot_gaussian_pdf(rv, ax, num_stds: float = 3.0, **kwargs):
    """Plot the pdf of a scalar Normal (reference ``plot_gaussian_pdf``)."""
    _require_mpl()
    import scipy.stats

    mean = float(_np(rv.mean))
    std = float(_np(rv.std))
    grid = np.linspace(mean - num_stds * std, mean + num_stds * std, 200)
    return ax.plot(grid, scipy.stats.norm.pdf(grid, mean, std), **kwargs)


class PDFWriter:
    """Matplotlib animation writer emitting one PDF per frame
    (reference ``utils/plotting.py:643``)."""

    def __init__(self):
        _require_mpl()
        self._fig = None
        self._outfile_pattern = None
        self._frame_idx = 0

    def setup(self, fig, outfile, dpi=None):
        self._fig = fig
        self._outfile_pattern = str(outfile)
        self._frame_idx = 0

    @contextlib.contextmanager
    def saving(self, fig, outfile, dpi=None):
        self.setup(fig, outfile, dpi)
        yield self
        self.finish()

    def grab_frame(self, **kwargs):
        self._fig.savefig(self._outfile_pattern.format(self._frame_idx), **kwargs)
        self._frame_idx += 1

    def finish(self):
        pass


# -- attach methods (the reference attaches on import) -------------------------
def _is_2d_input(obj) -> bool:
    return tuple(getattr(obj, "input_shape", ())) == (2,)


def _function_plot(self, ax=None, xs=None, **kwargs):
    _require_mpl()
    if ax is None:
        ax = plt.gca()
    if _is_2d_input(self) and isinstance(xs, tuple) and len(xs) == 2:
        return plot_function_2d(self, ax, xs[0], xs[1], **kwargs)
    return plot_function(self, ax, xs, **kwargs)


def _process_plot(self, ax=None, xs=None, **kwargs):
    _require_mpl()
    if ax is None:
        ax = plt.gca()
    if _is_2d_input(self) and isinstance(xs, tuple) and len(xs) == 2:
        return plot_random_process_2d(self, ax, xs[0], xs[1], **kwargs)
    return plot_random_process(self, ax, xs, **kwargs)


def _process_plot_samples(self, ax=None, xs=None, **kwargs):
    _require_mpl()
    if ax is None:
        ax = plt.gca()
    return plot_process_samples(self, ax, xs, **kwargs)


Function.plot = _function_plot
GaussianProcess.plot = _process_plot
GaussianProcess.plot_samples = _process_plot_samples
DeterministicProcess.plot = _process_plot
