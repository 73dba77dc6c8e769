"""The banded matvec of a compactly supported kernel against the dense one
(``experiments/wendland_banded_tpu.py`` of the JAX package).

A Wendland kernel vanishes beyond its support radius, so the banded
kernel (``ops/banded.py``: each block of ``config.matvec_tile`` sorted rows
walks only its own window of columns) is exact, not an approximation.  At
n = ``WB_N`` (card 1e5, CPU 4096) sorted uniform points of [0, 1] and
``2 Wendland(k=2, l=WB_ELL)`` (0.05): the dense K2 matvec against the
banded one (the least host-clock time of three synchronized calls after a
warm-up, and their agreement), then conditioning on ``Y = sin(8 X)``
through the regressor, which routes its CG matvec through the banded
kernel (``banded_routed``).

``band_fraction`` is the share of column tiles the port's schedule visits
(``band_tiles / total_tiles`` of ``BandedMatvec``); the JAX package's
schedule is coarser (one window per TPU row tile), so its fraction is
larger on the same data.  ``pair_fraction`` is the share of the n^2 pairs
the kernel evaluates.

    python -m linpde_gp_tpu_torch.experiments.wendland_banded [--device cpu] [--mode f64]

The mode defaults to ``ff`` on the card (``WB_COMPENSATED=0``: ``plain``)
and ``f64`` on the CPU.  ``WB_HOST_CG``, ``WB_TILE0`` and ``WB_TILE1``
(a TPU path and tiles) raise.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..config import mode_dtype, resolve_device
from ..ops.banded import make_banded_matvec
from ..ops.gram import gram_matvec, kernel_term_specs
from .common import StageTimer, best_of, cli_args, default_mode, log, card_branch, reject_dropped_knobs, setting, setup


def _log(msg):
    log("wendland_banded", msg)


def _f64(out) -> torch.Tensor:
    """A matvec result as float64 (an ff pair summed)."""
    return out[0].double() + out[1].double() if isinstance(out, tuple) else out.double()


def main(device=None, mode=None, branch=None):
    """Time and check the two matvecs, then condition; returns the JAX
    script's payload (plus ``pair_fraction`` and the mode).
    ``branch``: whose defaults the settings take, ``"card"`` (the JAX
    script's TPU branch) or ``"cpu"``; ``None``: the device's own.
    """
    reject_dropped_knobs("WB_HOST_CG", "WB_TILE0", "WB_TILE1")
    with setup(device) as lgt:
        dev = resolve_device(device)
        card = card_branch(branch, dev)
        mode = default_mode(mode, card, "ff" if setting("WB_COMPENSATED", True, True, card, bool) else "plain")
        dtype = mode_dtype(mode)
        n = setting("WB_N", 100_000, 4096, card)
        ell = setting("WB_ELL", 0.05, 0.05, card, float)

        rng = np.random.default_rng(0)
        X = np.sort(rng.uniform(0.0, 1.0, n))
        v = rng.standard_normal(n)
        Xd = torch.tensor(X, device=dev).to(dtype)
        vd = torch.tensor(v, device=dev).to(dtype)

        k = 2.0 * lgt.kernels.WendlandCovarianceFunction((), k=2, lengthscales=ell)
        spec = kernel_term_specs(k)
        banded = make_banded_matvec(spec, Xd, Xd, mode=mode)
        frac = banded.band_tiles / banded.total_tiles
        _log(f"n={n} support={ell}: band {banded.band_tiles}/{banded.total_tiles} tiles ({100 * frac:.2f}%), "
             f"{100 * banded.pair_fraction:.2f}% of the pairs")

        t_dense, out_dense = best_of(lambda: gram_matvec(spec, Xd, Xd, vd, mode), 3)
        _log(f"dense matvec: {t_dense * 1e3:.3f} ms ({n * n / t_dense / 1e9:.1f} G pair/s)")
        t_band, out_band = best_of(lambda: banded(vd), 3)
        _log(f"banded matvec: {t_band * 1e3:.3f} ms ({t_dense / t_band:.1f}x faster)")
        dense64 = _f64(out_dense)
        err = ((_f64(out_band) - dense64).abs().max() / dense64.abs().max().clamp(min=1e-30)).item()
        _log(f"banded vs dense agreement: rel max err {err:.2e}")

        prior = lgt.GaussianProcess(lgt.functions.Zero(()), k)
        timer = StageTimer()
        with timer("condition"):
            reg = lgt.IterativeGPRegressor(
                prior, Xd, torch.sin(8.0 * Xd), noise_variance=1e-3 if card else 1e-8,
                tol=1e-5 if card else 1e-10, maxiter=512, precond_rank=1024 if card else 128, mode=mode,
            )
            reg.representer_weights
        t_cond = timer.stages["condition"]
        iters, relres = reg.solve_info
        routed = reg._banded is not None
        _log(f"banded conditioning: {t_cond:.3f} s (incl. first use), iters={iters} relres={relres:.2e} "
             f"banded_routed={routed}")

        payload = {
            "experiment": "wendland_banded",
            "n": n,
            "support_radius": ell,
            "band_fraction": frac,
            "pair_fraction": banded.pair_fraction,
            "dense_matvec_s": t_dense,
            "banded_matvec_s": t_band,
            "speedup_x": t_dense / t_band,
            "agreement_rel_err": err,
            "condition_s_incl_compile": t_cond,
            "pcg_iters": iters,
            "banded_routed": routed,
            "mode": mode,
            "backend": dev.type,
        }
        print(json.dumps(payload))
        return payload


if __name__ == "__main__":
    args = cli_args(__doc__.splitlines()[0], mode=True)
    main(device=args.device, mode=args.mode)
