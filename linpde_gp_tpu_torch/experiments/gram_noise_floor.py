"""The float32 Gram's noise floor, plain against float-float (``ff``)
(``experiments/gram_noise_floor.py`` of the JAX package).

1. Entry accuracy at n = ``NF_N`` (card 4096, CPU 768): K1's Gram of the
   heat benchmark's ``H k H*`` at float32 points, in modes ``plain`` and
   ``ff``, against a float64 oracle of the same points (the plain
   version, ``ops/gram.gram_plain`` in f64, not the kernel under test):
   the largest entry error and the spectral norm ``||E||_2`` of the error
   matrix, by power iteration, both relative to k(0).  The coherent part
   of E is what drives the computed Gram's smallest eigenvalue negative.
2. Pair throughput at n = ``NF_THROUGHPUT_N`` (card 32768, CPU 2048): K2
   at r = 1 in both modes, the least host-clock time of three
   synchronized calls after a warm-up.

    python -m linpde_gp_tpu_torch.experiments.gram_noise_floor [--device cpu]

The script always measures both float32 modes against the float64
oracle, so it takes no mode.  ``NF_TILE`` (a TPU tile) raises.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..config import resolve_device
from ..ops.gram import gram, gram_matvec, gram_plain, kernel_term_specs
from .common import StageTimer, best_of, card_branch, cli_args, heat_kernels, log, reject_dropped_knobs, setting, setup

#: ``(payload key, mode)`` of the two float32 modes (the JAX package's
#: ``compensated`` evaluation is mode ``ff``).
MODES = (("plain", "plain"), ("compensated", "ff"))
#: Power iterations for ``||E||_2``.
POWER_ITERS = 50


def _log(msg):
    log("noise_floor", msg)


def main(device=None, branch=None):
    """Run both measurements; returns the JAX script's payload.
    ``branch``: whose defaults the settings take, ``"card"`` (the JAX
    script's TPU branch) or ``"cpu"``; ``None``: the device's own.
    """
    reject_dropped_knobs("NF_TILE")
    with setup(device) as lgt:
        dev = resolve_device(device)
        card = card_branch(branch, dev)
        n_acc = setting("NF_N", 4096, 768, card)
        n_thr = setting("NF_THROUGHPUT_N", 32768, 2048, card)
        scale, terms = kernel_term_specs(heat_kernels(lgt)[0])

        rng = np.random.default_rng(0)
        X = np.stack([rng.uniform(0.0, 5.0, n_acc), rng.uniform(-1.0, 1.0, n_acc)], axis=-1).astype(np.float32)
        x32 = torch.tensor(X, device=dev)
        _log(f"building the f64 oracle at n={n_acc} ...")
        K64 = scale * gram_plain(terms, x32.double(), x32.double(), "f64")
        k0 = K64[0, 0].item()

        results = {}
        for key, mode in MODES:
            timer = StageTimer()
            with timer("gram"):
                K = scale * gram(terms, x32, x32, mode).double()
            _log(f"  {mode} gram: {timer.stages['gram']:.3f} s (incl. first use)")
            E = K - K64
            del K
            # ||E||_2 by power iteration (E is symmetric up to round-off).
            v = torch.tensor(rng.standard_normal(n_acc), device=dev)
            v /= torch.linalg.norm(v)
            for _ in range(POWER_ITERS):
                w = E @ v
                nw = torch.linalg.norm(w)
                if nw.item() == 0:
                    break
                v = w / nw
            norm2 = torch.linalg.norm(E @ v).item()
            results[key] = dict(max_entry=E.abs().max().item() / k0, norm2_rel=norm2 / k0,
                                norm2_per_n=norm2 / k0 / n_acc)
            _log(f"  {mode}: max|E|/k0 = {results[key]['max_entry']:.3e}, ||E||2/k0 = {results[key]['norm2_rel']:.3e} "
                 f"(= {results[key]['norm2_per_n']:.3e} * n)")
            del E
        ratio = results["plain"]["norm2_rel"] / max(results["compensated"]["norm2_rel"], 1e-300)
        _log(f"coherent-error reduction (||E||2 plain / ff): {ratio:.1f}x")
        del K64

        Xt = np.stack([rng.uniform(0.0, 5.0, n_thr), rng.uniform(-1.0, 1.0, n_thr)], axis=-1).astype(np.float32)
        v32 = rng.standard_normal(n_thr).astype(np.float32)
        xt, vt = torch.tensor(Xt, device=dev), torch.tensor(v32, device=dev)
        table = {}
        for key, mode in MODES:
            best, _ = best_of(lambda: gram_matvec((1.0, terms), xt, xt, vt, mode), 3)
            table[key] = dict(seconds=best, gpairs=n_thr * n_thr / best / 1e9)
            _log(f"  {mode} matvec at n={n_thr}: {best * 1e3:.3f} ms = {table[key]['gpairs']:.1f} G pair/s")
        slowdown = table["compensated"]["seconds"] / table["plain"]["seconds"]
        _log(f"ff cost: {slowdown:.2f}x the plain matvec")

        payload = {
            "experiment": "gram_noise_floor",
            "n_accuracy": n_acc,
            "plain": results["plain"],
            "compensated": results["compensated"],
            "coherent_reduction_x": ratio,
            "n_throughput": n_thr,
            "throughput": table,
            "compensated_slowdown_x": slowdown,
        }
        print(json.dumps(payload))
        return payload


if __name__ == "__main__":
    main(device=cli_args(__doc__.splitlines()[0]).device)
