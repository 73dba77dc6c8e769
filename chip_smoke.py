#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``linpde_gp_tpu_torch``) on one GPU.

    python3 chip_smoke.py                    # every phase, the full problems
    python3 chip_smoke.py --phases device,build,kernels   # quick kernel check

Phases, each printed as it finishes:

1. device   - the card's name and power limit (nvidia-smi), torch and CUDA
              versions; fails without a CUDA device.
2. build    - compiles ``linpde_gp_tpu_torch/csrc/*.cu`` with nvcc (sm_90a),
              one nvcc per source in parallel, into ``build/`` and loads it;
              prints seconds and ptxas usage.
3. kernels  - each kernel in the modes plain, ff and f64 against its plain
              PyTorch version on the card: K1 (Gram) and K2 (Gram matvec) on
              the heat benchmark specs at shapes up to 2048 with r in {1, 4};
              the banded matvec on two compactly supported specs (the 1-D
              Wendland experiment kernel and a 2-D d/dx0 Wendland tensor
              product) at 3000 x 4000 unsorted points with r in {1, 4},
              also against dense K2 on the same inputs.
4. timing   - each kernel beside its plain version at the main paths' shapes:
              K2 at N x N and (cross kernel) nq x N with r = 1, K1 at
              N x rank and rank x rank; the banded matvec at N x N, r = 1, on
              the Wendland data, beside dense K2 on the same spec, with the
              band fraction.
5. main     - both main paths through the library's entry points
              (``IterativeGPRegressor(prior, X, Y, L=...)``,
              ``.representer_weights`` and ``.mean``), mode ff and then mode
              f64, the launch counts set to 0 before each run and read after:
              - heat: N = 100,000 heat collocation points drawn as bench.py
                draws them (seed 0, float32), L = HeatOperator((2,), 0.1),
                nq = 8,192, Nystrom rank min(8192, N // 4), noise 1e-3 k(0),
                tol 1e-5.  The derived specs must equal
                ``data/heat_bench_specs.json``; K1 and K2 must launch.
              - Wendland: ``experiments/wendland_banded_tpu.py``'s problem:
                2 * Wendland(k=2, l=0.05) on N = 100,000 sorted uniform
                points of [0, 1] (seed 0), Y = sin(8 X), noise 1e-3, tol
                1e-5, rank 1024; nq = 8,192.  It must be banded-routed and
                launch K1 (Nystrom blocks), the banded matvec (CG) and K2
                (mean).
              Each checks finite weights, the solver's relres and the true
              relres recomputed by the float64 plain version, and the mean
              at 64 queries against the float64 plain version.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``, printed only if every phase
passed.  The script never imports JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
import traceback

import numpy as np

PHASES = ("device", "build", "kernels", "timing", "main")
# name -> (TPU kernel(s) it replaces, label, source)
KERNELS = {
    "gram": ("linpde_gp_tpu/ops/pallas_gram.py:277", "K1", "linpde_gp_tpu_torch/csrc/gram.cu"),
    "gram_matvec": ("linpde_gp_tpu/ops/pallas_gram.py:393", "K2", "linpde_gp_tpu_torch/csrc/gram.cu"),
    "banded_matvec": (
        "linpde_gp_tpu/ops/pallas_gram.py:664, linpde_gp_tpu/ops/pallas_gram.py:728",
        "K3+K4",
        "linpde_gp_tpu_torch/csrc/banded.cu",
    ),
}
WENDLAND_RANK = 1024

failures: list[str] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    log(f"  [{'pass' if ok else 'FAIL'}] {what}")
    if not ok:
        failures.append(what)


def bench_data(n: int, nq: int):
    """The heat benchmark problem's data, drawn exactly as bench.py draws it."""
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], axis=-1).astype(np.float32)
    Y = rng.standard_normal(n).astype(np.float32)
    Xq = np.stack([rng.uniform(0.0, 5.0, nq), rng.uniform(-1.0, 1.0, nq)], axis=-1).astype(np.float32)
    return X, Y, Xq


def wendland_data(n: int, nq: int):
    """The Wendland experiment's data (``experiments/wendland_banded_tpu.py``):
    sorted points, a right-hand side ``v`` for the matvec timing and ``Y``,
    drawn in that order from seed 0; then ``nq`` query points."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0.0, 1.0, n))
    v = rng.standard_normal(n)
    Y = np.sin(8.0 * X)
    Xq = rng.uniform(0.0, 1.0, nq)
    return X, v, Y, Xq


def heat_problem():
    """The heat benchmark's prior and operator (``bench.py::_build_kernels``)."""
    from linpde_gp_tpu_torch import GaussianProcess
    from linpde_gp_tpu_torch.models.functions import Zero
    from linpde_gp_tpu_torch.ops import kernels
    from linpde_gp_tpu_torch.ops.diffops import HeatOperator

    prior = GaussianProcess(
        Zero((2,)),
        1.0 * kernels.TensorProduct(
            kernels.Matern((), nu=1.5, lengthscales=2.5), kernels.Matern((), nu=2.5, lengthscales=2.0)
        ),
    )
    return prior, HeatOperator((2,), alpha=0.1)


def heat_specs() -> dict:
    """The heat benchmark's observation (``H k H*``) and cross (``H k``)
    specs, derived by the port's symbolic layer."""
    from linpde_gp_tpu_torch.ops.gram import kernel_term_specs
    from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel

    prior, H = heat_problem()
    k_cross = apply_operator_to_kernel(H, prior.cov, argnum=1)
    return {
        "obs": kernel_term_specs(apply_operator_to_kernel(H, k_cross, argnum=0)),
        "cross": kernel_term_specs(k_cross),
    }


def wendland_prior():
    from linpde_gp_tpu_torch import GaussianProcess
    from linpde_gp_tpu_torch.models.functions import Zero
    from linpde_gp_tpu_torch.ops.kernels import WendlandCovarianceFunction

    return GaussianProcess(Zero(()), 2.0 * WendlandCovarianceFunction((), k=2, lengthscales=0.05))


def wendland_specs() -> dict:
    """The banded kernel's check specs: the 1-D experiment kernel, and
    d/dx0 (W(k=2, l=0.08) x W(k=2, l=0.3)) d/dx0* in 2-D."""
    from linpde_gp_tpu_torch.ops import kernels
    from linpde_gp_tpu_torch.ops.diffops import PartialDerivative
    from linpde_gp_tpu_torch.ops.gram import kernel_term_specs
    from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel

    k2 = kernels.TensorProduct(
        kernels.WendlandCovarianceFunction((), k=2, lengthscales=0.08),
        kernels.WendlandCovarianceFunction((), k=2, lengthscales=0.3),
    )
    D = PartialDerivative((1, 0))
    return {
        "1d": kernel_term_specs(wendland_prior().cov),
        "2d": kernel_term_specs(apply_operator_to_kernel(D, apply_operator_to_kernel(D, k2, argnum=1), argnum=0)),
    }


def sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn, reps: int = 1):
    """Mean milliseconds of ``fn()`` over ``reps`` runs (CUDA events), and
    its last result."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


# -- phases ----------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this script needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi: unavailable")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap} is sm_90")


def phase_build():
    from linpde_gp_tpu_torch.ops import _cuda

    _cuda.library()
    log(f"build: {_cuda.build_seconds:.1f} s")
    if _cuda.build_log:
        path = _cuda.BUILD_DIR / "nvcc.log"
        path.write_text(_cuda.build_log)
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", _cuda.build_log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", _cuda.build_log)]
        log(f"ptxas: {len(regs)} kernels, registers {min(regs, default=0)}..{max(regs, default=0)}, "
            f"spill stores up to {max(spills, default=0)} bytes (full log: {path})")


def phase_kernels(specs, k0, device="cuda"):
    """K1 and K2 in each mode against their plain versions on the card."""
    import torch

    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.ops.gram import gram, gram_matvec, gram_matvec_plain, gram_plain

    dev = torch.device(device)
    rng = np.random.default_rng(1)

    def pts(n):
        return np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], -1)

    X0np, X1np = pts(1536), pts(2048)
    for name in ("obs", "cross"):
        spec = specs[name]
        scale, terms = spec
        X0 = {m: torch.tensor(X0np, dtype=torch.float64 if m == "f64" else torch.float32, device=dev)
              for m in ("plain", "ff", "f64")}
        X1 = {m: torch.tensor(X1np, dtype=torch.float64 if m == "f64" else torch.float32, device=dev)
              for m in ("plain", "ff", "f64")}
        # The f64 plain version on the float32 points: the oracle of the ff checks.
        x0_32, x1_32 = X0["ff"].double(), X1["ff"].double()
        oracle_k1 = scale * gram_plain(terms, x0_32, x1_32, "f64")
        # Entry scale: k(0) for H k H*; the cross kernel H k peaks away from 0.
        kd = max(k0[name], oracle_k1.abs().max().item())

        for mode in ("plain", "ff", "f64"):
            K = scale * gram(terms, X0[mode], X1[mode], mode)
            P = scale * gram_plain(terms, X0[mode], X1[mode], mode)
            sync()
            err = (K.double() - P.double()).abs().max().item()
            if mode == "f64":
                check(err <= 1e-12 * kd, f"K1 {name} f64 vs plain f64: {err / kd:.3e} k(0) <= 1e-12")
            elif mode == "plain":
                check(err <= 1e-5 * kd, f"K1 {name} plain vs plain f32: {err / kd:.3e} k(0) <= 1e-5")
            else:
                e64 = (K.double() - oracle_k1).abs().max().item()
                check(e64 <= 1e-7 * kd, f"K1 {name} ff vs plain f64: {e64 / kd:.3e} k(0) <= 1e-7 "
                      f"(vs plain ff: {err / kd:.3e})")
                if name == "obs":  # H k H* is symmetric; the cross kernel H k is not
                    S = gram(terms, X0["ff"], X0["ff"], "ff")
                    sync()
                    asym = (S - S.T).abs().max().item()
                    check(asym == 0.0, f"K1 {name} ff exactly symmetric on (X, X): max |K - K^T| = {asym}")

        for r in (1, 4):
            vnp = rng.standard_normal((2048, r))
            v64 = torch.tensor(vnp, dtype=torch.float64, device=dev)
            v32 = v64.float()
            oracle = gram_matvec_plain(spec, x0_32, x1_32, v32.double(), "f64")
            for mode in ("plain", "ff", "f64"):
                v = v64 if mode == "f64" else v32
                out = gram_matvec(spec, X0[mode], X1[mode], v, mode)
                ref = gram_matvec_plain(spec, X0[mode], X1[mode], v, mode)
                sync()
                sc = ref.abs().max().item()
                err = (out.double() - ref.double()).abs().max().item()
                if mode == "f64":
                    check(err <= 1e-12 * sc, f"K2 {name} r={r} f64 vs plain f64: {err / sc:.3e} rel <= 1e-12")
                elif mode == "plain":
                    check(err <= 1e-5 * sc, f"K2 {name} r={r} plain vs plain f32: {err / sc:.3e} rel <= 1e-5")
                else:
                    e64 = (out.double() - oracle).abs().max().item() / oracle.abs().max().item()
                    check(e64 <= 3e-6, f"K2 {name} r={r} ff vs f64 product: {e64:.3e} rel <= 3e-6 "
                          f"(vs plain ff: {err / sc:.3e})")
    log(f"kernel launches in this phase: {dict(_cuda.launches)}")


def phase_banded_kernels(wspecs, device="cuda"):
    """The banded matvec in each mode against its plain version and dense
    K2 on the card, on unsorted points.  Bounds are in units of eps of the
    mode times max_i sum_j |k_ij v_j| (the f64 plain version): the plain
    body sums f32 tiles of ``matvec_tile`` terms (tile + 2), f64 sums a few
    thousand terms (64).  ff carries the product and the sum in ff and
    rounds at the end (and once more where the spec's scale is not a power
    of two), so it is within one rounding of the f64 product on the same
    f32 inputs: two ff results differ by at most 2 x 0.5, one from the f64
    product by 0.5 (the ff arithmetic's own error is O(eps^2)).

    Row by row, ff must be the f64 product rounded: within eps |k v|_i
    plus 1e-3 eps sum_j |k_ij v_j|.  A body that sums in f32 misses that
    by ~0.3 eps sum_j |k_ij v_j| (a CPU estimate): the TPU's K3/K4 sum (ff
    entries, hi v and lo v summed in f32) and the plain body, both formed
    here on the same inputs, must fail it."""
    import torch

    from linpde_gp_tpu_torch.config import config
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.ops.banded import make_banded_matvec
    from linpde_gp_tpu_torch.ops.gram import _collapse_terms, _eval_block, gram_matvec, gram_plain

    dev = torch.device(device)
    rng = np.random.default_rng(3)
    eps32 = torch.finfo(torch.float32).eps
    row_bound = 1e-3
    for name, spec in wspecs.items():
        scale, terms = spec
        d = len(terms[0][1])
        X0np = rng.uniform(0.0, 1.0, (3000, d))
        X1np = rng.uniform(0.0, 1.0, (4000, d))
        # The f64 oracle on the f32-rounded points.
        x0_32 = torch.tensor(X0np, device=dev).float().double()
        x1_32 = torch.tensor(X1np, device=dev).float().double()
        absG = (scale * gram_plain(terms, x0_32, x1_32, "f64")).abs()
        mv64 = make_banded_matvec(spec, x0_32, x1_32, mode="f64")
        # The ff entries, for the TPU bodies' f32 sum of hi v and lo v.
        K_hi, K_lo = _eval_block(_collapse_terms(tuple(terms)), x0_32.float(), x1_32.float(), "ff")
        for r in (1, 4):
            vnp = rng.standard_normal((4000, r))
            v64 = torch.tensor(vnp, dtype=torch.float64, device=dev)
            v32 = v64.float()
            row_absum = absG @ v32.double().abs()
            absum = row_absum.max().item()
            oracle = mv64.plain(v32.double())
            outs = {}
            for mode in ("plain", "ff", "f64"):
                dt = torch.float64 if mode == "f64" else torch.float32
                X0 = torch.tensor(X0np, dtype=dt, device=dev)
                X1 = torch.tensor(X1np, dtype=dt, device=dev)
                v = v64 if mode == "f64" else v32
                mv = make_banded_matvec(spec, X0, X1, mode=mode)
                out = outs[mode] = mv(v)
                ref = mv.plain(v)
                dense = gram_matvec(spec, X0, X1, v, mode)
                sync()
                eps = torch.finfo(dt).eps
                bound = {"plain": config.matvec_tile + 2, "ff": 1.0, "f64": 64.0}[mode] * eps * absum
                e_plain = (out.double() - ref.double()).abs().max().item()
                e_dense = (out.double() - dense.double()).abs().max().item()
                tag = f"banded {name} {mode} r={r} (band {mv.band_tiles}/{mv.total_tiles} tiles)"
                check(e_plain <= bound, f"{tag} vs plain: {e_plain / (eps * absum):.3g} eps sum|k v| "
                      f"<= {bound / (eps * absum):g}")
                check(e_dense <= bound, f"{tag} vs dense K2: {e_dense / (eps * absum):.3g} eps sum|k v| "
                      f"<= {bound / (eps * absum):g}")
                if mode == "ff":
                    e64 = (out.double() - oracle).abs().max().item()
                    check(e64 <= 0.5 * eps * absum, f"{tag} vs f64 product: {e64 / (eps * absum):.3g} "
                          "eps sum|k v| <= 0.5")
                # An ff right-hand side with a nonzero lo plane.
                if mode == "ff" and r == 4:
                    lo = (v64 - v32.double()).float()
                    out2 = mv((v32, lo))
                    ref2 = mv64.plain(v32.double() + lo.double())
                    sync()
                    e2 = (out2.double() - ref2).abs().max().item()
                    check(e2 <= 0.5 * eps * absum, f"{tag} ff pair rhs vs f64 product: "
                          f"{e2 / (eps * absum):.3g} eps sum|k v| <= 0.5")

            def row_excess(o):
                """max_i (|o_i - f64_i| - eps |f64_i|) / (eps sum_j |k_ij v_j|); a row
                with no neighbour must be exactly 0 (0/0 reads 0, x/0 inf)."""
                e = ((o.double() - oracle).abs() - eps32 * oracle.abs()).clamp(min=0)
                return torch.nan_to_num(e / (eps32 * row_absum), nan=0.0).max().item()

            tpu = scale * (K_hi @ v32 + K_lo @ v32)
            sync()
            tag = f"banded {name} r={r}"
            e_ff, e_tpu, e_plain32 = row_excess(outs["ff"]), row_excess(tpu), row_excess(outs["plain"])
            e_tpu_max = (tpu.double() - oracle).abs().max().item() / (eps32 * absum)
            check(e_ff <= row_bound, f"{tag} ff is the f64 product rounded, row by row: "
                  f"excess {e_ff:.3g} eps sum_j|k_ij v_j| <= {row_bound:g}")
            check(e_tpu > row_bound and e_plain32 > row_bound,
                  f"{tag} f32 sums fail that bound: TPU-style ff sum {e_tpu:.3g}, plain body {e_plain32:.3g} "
                  f"> {row_bound:g} (the TPU-style sum reads {e_tpu_max:.3g} eps max sum|k v| vs the f64 product)")
        del absG, K_hi, K_lo
        torch.cuda.empty_cache()
    log(f"kernel launches in this phase: {dict(_cuda.launches)}")


def phase_timing(specs, n, nq, rank):
    """K1 and K2 vs their plain versions at the heat path's shapes, per mode."""
    import torch

    from linpde_gp_tpu_torch.ops.gram import gram, gram_matvec, gram_matvec_plain, gram_plain
    from linpde_gp_tpu_torch.ops.linalg.pcg import landmark_indices

    spec, cross = specs["obs"], specs["cross"]
    scale, terms = spec
    X, _, Xq = bench_data(n, nq)
    idx = landmark_indices(n, rank)
    v_np = np.random.default_rng(2).standard_normal(n)
    rows = {}
    for mode in ("ff", "f64", "plain"):
        dt = torch.float64 if mode == "f64" else torch.float32
        Xd = torch.tensor(X, device="cuda").to(dt)
        Zd = Xd[idx.to("cuda")].contiguous()
        Qd = torch.tensor(Xq, device="cuda").to(dt)
        v = torch.tensor(v_np, device="cuda").to(dt)
        # The CG hands K2 its direction as an ff pair in mode ff.
        v_main = (v, v * 1e-8) if mode == "ff" else v
        # warm-up launches (and cuBLAS/allocator set-up) at small shapes
        gram(terms, Zd[:256], Zd[:256], mode)
        gram_plain(terms, Zd[:256], Zd[:256], mode)
        gram_matvec(spec, Zd[:256], Zd[:256], v[:256], mode)
        gram_matvec_plain(spec, Zd[:256], Zd[:256], v[:256], mode)
        sync()
        row = {}
        for key, fk, fp in (
            ("gram_zz", lambda: gram(terms, Zd, Zd, mode), lambda: gram_plain(terms, Zd, Zd, mode)),
            ("gram_xz", lambda: gram(terms, Xd, Zd, mode), lambda: gram_plain(terms, Xd, Zd, mode)),
            ("gram_matvec_xx", lambda: gram_matvec(spec, Xd, Xd, v_main, mode),
             lambda: gram_matvec_plain(spec, Xd, Xd, v_main, mode)),
            # the posterior mean: cross kernel at nq x N
            ("gram_matvec_qx", lambda: gram_matvec(cross, Qd, Xd, v_main, mode),
             lambda: gram_matvec_plain(cross, Qd, Xd, v_main, mode)),
        ):
            ms, out = timed(fk, reps=3)
            pms, ref = timed(fp, reps=1)
            err = (out.double() - ref.double()).abs().max().item()
            sc = ref.abs().max().item()
            del out, ref
            torch.cuda.empty_cache()
            row[key] = {"ms": ms, "plain_ms": pms, "max_abs_err": err, "rel_err": err / sc}
            log(f"  {mode:5s} {key:15s} kernel {ms:10.3f} ms  plain {pms:10.3f} ms  "
                f"max|kernel - plain| {err:.3e} ({err / sc:.3e} of max)")
            # K1 entries match bit for bit; K2 sums 1e5 terms in another order
            # than its plain version (f32 in plain mode, ff vs f64 in ff mode).
            bound = {"plain": 1e-4, "ff": 1e-6, "f64": 1e-10}[mode]
            check(np.isfinite(err) and err <= bound * sc, f"{mode} {key} at full shape within {bound:g} of max")
        rows[mode] = row
        del Xd, Zd, Qd, v, v_main
        torch.cuda.empty_cache()
    return rows


def phase_banded_timing(n):
    """The banded matvec vs its plain version and dense K2 on the Wendland
    experiment's spec and data at N x N, r = 1, per mode."""
    import torch

    from linpde_gp_tpu_torch.ops.banded import make_banded_matvec
    from linpde_gp_tpu_torch.ops.gram import gram_matvec

    spec = wendland_specs()["1d"]
    X, v_np, _, _ = wendland_data(n, 0)
    rows = {}
    for mode in ("ff", "f64", "plain"):
        dt = torch.float64 if mode == "f64" else torch.float32
        Xd = torch.tensor(X, device="cuda").to(dt)
        v = torch.tensor(v_np, device="cuda").to(dt)
        v_main = (v, v * 1e-8) if mode == "ff" else v
        t0 = time.perf_counter()
        mv = make_banded_matvec(spec, Xd, Xd, mode=mode)
        sync()
        setup_s = time.perf_counter() - t0
        mv(v_main)  # warm-up
        gram_matvec(spec, Xd[:256], Xd[:256], v[:256], mode)
        sync()
        ms, out = timed(lambda: mv(v_main), reps=5)
        pms, ref = timed(lambda: mv.plain(v_main), reps=1)
        dms, dense = timed(lambda: gram_matvec(spec, Xd, Xd, v_main, mode), reps=1)
        sc = ref.abs().max().item()
        err = (out.double() - ref.double()).abs().max().item()
        err_dense = (out.double() - dense.double()).abs().max().item()
        row = {"ms": ms, "plain_ms": pms, "dense_k2_ms": dms, "max_abs_err": err, "rel_err": err / sc,
               "rel_err_vs_dense": err_dense / sc, "setup_s": setup_s, "band_tiles": mv.band_tiles,
               "total_tiles": mv.total_tiles, "band_fraction": mv.band_tiles / mv.total_tiles,
               "pair_fraction": mv.pair_fraction}
        rows[mode] = row
        log(f"  {mode:5s} banded {n}x{n} r=1: kernel {ms:10.3f} ms  plain {pms:10.3f} ms  dense K2 {dms:10.3f} ms  "
            f"band {mv.band_tiles}/{mv.total_tiles} tiles ({100 * row['band_fraction']:.2f} %), pairs "
            f"{100 * mv.pair_fraction:.2f} %; max|kernel - plain| {err:.3e} ({err / sc:.3e} of max), "
            f"vs dense {err_dense / sc:.3e}; schedule set-up {setup_s:.3f} s")
        # ff: two results each within one rounding of the f64 product, held
        # well under what the f32-summing plain body reads here (~6e-7).
        bound = {"plain": 1e-4, "ff": 1e-8, "f64": 1e-10}[mode]
        check(np.isfinite(err) and err <= bound * sc, f"{mode} banded at full shape within {bound:g} of max")
        check(np.isfinite(err_dense) and err_dense <= bound * sc, f"{mode} banded vs dense K2 within {bound:g}")
        del Xd, v, v_main, out, ref, dense, mv
        torch.cuda.empty_cache()
    return rows


def _check_solution(reg, w, mu, Xq, mode, tol, sigma_sq, true_matvec, path):
    """Checks shared by both paths: finite weights and mean, the solver's
    relres, the true relres by the float64 plain version, and the mean at 64
    queries against the float64 plain version.  Returns the measurements."""
    import torch

    from linpde_gp_tpu_torch.config import config
    from linpde_gp_tpu_torch.ops.gram import gram_plain

    iters, relres = reg.solve_info
    nq = Xq.shape[0]
    check(bool(torch.isfinite(w).all()), f"{path}[{mode}]: representer weights finite")
    check(relres <= 100 * tol, f"{path}[{mode}]: solver relres {relres:.3e} <= {100 * tol:g}")
    check(mu.shape == (nq,) and bool(torch.isfinite(mu).all()), f"{path}[{mode}]: mean finite, shape {tuple(mu.shape)}")

    # True residual ||(K + s I) w - y|| / ||y|| by the float64 plain version.
    X64 = reg.X.double()
    w64, y64 = w.double(), reg.Y.double()
    t0 = time.perf_counter()
    r = true_matvec(X64, w64) + sigma_sq * w64 - y64
    true_relres = (torch.linalg.vector_norm(r) / torch.linalg.vector_norm(y64)).item()
    # The same with the weights rounded to float32: what storing w in f32 alone costs.
    w_r = w.float().double()
    r = true_matvec(X64, w_r) + sigma_sq * w_r - y64
    true_relres_w32 = (torch.linalg.vector_norm(r) / torch.linalg.vector_norm(y64)).item()
    # The mean at 64 queries from the same weights: |K_qX| |w| bounds the
    # rounding of the sum, which cancels heavily at small noise.
    scale_c, terms_c = reg._cross_spec
    # The queries as the regressor holds them (rounded to its dtype).
    xq64 = torch.as_tensor(Xq[:64]).reshape(min(64, nq), -1).to(reg.X).double()
    K_qX = scale_c * gram_plain(terms_c, xq64, X64, "f64")
    mu_ref = K_qX @ w64
    absum = K_qX.abs() @ w64.abs()
    sync()
    t_check = time.perf_counter() - t0
    err = (mu[:64].double() - mu_ref).abs()
    mean_err = (err.max() / mu_ref.abs().max()).item()
    eps = torch.finfo(reg.X.dtype).eps
    sum_err = (err / (eps * absum)).max().item()
    check(true_relres <= 100 * tol, f"{path}[{mode}]: true relres (f64 plain version) {true_relres:.3e} "
          f"<= {100 * tol:g}")
    # Rounding bound of the mean, in units of eps * sum|k w|: plain K2 sums
    # f32 tiles of <= matvec_tile terms (tile + 2); ff K2 carries the sum in
    # ff, so only the final f32 rounding is left (1); f64 sums 1e5 terms (64).
    bound = {"plain": config.matvec_tile + 2, "ff": 1.0, "f64": 64.0}[mode]
    check(sum_err <= bound, f"{path}[{mode}]: mean at 64 queries vs f64 plain version: {mean_err:.3e} of "
          f"max |mean|, {sum_err:.3g} eps sum|k w| <= {bound:g}")
    return dict(
        iterations=iters, relres=relres, true_relres=true_relres, true_relres_w_f32=true_relres_w32,
        w_absmax=w.abs().max().item(), mean_err=mean_err, mean_err_eps_sum=sum_err,
        sum_cancellation=(absum.max() / mu_ref.abs().max()).item(), check_s=t_check,
    )


def _solve_and_mean(make_reg, Xq):
    """Construct the regressor, build the preconditioner, solve, evaluate
    the mean; host seconds of each.  ``build_s`` spans the constructor
    (specs, device copies, the banded schedule) and the Nystrom build."""
    import torch

    t0 = time.perf_counter()
    reg = make_reg()
    sync()
    t_construct = time.perf_counter() - t0
    reg._preconditioner()
    sync()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    w = reg.representer_weights
    sync()
    t_solve = time.perf_counter() - t0
    t0 = time.perf_counter()
    mu = reg.mean(torch.from_numpy(Xq))
    sync()
    t_mean = time.perf_counter() - t0
    return reg, w, mu, dict(construct_s=t_construct, build_s=t_build, solve_s=t_solve, mean_s=t_mean)


def run_main_path(specs, k0, mode, n, nq, rank, *, device="cuda", tol=1e-5, maxiter=512, noise_rel=1e-3):
    """The heat benchmark problem through ``IterativeGPRegressor(prior, X, Y,
    L=H)``; ``specs``: the specs it must derive (``data/heat_bench_specs.json``)."""
    import torch

    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu_torch.ops.gram import gram_matvec_plain

    X, Y, Xq = bench_data(n, nq)
    sigma_sq = float(noise_rel * k0["obs"])
    prior, H = heat_problem()
    reg, w, mu, times = _solve_and_mean(lambda: IterativeGPRegressor(
        prior, torch.from_numpy(X), torch.from_numpy(Y), L=H,
        noise_variance=sigma_sq, tol=tol, maxiter=maxiter, precond_rank=rank, mode=mode, device=device,
    ), Xq)
    check(reg._obs_spec == specs["obs"] and reg._cross_spec == specs["cross"],
          f"heat[{mode}]: derived specs equal data/heat_bench_specs.json")
    check(reg._banded is None, f"heat[{mode}]: dense K2 route (no compact support)")
    res = _check_solution(
        reg, w, mu, Xq, mode, tol, sigma_sq,
        lambda X64, w64: gram_matvec_plain(reg._obs_spec, X64, X64, w64, "f64"), "heat",
    )
    out = dict(mode=mode, n=n, nq=nq, rank=rank, noise=sigma_sq, **res, **times)
    log(f"main[heat {mode}] " + json.dumps(out))
    return out


def run_wendland_path(mode, n, nq, rank, *, device="cuda", tol=1e-5, maxiter=512, noise=1e-3):
    """The Wendland experiment's problem through
    ``IterativeGPRegressor(prior, X, Y)``: banded CG, dense K2 mean."""
    import torch

    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu_torch.ops.banded import make_banded_matvec

    X, _, Y, Xq = wendland_data(n, nq)
    reg, w, mu, times = _solve_and_mean(lambda: IterativeGPRegressor(
        wendland_prior(), torch.from_numpy(X), torch.from_numpy(Y),
        noise_variance=noise, tol=tol, maxiter=maxiter, precond_rank=rank, mode=mode, device=device,
    ), Xq)
    banded = reg._banded
    check(banded is not None, f"wendland[{mode}]: banded-routed")
    band = {} if banded is None else dict(
        band_tiles=banded.band_tiles, total_tiles=banded.total_tiles, pair_fraction=banded.pair_fraction
    )

    def true_matvec(X64, w64):
        return make_banded_matvec(reg._obs_spec, X64, X64, mode="f64").plain(w64)

    res = _check_solution(reg, w, mu, Xq, mode, tol, noise, true_matvec, "wendland")
    out = dict(mode=mode, n=n, nq=nq, rank=rank, noise=noise, **band, **res, **times)
    log(f"main[wendland {mode}] " + json.dumps(out))
    return out


def phase_main(specs, k0, n, nq, rank) -> dict:
    """Both paths in modes ff and f64, the launch counts set to 0 before
    each run and read after; returns the launches summed over the runs."""
    from linpde_gp_tpu_torch.ops import _cuda

    needed = {"heat": ("gram", "gram_matvec"), "wendland": ("gram", "banded_matvec", "gram_matvec")}
    total = {name: 0 for name in KERNELS}
    for path in ("heat", "wendland"):
        for mode in ("ff", "f64"):
            _cuda.reset_launches()
            try:
                if path == "heat":
                    run_main_path(specs, k0, mode, n, nq, rank)
                else:
                    run_wendland_path(mode, n, nq, WENDLAND_RANK)
            except Exception as exc:  # noqa: BLE001 - report, go on with the next run, fail at the end
                traceback.print_exc()
                failures.append(f"main[{path} {mode}]: {type(exc).__name__}: {exc}")
            per = dict(_cuda.launches)
            for name in total:
                total[name] += per[name]
            log(f"main[{path} {mode}] launches {per}")
            check(all(per[k] > 0 for k in needed[path]), f"main[{path} {mode}] launched {needed[path]}: {per}")
    for name in KERNELS:
        check(total[name] > 0, f"main paths launched {name} {total[name]} times")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES for p in phases):
        ap.error(f"phases are {PHASES}")
    n, nq = 100_000, 8192  # the benchmark problems, uncut
    rank = min(8192, n // 4)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script runs only on a GPU", file=sys.stderr)
        return 2
    import linpde_gp_tpu_torch  # noqa: F401  (sets the float32 matmul precision)
    from linpde_gp_tpu_torch.specs import load_specs, spec_diagonal

    specs = load_specs()
    derived = heat_specs()
    k0 = {name: spec_diagonal(s) for name, s in specs.items()}
    log(f"allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}")

    timing, banded_timing = {}, {}
    launches = {}
    for phase in PHASES:
        if phase not in phases and phase not in ("device", "build"):
            continue
        log(f"== {phase}")
        t0 = time.perf_counter()
        try:
            if phase == "device":
                phase_device()
            elif phase == "build":
                phase_build()
            elif phase == "kernels":
                check(derived == specs, "the symbolic layer derives data/heat_bench_specs.json")
                phase_kernels(derived, k0)
                phase_banded_kernels(wendland_specs())
            elif phase == "timing":
                timing = phase_timing(derived, n, nq, rank)
                banded_timing = phase_banded_timing(n)
            else:
                launches = phase_main(specs, k0, n, nq, rank)
        except Exception as exc:  # noqa: BLE001 - every phase reports, then the script fails
            traceback.print_exc()
            failures.append(f"phase {phase}: {type(exc).__name__}: {exc}")
            if phase in ("device", "build"):
                break
        log(f"== {phase} done in {time.perf_counter() - t0:.1f} s")

    entries = []
    for name, (replaces, label, source) in KERNELS.items():
        if name == "gram":
            key, shape = "gram_xz", f"{n}x{rank}"
            modes = {m: {"x_z": row.get("gram_xz"), "z_z": row.get("gram_zz")} for m, row in timing.items()}
            ff_row = (timing.get("ff") or {}).get(key) or {}
        elif name == "gram_matvec":
            key, shape = "gram_matvec_xx", f"{n}x{n}, r=1"
            modes = {m: {"x_x": row.get(key), "q_x": row.get("gram_matvec_qx")} for m, row in timing.items()}
            ff_row = (timing.get("ff") or {}).get(key) or {}
        else:
            shape = f"{n}x{n}, r=1, Wendland l=0.05"
            modes = banded_timing
            ff_row = banded_timing.get("ff") or {}
        entries.append({
            "name": name, "label": label, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches.get(name, 0), "max_abs_err": ff_row.get("max_abs_err"),
            "ms": ff_row.get("ms"), "plain_ms": ff_row.get("plain_ms"), "mode": "ff", "shape": shape,
            "modes": modes,
        })
    log(json.dumps({"kernels": entries}))
    if set(phases) != set(PHASES):
        log(f"partial run ({','.join(phases)}): no result line")
        return 1 if failures else 0
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
