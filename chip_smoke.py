#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``linpde_gp_tpu_torch``) on one GPU.

    python3 chip_smoke.py                    # every phase, the full problem
    python3 chip_smoke.py --phases device,build,kernels   # quick kernel check

Phases, each printed as it finishes:

1. device   - the card's name and power limit (nvidia-smi), torch and CUDA
              versions; fails without a CUDA device.
2. build    - compiles ``linpde_gp_tpu_torch/csrc`` with nvcc (sm_90a) into
              ``build/`` and loads it; prints seconds and ptxas usage.
3. kernels  - K1 (Gram) and K2 (Gram matvec) in the modes plain, ff and f64
              against their plain PyTorch versions on the card, on the heat
              benchmark spec, at shapes up to 2048 with r in {1, 4}.
4. timing   - each kernel beside its plain version at the main path's shapes:
              K2 at N x N and (cross kernel) nq x N with r = 1, K1 at
              N x rank and rank x rank.
5. main     - the main path through the library's entry points
              (``IterativeGPRegressor(...).representer_weights`` and
              ``.mean``), mode ff and then mode f64, on the benchmark problem:
              N = 100,000 heat collocation points drawn as bench.py draws
              them (seed 0, float32), nq = 8,192, Nystrom rank
              min(8192, N // 4), noise 1e-3 k(0), tol 1e-5.  Checks finite
              weights, the solver's relres and the true relres recomputed by
              the float64 plain version, the mean at 64 queries against the
              float64 plain version, and that both kernels were launched.

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
KERNELS = {
    "gram": ("linpde_gp_tpu/ops/pallas_gram.py:277", "K1"),
    "gram_matvec": ("linpde_gp_tpu/ops/pallas_gram.py:393", "K2"),
}
SOURCE = "linpde_gp_tpu_torch/csrc/gram.cu"

failures: list[str] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    log(f"  [{'pass' if ok else 'FAIL'}] {what}")
    if not ok:
        failures.append(what)


def bench_data(n: int, nq: int):
    """The benchmark problem's data, drawn exactly as bench.py draws it."""
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], axis=-1).astype(np.float32)
    Y = rng.standard_normal(n).astype(np.float32)
    Xq = np.stack([rng.uniform(0.0, 5.0, nq), rng.uniform(-1.0, 1.0, nq)], axis=-1).astype(np.float32)
    return X, Y, Xq


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
    """Each kernel in each mode against its plain version on the card."""
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


def phase_timing(specs, n, nq, rank):
    """Kernel vs plain version at the main path's shapes, per mode."""
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


def run_main_path(specs, k0, mode, n, nq, rank, *, device="cuda", tol=1e-5, maxiter=512, noise_rel=1e-3):
    """The benchmark problem through the regressor's entry points."""
    import torch

    from linpde_gp_tpu_torch.config import config
    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu_torch.ops.gram import gram_matvec_plain, gram_plain

    X, Y, Xq = bench_data(n, nq)
    sigma_sq = float(noise_rel * k0["obs"])
    t0 = time.perf_counter()
    reg = IterativeGPRegressor(
        specs["obs"], specs["cross"], torch.from_numpy(X), torch.from_numpy(Y),
        noise_variance=sigma_sq, tol=tol, maxiter=maxiter, precond_rank=rank, mode=mode, device=device,
    )
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
    iters, relres = reg.solve_info

    check(bool(torch.isfinite(w).all()), f"{mode}: representer weights finite")
    check(relres <= 100 * tol, f"{mode}: solver relres {relres:.3e} <= {100 * tol:g}")
    check(mu.shape == (nq,) and bool(torch.isfinite(mu).all()), f"{mode}: mean finite, shape {tuple(mu.shape)}")

    # True residual ||(K + s I) w - y|| / ||y|| by the float64 plain version.
    X64 = reg.X.double()
    w64, y64 = w.double(), reg.Y.double()
    t0 = time.perf_counter()
    r = gram_matvec_plain(specs["obs"], X64, X64, w64, "f64") + sigma_sq * w64 - y64
    true_relres = (torch.linalg.vector_norm(r) / torch.linalg.vector_norm(y64)).item()
    # The same with the weights rounded to float32: what storing w in f32 alone costs.
    w_r = w.float().double()
    r = gram_matvec_plain(specs["obs"], X64, X64, w_r, "f64") + sigma_sq * w_r - y64
    true_relres_w32 = (torch.linalg.vector_norm(r) / torch.linalg.vector_norm(y64)).item()
    # The mean at 64 queries from the same weights: |K_qX| |w| bounds the
    # rounding of the sum, which cancels heavily at small noise.
    scale_c, terms_c = specs["cross"]
    K_qX = scale_c * gram_plain(terms_c, torch.from_numpy(Xq[:64]).to(X64), X64, "f64")
    mu_ref = K_qX @ w64
    absum = K_qX.abs() @ w64.abs()
    sync()
    t_check = time.perf_counter() - t0
    err = (mu[:64].double() - mu_ref).abs()
    mean_err = (err.max() / mu_ref.abs().max()).item()
    eps = torch.finfo(reg.X.dtype).eps
    sum_err = (err / (eps * absum)).max().item()
    check(true_relres <= 100 * tol, f"{mode}: true relres (f64 plain version) {true_relres:.3e} <= {100 * tol:g}")
    # Rounding bound of the mean, in units of eps * sum|k w|: plain K2 sums
    # f32 tiles of <= matvec_tile terms (tile + 2); ff K2 carries the sum in
    # ff, so only the final f32 rounding is left (1); f64 sums 1e5 terms (64).
    bound = {"plain": config.matvec_tile + 2, "ff": 1.0, "f64": 64.0}[mode]
    check(sum_err <= bound, f"{mode}: mean at 64 queries vs f64 plain version: {mean_err:.3e} of max |mean|, "
          f"{sum_err:.3g} eps sum|k w| <= {bound:g}")
    out = dict(
        mode=mode, n=n, nq=nq, rank=rank, noise=sigma_sq, iterations=iters, relres=relres,
        true_relres=true_relres, true_relres_w_f32=true_relres_w32, w_absmax=w.abs().max().item(),
        mean_err=mean_err, mean_err_eps_sum=sum_err, sum_cancellation=(absum.max() / mu_ref.abs().max()).item(),
        build_s=t_build, solve_s=t_solve, mean_s=t_mean, check_s=t_check,
    )
    log(f"main[{mode}] " + json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES for p in phases):
        ap.error(f"phases are {PHASES}")
    n, nq = 100_000, 8192  # the benchmark problem, uncut
    rank = min(8192, n // 4)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script runs only on a GPU", file=sys.stderr)
        return 2
    import linpde_gp_tpu_torch  # noqa: F401  (sets the float32 matmul precision)
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.specs import load_specs, spec_diagonal

    specs = load_specs()
    k0 = {name: spec_diagonal(s) for name, s in specs.items()}
    log(f"allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}")

    timing = {}
    launches = {}
    for phase in ("device", "build", "kernels", "timing", "main"):
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
                phase_kernels(specs, k0)
            elif phase == "timing":
                timing = phase_timing(specs, n, nq, rank)
            else:
                _cuda.reset_launches()
                for mode in ("ff", "f64"):
                    before = dict(_cuda.launches)
                    run_main_path(specs, k0, mode, n, nq, rank)
                    per = {k: _cuda.launches[k] - before[k] for k in before}
                    log(f"main[{mode}] launches {per}")
                    check(min(per.values()) > 0, f"main[{mode}] launched K1 and K2: {per}")
                launches = dict(_cuda.launches)
                for name in KERNELS:
                    check(launches[name] > 0, f"main path launched {name} {launches[name]} times")
        except Exception as exc:  # noqa: BLE001 - every phase reports, then the script fails
            traceback.print_exc()
            failures.append(f"phase {phase}: {type(exc).__name__}: {exc}")
            if phase in ("device", "build"):
                break
        log(f"== {phase} done in {time.perf_counter() - t0:.1f} s")

    entries = []
    for name, (replaces, label) in KERNELS.items():
        key = "gram_xz" if name == "gram" else "gram_matvec_xx"
        if name == "gram":
            modes = {m: {"x_z": row.get("gram_xz"), "z_z": row.get("gram_zz")} for m, row in timing.items()}
        else:
            modes = {m: {"x_x": row.get(key), "q_x": row.get("gram_matvec_qx")} for m, row in timing.items()}
        ff_row = (timing.get("ff") or {}).get(key) or {}
        entries.append({
            "name": name, "label": label, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches.get(name, 0), "max_abs_err": ff_row.get("max_abs_err"),
            "ms": ff_row.get("ms"), "plain_ms": ff_row.get("plain_ms"), "mode": "ff",
            "shape": f"{n}x{rank}" if name == "gram" else f"{n}x{n}, r=1", "modes": modes,
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
