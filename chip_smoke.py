#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``linpde_gp_tpu_torch``) on one GPU.

    python3 chip_smoke.py                    # every phase, the full problems
    python3 chip_smoke.py --phases device,build,kernels   # quick kernel check

Phases, each printed as it finishes:

1. device   - the card's name and power limit (nvidia-smi), torch and CUDA
              versions; fails without a CUDA device.
2. build    - generates and compiles, with nvcc for sm_90a, the kernel
              module of every spec structure the paths use
              (``ops/_cuda.build_modules``: one nvcc per module, all started
              together) into ``build/`` and loads them; prints each module's
              structure and seconds, the total, and the registers and spills
              of every narrow-route (per RC) and multi-column (per RW)
              instantiation.
3. kernels  - each kernel in the modes plain, ff and f64 against its plain
              PyTorch version on the card: K1 (Gram) and K2 (Gram matvec) on
              the heat benchmark specs at shapes up to 2048, K2 with r in
              {1, 4, 5, 48, 64, 100, 256} right-hand-side columns (r > 4 is
              the multi-column route, whose launches are counted apart, at
              RW = 64, 64, 64, 128, 256 columns a block); the
              banded matvec on two compactly supported specs (the 1-D
              Wendland experiment kernel and a 2-D d/dx0 Wendland tensor
              product) at 3000 x 4000 unsorted points with the same r, also
              against dense K2 on the same inputs.  ff is held row by row to
              the f64 product rounded, and its ff pair (hi, lo) to the f64
              product within 1e-3 of that rounding.  K2's symmetric route
              (``gram_matvec_sym``, the CG's (H k H*)(X, X) v) at n = 100
              (below one tile), 1000 (ragged) and 1536 with the same r, held
              to ``gram_matvec`` on (X, X) with the same bounds, bit for bit
              from call to call, r > 4 handed to the multi-column route; then
              at N = 1e5 and 99,997 in f64 (and ff at 1e5) held to
              ``gram_matvec`` and to 256 sampled float64 rows as the scale
              phase holds K2, timed beside ``gram_matvec`` (CUDA events).
4. timing   - each kernel beside its plain version at the main paths' shapes:
              K2 at N x N with r in {1, 4, 64, 256} and (cross kernel)
              nq x N with r = 1, K2's symmetric route at N x N with r = 1
              (beside the plain version's N x N result, its bound from
              N (N + 1) / 2 pairs), K1 at N x rank and rank x rank; the banded
              matvec at N x N, r in {1, 4, 256}, on the Wendland data,
              beside dense K2 on the same spec at r = 1, with the band
              fraction.  The log (not the kernels line) also gives 64 x the
              r = 4 time, an estimate of what the r <= 4 route would take
              at r = 256, and a product-only yardstick: torch.matmul of a
              float64 (8192 x 32768) @ (32768 x 256), the FP64 tensor-core
              rate cuBLAS reaches on this card.
5. main     - every path through the library's entry points
              (``IterativeGPRegressor(prior, X, Y, L=...)``,
              ``.representer_weights``, ``.mean`` and ``.var``), modes ff
              and f64, the launch counts set to 0 before each run and read
              after:
              - heat: N = 100,000 heat collocation points drawn as bench.py
                draws them (seed 0, float32), L = HeatOperator((2,), 0.1),
                nq = 8,192, Nystrom rank min(8192, N // 4), noise 1e-3 k(0),
                tol 1e-5.  The derived specs must equal
                ``data/heat_bench_specs.json``.  Then ``var`` at the first
                256 queries with block_size 256 and again with 128: 0 <= var
                <= prior var, the partitions agree, std within the JAX run's
                range, and ff agrees with f64.  K1, K2 and K2's multi-column
                route must launch.
              - Wendland: ``experiments/wendland_banded_tpu.py``'s problem:
                2 * Wendland(k=2, l=0.05) on N = 100,000 sorted uniform
                points of [0, 1] (seed 0), Y = sin(8 X), noise 1e-3, tol
                1e-5, rank 1024; nq = 8,192; then ``var`` at 256 queries
                (block 256); in mode f64 also at CG tols 1e-9 and 1e-10,
                which must agree: the reference both modes' tol-1e-5
                variance is reported against.  It must be
                banded-routed and launch K1 (Nystrom blocks), the banded
                matvec at r = 1 (CG) and r = 256 (variance) and K2 (mean).
              - anchored heat IBVP: ``experiments/large_scale_tpu.py``'s
                problem (H u = 0 at N = 100,000 points, 96 initial and 2 x 48
                boundary anchors from the analytic solution u*, anchor noise
                1e-5, rank 4096): joint true relres of the 2 x 2 system <=
                1e-3 by the f64 plain versions, RMSE against u* at 8,192
                queries <= 4e-4, then ``var`` at 64 queries (one block of
                64), and in mode f64 the reference as above.
              In mode ff the Wendland and IBVP runs also take ``var`` at CG
              tol 1e-9, which must agree with the f64 reference within 1e-3
              of var per query.
              - dense oracle: the heat problem at N = 4,096, without anchors
                and with 24, ``var`` at 128 queries against a float64 dense
                Cholesky posterior, in all three modes.
              The heat and Wendland runs check finite weights, the solver's
              relres and the true relres recomputed by the float64 plain
              version, and the mean at 64 queries against the float64 plain
              version.
6. dense    - the dense conditioning engine (``GaussianProcess.
              condition_on_observations``, float64), the launch counts set
              to 0 just before the engine's work of each run and read just
              after (K1 and K2 must launch); references run outside that
              window:
              - dense ibvp: the heat prior and operator, the IBVP's 96 IC
                anchors, then each of its two 48-point BC sets (noise 1e-5),
                then H u = 0 at N = 32,768 collocation points (noise 1e-3
                k(0)): one f64 factor grown by chol_extend three times.
                Then the mean and std at 8,192 queries, var and cov.matrix
                at 256.  Logged: seconds of the K1 Gram blocks, the
                Cholesky factorizations, chol_extend and the weights
                (:class:`Spans`), of the mean, std (and per 256 queries) and
                cov.matrix; the route of each mean block (K2 or evaluate @
                w) and the mean's own launches; the peak device memory.
                Then the std's blocked substitution against cuBLAS's dtrsm
                at 16 to 8,192 queries, both timed, with a sweep of the
                panel size (:func:`check_blocked_std`).
                Checked: every mean block launched K2 once and no K1; the
                engine launched K1 and K2 at r = 1 and nothing else; the
                largest K1 block (launched again on its operands, timed with
                CUDA events) within 1e-12 of k(0) of the plain version, each
                mean K2 call within 1e-12 of sum_j |k_ij v_j| of its plain
                version; RMSE against u* <= 4e-4; diag(cov.matrix) against
                var within DIAG_BOUND of the prior variance; finite values;
                peak memory < 40 GB; no plain version called on a CUDA
                tensor; then the mean within 1e-6 of max |mean| and var
                within 1e-3 of var per query of the port's
                IterativeGPRegressor on the same data (f64, CG tol 1e-10).
              - dense oracle: the oracle's heat problem at N = 4,096 with 24
                anchors against the hand-built f64 Cholesky posterior, mean,
                var and cov.matrix to 1e-9; again with
                config.solve_refinement (a float32 factor refined in f64),
                the mean and cov.matrix to 1e-6.
7. mean     - a non-zero prior mean on the anchored heat IBVP of the main
              phase (N = 100,000, the same data, anchors, noise and rank
              4,096), in modes ff and f64, the launch counts set to 0 before
              each run and read just after its work (build, solve, mean):
              the prior mean m(t, x) = exp(-0.3 t) sin(pi (x + 1) / 2), a
              torch ``LambdaFunction``, so that ``L m`` is ``H m`` by nested
              ``torch.func.jvp`` at the 1e5 points on the card.  Checked:
              finite weights, the solver's relres, the joint true relres of
              the 2 x 2 system on the residual data (f64 plain versions) <=
              1e-3, RMSE vs u* at 8,192 queries <= 4e-4, ``H m`` vs its
              closed form (-0.3 + alpha pi^2 / 4) m within 1e-12 of max |H m|
              (f64), the run's own K1 and K2 calls (the Nystrom blocks,
              ``W``, ``A11``, the mean's anchor term; the mean's K2) against
              their plain versions as in the grid phase; then, outside the
              counted window, in f64 at CG tol 1e-10 the mean against a
              zero-mean regressor on the shifted data (``Y - H m(X)``, ``Y1
              - m(X1)``) plus m(xq) within 1e-6 of max |mean|, and the dense
              engine on the same problem at N = 4,096 with the mean against
              the regressor with the mean (f64, tol 1e-10) within 1e-6 of max
              |mean|.  Logged: seconds of ``H m`` at 1e5 points (the
              process's first nested jvp, and again warm), the build, the
              solve and the mean.
8. symbolic - three small symbolic routes on CUDA tensors, each held to the
              same call on the CPU within 1e-12 and checked to leave its
              result on the card: the radial-Matérn 2-D Poisson dense
              posterior (mean and std; observation noise 1e-8), an ``AutodiffTransformedKernel``
              Gram (ExpQuad with the autodiff route forced, off the
              diagonal) and a general-nu Matérn (nu = 1.2) Gram through the
              host Bessel round trip.
9. grid     - grid mode, in modes ff and f64, the launch counts set to 0
              before each run and read just after its work: the reference's
              tensor-grid heat configuration (``experiments/grid_mode_tpu.py``)
              built through ``lgt.problems.HeatEquationDirichletProblem``, a
              (500 x 200) ``TensorProductGrid`` (N = 100,000), 96 + 2 x 48
              anchors from the problem's solution (noise 1e-5), noise 1e-3
              diag(H k H*), rank 2,048, tol 1e-5, the mean at 8,192 queries,
              ``var`` at 256.  The CG matvec is the float64 Kronecker
              operator (in mode ff its product split into the CG's ff pair):
              K1 and K2 at r = 1 must launch, the multi-column and banded
              routes must not.  Checked: finite weights, relres, the joint
              true relres (f64, A22 by K2), RMSE vs u* <= 4e-4, the
              problem's solution vs u*, 0 < var <= prior var, the Kronecker
              operator vs K2 on the flattened grid (f64, 1e-12 of sum_j
              |k_ij v_j| per row), the JAX package's ff matvec KronFFMatvec
              vs the f64 operator at r = 1 and 256 (5e-5 ||v||); var is at
              most 3e-5 of the prior variance, so f64 also solves it at CG
              tols 1e-9 and 1e-10 (the reference, agreeing within 1e-3 of
              var per query) and ff at 1e-9, which must agree with it within
              1e-3 of var per query and within ``VAR_REL_BOUND`` (1e-4) of
              max var, a bound its control (the same CG on the float32
              Kronecker operator) must miss; the tol-1e-5 variances are
              logged against it, not gated.  Logged: build, solve,
              iterations, ms per iteration, mean and var seconds, and the
              structured matvecs' CUDA-event ms at r = 1 and 256 (f64, plain
              float32 and KronFFMatvec, with each one's error against the
              f64 operator and its bound), beside K2's at 1e5^2 from the
              timing phase.
10. fem     - GP-FEM (``experiments/poisson_fem.py:15-65``): -u'' = 2 on
              [-1, 1], u(-1) = 0, u(1) = 1, a free-boundary trial and a
              zero-boundary test hat basis, the Matern(nu = 1.5, l = 1) prior
              conditioned on the boundary values and on ``weak_form(test)
              (trial) @ trial.l2_projection()`` (the exact hat-projection
              crosscov, its Gram block by Gauss-Legendre per element), then
              ``trial_proj(post)`` and a ``ParametricGaussianProcess`` on it.
              At 5 elements with the fixtures' noise: mean and std within
              1e-6 of ``tests/fixtures/reference_parity.json["poisson_fem"]``.
              At 63 elements, noiseless, the launch counts set to 0 before
              the conditioning and read after the evaluations: mean and std
              of the posterior and of the parametric GP at 8,192 queries,
              finite and on the card; K1 and K2 launched; RMSE vs the exact
              solution <= 1e-3; the projected mean vs the classical FEM
              solution <= 1e-3; the mean vs the port's CPU path within 1e-9
              of max |mean|; the exact double-projection Gram on 4 middle
              rows vs its per-cell Gauss-Legendre oracle (the inner cell
              split at the kink) <= 1e-8 per entry.  Then a logged sweep over
              127, 255 and 1,023 elements: that Gram's error, the Galerkin
              Gram's eigenvalue range, whether conditioning raised
              ``LinAlgError`` (allowed: the closed forms' differences cancel
              as the elements shrink, ROADMAP Queue 3); a NaN fails.
11. integral - ``LebesgueIntegral(Box([[0, 5], [-1, 1]]))`` at the default
              64 x 4 Gauss-Legendre panels per axis (65,536 nodes) on the
              dense IBVP posterior (the dense phase's problem: N = 32,768,
              96 + 2 x 48 anchors), the launch counts set to 0 before
              ``I(prior)`` and read after the new mean: ``I(prior)`` and
              ``I(post)`` (K1 over blocks of nodes), then the posterior
              conditioned on y, the integral of u* over the box, with noise 1e-10 and its
              mean at 8,192 queries (the integral term by K2, 8,192 x
              65,536).  Checked: ``I(post).mean`` vs the closed form
              (4/pi)(1 - e^{-5c})/c, c = 0.1 pi^2/4, within 1e-4 and vs the
              same quadrature of the posterior mean (K2 at the nodes) within
              1e-10; 0 <= var <= prior var; the scalar Gaussian update (mean
              within 1e-8 of |y|, variance within 1e-11 of the prior
              variance); the new mean's RMSE vs u* <= 4e-4; the phase's K1 and
              K2 calls against their plain versions (as the dense phase);
              peak device memory < 40 GB; a small copy (N = 512 + 24
              anchors, order 16 x 2) against the port's CPU path within 1e-10
              (variances of the prior variance); the exact 1-D Lebesgue
              crosscov of 1.7 Matern, nu in {0.5, 1.5, 2.5, 3.5}, at 1e5
              points against the CPU within 1e-13.  Logged: the seconds of
              I(prior), I(post), the conditioning and the mean, the launches,
              the peak GB.

12. parallel - the parallel layer (``linpde_gp_tpu_torch.parallel``) at world
              size 1 over NCCL on cuda:0, each run with the launch counts set
              to 0 before its work and read just after; references outside:
              - gram-free: ``DistributedIterativeGPRegressor`` on the main
                phase's heat problem (N = 100,000, rank 8,192, noise 1e-3
                k(0), tol 1e-5) in modes ff and f64 (K2 on the rank's slab, the
                sharded Nystrom build on K1, the ff pair's both planes
                gathered into the ff CG), the mean at 8,192 queries, in f64
                ``var`` at 256; and the Wendland cell (N = 100,000, rank
                1,024) through each rank's banded schedule, its mean and
                ``var`` at 256.  Checked: finite values, relres, the true
                relres (f64 K2) <= 1e-3, the mean within sqrt(k(q, q)) (rho +
                rho_1) ||Y|| / sigma of the single-card
                ``IterativeGPRegressor``'s on the same data (rho, rho_1 the
                two true relres; at CG tol: 2 tol ||Y|| sqrt(k(q, q)) /
                sigma), the heat f64 ``var`` within ``VAR_REL_BOUND`` (1e-4)
                of max var of the single card's, 0 <= var <= prior var; the
                run's own K1 and the mean's K2 calls and the rank's banded
                kernel at r = 1 and 256 against their plain versions (as the
                grid phase and the kernels phase hold them).
              - dense: ``distributed_condition`` on ``H k H*`` at N = 32,768
                (f64, blocks of 256) in layouts auto (cyclic on one rank),
                contiguous and 2d (forced on the 1 x 1 mesh): weights within
                ``PAR_W_BOUND`` (1e-8) of max |w| of the dense engine's, their
                mean at 8,192 queries (K2) within ``PAR_W_BOUND`` of sum_j
                |k_qj w_j| of the engine's, peak memory < 40 GB; the auto run's K1 block
                and K2 calls against their plain versions; then
                ``DistributedConditioner`` on H u = 0 at those points, the
                IBVP's 192 anchors appended by ``extend``, ``posterior_eval``
                at 8,192 queries (blocks of 1,024): the mean within
                ``PAR_IBVP_MEAN_BOUND`` (1e-9) of max |mean| of the dense
                engine's IBVP posterior, var (std^2) at 256 within
                ``PAR_IBVP_VAR_BOUND`` (1e-9) of the prior variance.
              - two ranks on the one card over gloo with CUDA tensors
                (``parallel/launch.spawn``): the heat problem at N = 16,384
                (f64); both ranks agree bit for bit, the mean within the
                bound above of the single card's; the ranks' launches are
                added to the phase's.
              - ``dryrun_multichip(1)`` on the card (every stage against a
                dense f64 oracle).
              K1, K2 (both routes) and the banded kernel (both routes) must
              launch.  Logged: seconds, iterations, launches, peak GB.
13. native  - the g++ host engine (``linpde_gp_tpu_torch.native``) built on
              the host and held to the plain f64 version on the CPU at 4096 x
              4096 (the heat observation spec, random points): Gram within
              1e-13 of max |K|, matvec within 1e-12 of max |Kv|,
              ``ops/gram.gram`` on f64 CPU tensors routed to it; both routes'
              seconds logged beside the host's CPU model.  No card kernel.
14. surface - the port's ``entry()`` (``linpde_gp_tpu_torch/entry.py``: the
              JAX package's ``__graft_entry__.entry()`` heat posterior, 5 IC,
              2 x 12 BC and 12 x 8 PDE points on the dense engine) on the card
              inside ``utils.profiling.trace`` and a ``StageTimer``, the launch
              counts set to 0 just before and read just after: mean and std on
              the 16 x 16 grid within 1e-10 of max |mean| and max std of the
              same ``entry()`` on the CPU (run by the build phase); K1 and K2
              launched, by the counts and in the exported Chrome trace
              (``build/surface_trace/trace.json``).  Logged: the stage seconds,
              the trace's kernels and the card's busy share of the stages
              (kernel time in the trace over the stages' wall time).
15. experiments - the port's nine numerics runs
              (``linpde_gp_tpu_torch/experiments/run_all.RUNS``: poisson_1d at
              n = 3 and 20, poisson_2d, heat_1d, poisson_fem,
              poisson_1d_inverse_rhs, cpu_thermal_1d, its joint model,
              cpu_thermal_2d) on the card, each with the launch counts set to 0
              just before and read just after, their metrics held to the
              port's CPU run of the same script (made by the build phase) at
              relative 1e-6, the round-off metrics at their floors
              (``experiments/common.py``); each script's own gates hold.
              Logged: each run's seconds on the card and on the CPU, and its
              launches.
16. scale   - the port's seven scale experiments
              (``linpde_gp_tpu_torch/experiments``: large_scale, grid_mode,
              variance, wendland_banded, scaling, gram_noise_floor,
              precond_spectroscopy).  (a) Parity: each at the sizes of
              ``tests/test_torch_experiments_scale_*.py`` on the card and on
              the CPU, both at the JAX scripts' CPU-branch settings in mode
              f64 (the grid at CG tol 1e-9), the payloads compared key by
              key (``experiments.common.payload_mismatches``, CG iterations
              also within ``CARD_ITER_RTOL`` of the count).  (b) Full size:
              each once on the card at the JAX scripts' TPU-branch settings
              (N = 1e5; scaling to 32768^2, spectroscopy at 8192) in its
              default mode, with the launch counts set to 0 just before each
              run and read just after, and gated: large_scale and grid_mode
              RMSE vs u* <= 4e-4 and relres <= 100 tol; wendland_banded
              routed banded, banded vs dense within ff's 1e-8; variance the
              script's bounds and partitions within 1e-3 of max var; scaling
              finite weights in every row that runs (also in f64; a float32
              Cholesky that breaks down is logged with its n); noise floor
              ff's largest entry error at most plain's; spectroscopy every
              config converged or at its maxiter.  Logged: each payload, its
              seconds and its launches.  Last, K2 at 1e5^2, r = 1, in modes ff
              and f64 held at 256 sampled rows to float64 rows of the plain
              version (``experiments/probe_diverge_tpu.py`` (a)).
The build phase runs ``entry()`` and the nine runs on the CPU first, and
builds the kernel module of every spec they hand to the kernels.

The line before the last is a JSON object with one entry per kernel: its
ff time at the main path's shape beside its plain version's, its bound
(``bound_ms``: the larger of the operations the work needs, from the
generator's per-pair counts, over the H100 SXM's peak rate of their
pipe, and its bytes over the memory rate; :data:`PEAK`) and its launches
in the main, dense, mean, grid, fem, integral, parallel, surface,
experiments and scale phases (``launches_by_path``: the main phase's runs,
the dense engine's own work, the mean path's runs, the grid path's runs,
the checked GP-FEM run, the integral route, the parallel layer's runs,
``entry()``, the nine experiment runs and the scale experiments' full-size
runs, apart).  The last line is ``{"ok": true, "device":
{...}}``, printed only if every phase passed.  The script never imports JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
import traceback

import numpy as np

PHASES = ("device", "build", "kernels", "timing", "main", "dense", "mean", "symbolic", "grid", "fem", "integral",
          "parallel", "native", "surface", "experiments", "scale")
# name -> (TPU kernel(s) it replaces, label, source)
KERNELS = {
    "gram": ("linpde_gp_tpu/ops/pallas_gram.py:277", "K1", "linpde_gp_tpu_torch/csrc/gram.cuh"),
    "gram_matvec": ("linpde_gp_tpu/ops/pallas_gram.py:393", "K2", "linpde_gp_tpu_torch/csrc/gram.cuh"),
    "gram_matvec_wide": ("linpde_gp_tpu/ops/pallas_gram.py:393", "K2, r > 4", "linpde_gp_tpu_torch/csrc/gram.cuh"),
    "gram_matvec_sym": ("linpde_gp_tpu/ops/pallas_gram.py:393", "K2, symmetric", "linpde_gp_tpu_torch/csrc/gram.cuh"),
    "banded_matvec": (
        "linpde_gp_tpu/ops/pallas_gram.py:664, linpde_gp_tpu/ops/pallas_gram.py:728",
        "K3+K4",
        "linpde_gp_tpu_torch/csrc/banded.cuh",
    ),
    "banded_matvec_wide": ("linpde_gp_tpu/ops/pallas_gram.py:664", "K3, r > 4", "linpde_gp_tpu_torch/csrc/banded.cuh"),
}
#: H100 SXM peaks (NVIDIA's data sheet, at 700 W) as instruction rates: an
#: FMA is one instruction of two flops, so FP32 67 and FP64 33.5 TFLOP/s
#: outside the tensor cores are 33.5e12 and 16.75e12 instructions a second;
#: MUFU (expf's ex2) 16 per SM and clock, 132 SMs at the 1.98 GHz boost
#: clock; HBM3 3.35 TB/s.  The FP64 tensor cores (the multi-column route's
#: product, DMMA) run 67 TFLOP/s (the same data sheet, at 700 W): 33.5e12
#: float64 FMAs a second.
PEAK = {"fp32": 67e12 / 2, "fp64": 33.5e12 / 2, "mufu": 16 * 132 * 1.98e9, "fp64_tc": 67e12 / 2, "bytes": 3.35e12}
WENDLAND_RANK = 1024
#: Right-hand-side widths of the kernel checks: the r <= 4 route and the
#: multi-column route at each of its block widths RW = 64 (r = 5, odd: V's
#: rows are copied 8 bytes at a time; r = 48 ragged; r = 64 the anchored
#: variance's block), 128 (r = 100 ragged) and 256.
R_CHECK = (1, 4, 5, 48, 64, 100, 256)
#: A spec whose absolute-term kernel (:func:`abs_terms`) exceeds its
#: kernel by more than this, summed against |v| (the 2-D Wendland
#: derivative kernel: 1.4e4; the 1-D Wendland kernel: 84), cancels in its
#: Horner sweeps: there the evaluation's rounding outweighs the summation's,
#: and the banded check against the plain version bounds it by
#: :func:`horner_rounding`.
CANCEL_RATIO = 1e3
#: ff must be the f64 product rounded, row by row: |ff_i - f64_i| <= eps
#: |f64_i| + ROW_BOUND eps sum_j |k_ij v_j|.  A body that sums in f32
#: misses it by ~0.3 (the TPU-style sum, measured on the H100).
ROW_BOUND = 1e-3
#: Queries of the heat and Wendland variance runs; the anchored IBVP's.
VAR_QUERIES, IBVP_VAR_QUERIES = 256, 64
#: Nystrom rank of the anchored IBVP (experiments/large_scale_tpu.py).
IBVP_RANK = 4096
#: Two variances of one problem solved to CG tol 1e-5 (two block
#: partitions, or modes ff and f64) agree within this share of max var.
VAR_REL_BOUND = 1e-4
#: The Wendland and IBVP variances (4e-6 and 2e-7 at the smallest) sit
#: 5e5 and 4e6 times below the prior variance they are subtracted from.
#: CG tol is relative to the right-hand side b, so tol 1e-5 does not bound
#: their error relative to var: on the H100 the IBVP's f64 variance at tol
#: 1e-5 is up to 80 % off per query.  f64 CG's quadratic form errs by
#: ||r||^2_{A^-1} <= (tol ||b||)^2 / sigma^2, second order in tol, so the
#: f64 variance at REF_TOLS[1] is the reference, and the run at REF_TOLS[0]
#: must agree with it within REF_AGREE of var per query (an error 100x the
#: reference's, ~1e-8 of var by that scaling).  The tol-1e-5 variances of
#: both modes are reported against it, not gated.
REF_TOLS, REF_AGREE = (1e-9, 1e-10), 1e-3
#: The small dense oracle: CG tol per mode and the bound on its variance,
#: relative to max var.
ORACLE_TOL = {"plain": 1e-5, "ff": 1e-6, "f64": 1e-8}
ORACLE_VAR_BOUND = {"plain": 1e-3, "ff": 1e-5, "f64": 1e-7}
#: The ff variance at this CG tol must agree with the f64 reference
#: (REF_TOLS[1]) within REF_AGREE of var per query, the bound f64 meets.
FF_VAR_TOL = 1e-9
#: The dense engine's PDE points: the largest dense size of the JAX
#: package's scaling sweep (experiments/scaling_tpu.py:19).
DENSE_N = 32768
#: diag(cov.matrix) against var, relative to the prior variance: the GEMM's
#: diagonal and var's column sum round the same ~3e4 products, which sum to
#: about the prior variance, in different orders.
DIAG_BOUND = 1e-13

#: The blocked std's batches (the benchmark's query batches span 16-1,024),
#: and the panel sizes its sweep times.
BLOCKED_STD_BATCHES = (16, 242, 830, 1024, 8192)
BLOCKED_STD_PANELS = (512, 1024, 2048)

failures: list[str] = []
card = "unknown"


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


def u_star(X):
    """The heat IBVP's analytic solution (``HeatEquationDirichletProblem``
    on [-1, 1] with alpha = 0.1, IC the first sine, zero BCs;
    ``linpde_gp_tpu/models/problems/pde.py:391-419``,
    ``functions/basic.py:181-215``): ``u*(t, x) = sin(pi (x + 1) / 2)
    exp(-0.1 (pi / 2)^2 t)`` at ``(n, 2)`` points ``(t, x)``."""
    X = np.asarray(X, np.float64)
    return np.sin(np.pi * (X[:, 1] + 1.0) / 2.0) * np.exp(-0.1 * (np.pi / 2.0) ** 2 * X[:, 0])


def ibvp_anchors(n_ic: int, n_bc: int):
    """Initial-condition anchors at t = 0 and boundary anchors at x = -1
    and x = 1, with values from u*, float32 (``experiments/large_scale_tpu.py``)."""
    X_ic = np.stack([np.zeros(n_ic), np.linspace(-1.0, 1.0, n_ic)], axis=-1)
    t = np.linspace(0.0, 5.0, n_bc)
    X_bc = np.concatenate([np.stack([t, np.full(n_bc, -1.0)], -1), np.stack([t, np.full(n_bc, 1.0)], -1)])
    Xa = np.concatenate([X_ic, X_bc]).astype(np.float32)
    return Xa, u_star(Xa).astype(np.float32)


def ibvp_data(n: int, nq: int):
    """``experiments/large_scale_tpu.py``'s collocation points and queries:
    seed 0, X drawn as bench.py draws it, then the queries, float32."""
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], axis=-1).astype(np.float32)
    Xq = np.stack([rng.uniform(0.0, 5.0, nq), rng.uniform(-1.0, 1.0, nq)], axis=-1).astype(np.float32)
    return X, Xq


def heat_problem(device="cuda"):
    """The heat benchmark's prior (on ``device``) and operator
    (``bench.py::_build_kernels``)."""
    from linpde_gp_tpu_torch import GaussianProcess
    from linpde_gp_tpu_torch.models.functions import Zero
    from linpde_gp_tpu_torch.ops import kernels
    from linpde_gp_tpu_torch.ops.diffops import HeatOperator

    prior = GaussianProcess(
        Zero((2,)),
        1.0 * kernels.TensorProduct(
            kernels.Matern((), nu=1.5, lengthscales=2.5), kernels.Matern((), nu=2.5, lengthscales=2.0)
        ),
        device=device,
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


def wendland_prior(device="cuda"):
    from linpde_gp_tpu_torch import GaussianProcess
    from linpde_gp_tpu_torch.models.functions import Zero
    from linpde_gp_tpu_torch.ops.kernels import WendlandCovarianceFunction

    return GaussianProcess(Zero(()), 2.0 * WendlandCovarianceFunction((), k=2, lengthscales=0.05), device=device)


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


def abs_terms(terms):
    """``terms`` with every coefficient and prefactor replaced by its
    magnitude and no sign factor: the kernel of the absolute terms, whose
    value is the scale of a Horner evaluation's rounding where the terms
    cancel (the 2-D Wendland derivative kernel's coefficients reach 1e3)."""
    return tuple(
        (abs(c), tuple((kind, sc, tuple(abs(p) for p in poly), 0, abs(pre)) for kind, sc, poly, _, pre in factors))
        for c, factors in terms
    )


def horner_rounding(spec) -> float:
    """How far, in units of eps times the absolute-term kernel's value
    (:func:`abs_terms`), the kernels' pair evaluation and its plain
    version's may differ: the kernel rounds once per Horner step (an FMA),
    the plain version twice, so by Higham's bound on Horner's rule they are
    within gamma_D and gamma_2D of the exact value, D the Horner steps on a
    coefficient's longest path (the sum over dimensions of the degree);
    both also round each group sum and the envelope's product once.  That
    is (3 D + 2 (groups + 1)) u with u = eps / 2."""
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.ops.gram import _collapse_terms

    st = _cuda.structure_of(_collapse_terms(tuple(spec[1])))
    steps = max(sum(n - 1 for n in shape) for _, _, shape in st.groups)
    return (3 * steps + 2 * (len(st.groups) + 1)) / 2


def row_excess(o, oracle, row_absum, eps):
    """max_i (|o_i - f64_i| - eps |f64_i|) / (eps sum_j |k_ij v_j|): how far a
    result is from the f64 product rounded, row by row, in units of the row's
    rounding scale; a row with no neighbour must be exactly 0 (0/0 reads 0,
    x/0 inf)."""
    import torch

    e = ((o.double() - oracle).abs() - eps * oracle.abs()).clamp(min=0)
    return torch.nan_to_num(e / (eps * row_absum), nan=0.0).max().item()


def pair_excess(pair, oracle, row_absum, eps):
    """max_i |hi_i + lo_i - f64_i| / (eps sum_j |k_ij v_j|): an ff pair's
    distance from the f64 product in units of the row's f32 rounding scale."""
    import torch

    e = (pair[0].double() + pair[1].double() - oracle).abs()
    return torch.nan_to_num(e / (eps * row_absum), nan=0.0).max().item()


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


def kernel_bound(spec, mode, pairs, nbytes, r=0, wide=False):
    """The least time the card could take for ``pairs`` pair evaluations
    of ``spec`` in ``mode`` with ``r`` right-hand-side columns (``r = 0``:
    K1, which stores each entry) moving ``nbytes``: ``{"bound_ms",
    "bound_by", "pipe"}``, the larger of the operations' time on their
    busiest pipe (``ops/_cuda.pair_ops`` at :data:`PEAK`) and the bytes'."""
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.ops.gram import _collapse_terms

    ops = _cuda.pair_ops(_cuda.structure_of(_collapse_terms(tuple(spec[1]))), mode, r, wide)
    times = {pipe: ops[pipe] * pairs / PEAK[pipe] for pipe in ops}
    pipe = max(times, key=times.get)
    t_bytes = nbytes / PEAK["bytes"]
    return {"bound_ms": 1e3 * max(times[pipe], t_bytes), "bound_by": "operations" if times[pipe] >= t_bytes else "bytes",
            "pipe": pipe}


def matvec_bytes(mode, n0, n1, nd, r):
    """Bytes a Gram matvec must move: the points and V read once, the
    result written once (ff: both planes of V and of the result)."""
    size = 8 if mode == "f64" else 4
    planes = 2 if mode == "ff" else 1
    return size * ((n0 + n1) * nd + planes * (n1 + n0) * r)


# -- phases ----------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this script needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    global card
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    log(card if card != "unknown" else "nvidia-smi: unavailable")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap} is sm_90")


def path_specs() -> dict:
    """Every spec the paths hand to the kernels: the heat observation and
    cross kernels, the prior (anchors, ``kxX`` of the anchored variance)
    and ``H k`` (the anchor block W), the Wendland kernels."""
    from linpde_gp_tpu_torch.ops.gram import kernel_term_specs
    from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel

    prior, H = heat_problem()
    out = {f"heat_{k}": v for k, v in heat_specs().items()}
    out["heat_prior"] = kernel_term_specs(prior.cov)
    out["heat_Lk"] = kernel_term_specs(apply_operator_to_kernel(H, prior.cov, argnum=0))
    out.update({f"wendland_{k}": v for k, v in wendland_specs().items()})
    out["fem_prior"] = kernel_term_specs(fem_setup(5, "cpu")["prior"].cov)
    out.update(dryrun_specs())
    return out


def dryrun_specs() -> dict:
    """The parallel dry run's 1-D Poisson kernels (``parallel/dryrun.py``):
    ``D k D*``, ``D k`` and ``k`` of ``4 Matern(5/2, l=1)``, D = -Laplacian."""
    import linpde_gp_tpu_torch as lgt
    from linpde_gp_tpu_torch.ops.gram import kernel_term_specs
    from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel

    k = 2.0**2 * lgt.kernels.Matern((), nu=2.5, lengthscales=1.0)
    D = -1.0 * lgt.diffops.Laplacian(())
    return {"dryrun_DkD": kernel_term_specs(apply_operator_to_kernel(D, apply_operator_to_kernel(D, k, argnum=1),
                                                                     argnum=0)),
            "dryrun_Dk": kernel_term_specs(apply_operator_to_kernel(D, k, argnum=0)),
            "dryrun_k": kernel_term_specs(k)}


def phase_build():
    """Build the module of every spec structure the paths use, in parallel."""
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.ops.gram import _collapse_terms

    specs = path_specs()
    specs.update(cpu_reference_specs())
    structures = {}
    for name, (_, terms) in specs.items():
        st = _cuda.structure_of(_collapse_terms(tuple(terms)))
        structures.setdefault(st.key, (st, []))[1].append(name)
    t0 = time.perf_counter()
    built = _cuda.build_modules([st for st, _ in structures.values()])
    total = time.perf_counter() - t0
    log(f"build: {len(built)} modules in {total:.1f} s (nvcc flags {' '.join(_cuda.NVCC_FLAGS)})")
    logs = []
    regs, spills = [], []
    for b in built:
        log(f"  module {b['key']} for {structures[b['key']][1]}: {b['seconds']:.1f} s "
            f"({'built' if b['built'] else 'cached'}), structure {b['structure']}")
        logs.append(f"== {b['key']} {b['structure']}\n{b['log']}")
        usage = _cuda.ptxas_usage(b["log"])
        regs += [u.get("registers", 0) for u in usage.values()]
        spills += [u.get("spill_stores", 0) for u in usage.values()]
        # Registers (spill stores) per mode: the narrow route's instantiations
        # per RC, the multi-column route's per RW.
        for kernel, what in (("gram_matvec_kernel", "RC = 1, 2, 4"), ("sym_gram_matvec_kernel", "RC = 1, 2, 4"),
                             ("banded_matvec_kernel", "RC = 1, 2, 4"), ("gram_matmat_kernel", "RW = 64, 128, 256"),
                             ("banded_matmat_kernel", "RW = 64, 128, 256")):
            per = {}
            for name, u in usage.items():
                m = re.search(r"\b" + kernel + r"<[^,]+, lgt::(\w+(?:<\w+>)?), (?:\(int\))?(\d+)>", name)
                if m:
                    mode = {"PlainArith<float>": "plain", "PlainArith<double>": "f64", "FFArith": "ff"}[m.group(1)]
                    per.setdefault(mode, []).append(
                        (int(m.group(2)), f"{u.get('registers')}({u.get('spill_stores')})"))
            log(f"    {kernel} registers (spill stores, B) at {what}: "
                + "; ".join(f"{mode} " + " ".join(v for _, v in sorted(per[mode])) for mode in sorted(per)))
    (_cuda.BUILD_DIR / "nvcc.log").write_text("".join(logs))
    log(f"ptxas: {len(regs)} kernels, registers {min(regs, default=0)}..{max(regs, default=0)}, "
        f"spill stores up to {max(spills, default=0)} bytes (full log: {_cuda.BUILD_DIR / 'nvcc.log'})")


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

        eps32 = torch.finfo(torch.float32).eps
        for r in R_CHECK:
            vnp = rng.standard_normal((2048, r))
            v64 = torch.tensor(vnp, dtype=torch.float64, device=dev)
            v32 = v64.float()
            oracle = gram_matvec_plain(spec, x0_32, x1_32, v32.double(), "f64")
            row_absum = oracle_k1.abs() @ v32.double().abs()
            wide0 = _cuda.launches["gram_matvec_wide"]
            for mode in ("plain", "ff", "f64"):
                v = v64 if mode == "f64" else v32
                out = gram_matvec(spec, X0[mode], X1[mode], v, mode)
                ref = gram_matvec_plain(spec, X0[mode], X1[mode], v, mode)
                if mode == "ff":
                    pair, out, ref = out, out[0], ref[0]
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
                    e_row = row_excess(out, oracle, row_absum, eps32)
                    check(e_row <= ROW_BOUND, f"K2 {name} r={r} ff is the f64 product rounded, row by row: "
                          f"excess {e_row:.3g} eps sum_j|k_ij v_j| <= {ROW_BOUND:g}")
                    e_pair = pair_excess(pair, oracle, row_absum, eps32)
                    check(e_pair <= ROW_BOUND, f"K2 {name} r={r} ff pair hi + lo vs the f64 product: "
                          f"{e_pair:.3g} eps sum_j|k_ij v_j| <= {ROW_BOUND:g}")
            wide = _cuda.launches["gram_matvec_wide"] - wide0
            want = 0 if r in (1, 4) else 3  # one launch per mode on the multi-column route for r > 4
            check(wide == want, f"K2 {name} r={r}: {wide} launches of the multi-column route, {want} expected")
    check_k2_sym_small(specs["obs"], dev)
    log(f"kernel launches in this phase: {dict(_cuda.launches)}")
    check_k2_sym()


def check_k2_sym_small(spec, dev):
    """K2's symmetric route against ``gram_matvec`` on (X, X) in each mode,
    at n below one tile, ragged and whole tiles, with the bounds of
    :func:`phase_kernels`' K2 checks (ff: row by row against the f64
    product of its float32 points); two calls bit-identical; r > 4 on the
    multi-column route, equal to ``gram_matvec``'s."""
    import torch

    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.ops.gram import gram_matvec, gram_matvec_plain, gram_matvec_sym, gram_plain

    rng = np.random.default_rng(11)
    eps32 = torch.finfo(torch.float32).eps
    for n in (100, 1000, 1536):
        Xnp = np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], -1)
        X = {m: torch.tensor(Xnp, dtype=torch.float64 if m == "f64" else torch.float32, device=dev)
             for m in ("plain", "ff", "f64")}
        x32 = X["ff"].double()
        K32 = spec[0] * gram_plain(spec[1], x32, x32, "f64")
        for r in R_CHECK:
            v64 = torch.tensor(rng.standard_normal((n, r)), dtype=torch.float64, device=dev)
            oracle = gram_matvec_plain(spec, x32, x32, v64.float().double(), "f64")
            row_absum = K32.abs() @ v64.float().double().abs()
            for mode in ("plain", "ff", "f64"):
                v = v64 if mode == "f64" else v64.float()
                sym0, wide0 = _cuda.launches["gram_matvec_sym"], _cuda.launches["gram_matvec_wide"]
                out = gram_matvec_sym(spec, X[mode], v, mode)
                again = gram_matvec_sym(spec, X[mode], v, mode)
                ref = gram_matvec(spec, X[mode], X[mode], v, mode)
                sync()
                tag = f"K2 sym n={n} r={r} {mode}"
                same = all(torch.equal(a, b) for a, b in zip(out, again)) if mode == "ff" else torch.equal(out, again)
                check(same, f"{tag}: two calls bit-identical")
                sym = _cuda.launches["gram_matvec_sym"] - sym0
                wide = _cuda.launches["gram_matvec_wide"] - wide0
                want = (2, 0) if r <= _cuda.NARROW_MAX_R else (0, 3)
                check((sym, wide) == want, f"{tag}: {sym} symmetric and {wide} multi-column launches, {want} expected")
                if r > _cuda.NARROW_MAX_R:
                    same = all(torch.equal(a, b) for a, b in zip(out, ref)) if mode == "ff" else torch.equal(out, ref)
                    check(same, f"{tag}: the multi-column route's result, bit for bit")
                    continue
                if mode == "ff":
                    pair, out, ref = out, out[0], ref[0]
                sc = ref.abs().max().item()
                err = (out.double() - ref.double()).abs().max().item()
                if mode == "f64":
                    check(err <= 1e-12 * sc, f"{tag} vs gram_matvec: {err / sc:.3e} rel <= 1e-12")
                elif mode == "plain":
                    check(err <= 1e-5 * sc, f"{tag} vs gram_matvec: {err / sc:.3e} rel <= 1e-5")
                else:
                    e_row = row_excess(out, oracle, row_absum, eps32)
                    check(e_row <= ROW_BOUND, f"{tag} is the f64 product rounded, row by row: excess {e_row:.3g} "
                          f"eps sum_j|k_ij v_j| <= {ROW_BOUND:g} (vs gram_matvec: {err / sc:.3e})")
                    e_pair = pair_excess(pair, oracle, row_absum, eps32)
                    check(e_pair <= ROW_BOUND, f"{tag} pair hi + lo vs the f64 product: {e_pair:.3g} eps "
                          f"sum_j|k_ij v_j| <= {ROW_BOUND:g}")


def check_k2_sym(n=100_000, rows=256, ragged=99_997) -> dict:
    """K2's symmetric route at the main path's size, r = 1, on the heat
    benchmark's points: f64 at ``n`` and ``ragged`` points and ff at ``n``,
    each held at ``rows`` sampled rows to the float64 product of the plain
    version's f64 Gram rows (f64 within 1e-11 of sum_j |k_ij v_j|, ff's
    pair within ``ROW_BOUND`` of the f32 rounding scale, as
    :func:`check_k2_sampled_rows`) and on every row to ``gram_matvec``
    (within 1e-11 of the sampled rows' largest sum_j |k_ij v_j|); two calls
    bit-identical; each timed beside ``gram_matvec`` (CUDA events, mean of
    3 after one untimed call)."""
    import torch

    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.ops.gram import gram_matvec, gram_matvec_sym, gram_plain

    spec = heat_specs()["obs"]
    X, _, _ = bench_data(n, 0)
    rng = np.random.default_rng(4)
    v = torch.tensor(rng.standard_normal(n).astype(np.float32), device="cuda")
    Xd = torch.tensor(X, device="cuda")
    out = {}
    for mode, m in (("f64", n), ("f64", ragged), ("ff", n)):
        dt = torch.float64 if mode == "f64" else torch.float32
        Xm, vm = Xd[:m].to(dt), v[:m].to(dt)
        sel = torch.as_tensor(rng.choice(m, rows, replace=False), device="cuda")
        K = spec[0] * gram_plain(spec[1], Xm[sel].double(), Xm.double(), "f64")
        oracle, row_absum = K @ vm.double(), K.abs() @ vm.double().abs()
        del K
        gram_matvec_sym(spec, Xm, vm, mode), gram_matvec(spec, Xm, Xm, vm, mode)
        sym_ms, res = timed(lambda: gram_matvec_sym(spec, Xm, vm, mode), reps=3)
        again = gram_matvec_sym(spec, Xm, vm, mode)
        two_ms, ref = timed(lambda: gram_matvec(spec, Xm, Xm, vm, mode), reps=3)
        tag = f"K2 sym {mode} at {m}^2, r = 1"
        if mode == "ff":
            same = torch.equal(res[0], again[0]) and torch.equal(res[1], again[1])
            e_rows = pair_excess((res[0][sel], res[1][sel]), oracle, row_absum, float(np.finfo(np.float32).eps))
            e_all = ((res[0].double() + res[1].double()) - (ref[0].double() + ref[1].double())).abs().max().item()
            e_all /= float(np.finfo(np.float32).eps) * row_absum.max().item()
            check(e_rows <= ROW_BOUND, f"{tag} on {rows} sampled rows: the f64 product within {e_rows:.3g} <= "
                  f"{ROW_BOUND:g} eps32 sum_j |k_ij v_j|")
            check(e_all <= ROW_BOUND, f"{tag} vs gram_matvec on every row: {e_all:.3g} <= {ROW_BOUND:g} eps32 "
                  "of the sampled rows' largest sum_j |k_ij v_j|")
        else:
            same = torch.equal(res, again)
            e_rows = ((res[sel] - oracle).abs() / row_absum).max().item()
            e_all = (res - ref).abs().max().item() / row_absum.max().item()
            check(e_rows <= 1e-11, f"{tag} on {rows} sampled rows: {e_rows:.3g} <= 1e-11 of sum_j |k_ij v_j|")
            check(e_all <= 1e-11, f"{tag} vs gram_matvec on every row: {e_all:.3g} <= 1e-11 of the sampled rows' "
                  "largest sum_j |k_ij v_j|")
        check(same, f"{tag}: two calls bit-identical")
        scratch_mb = max(b.numel() for _, b in _cuda._sym_scratch.values()) / 1e6
        out[f"{mode}_{m}"] = dict(sym_ms=sym_ms, gram_matvec_ms=two_ms, ratio=sym_ms / two_ms, rows_err=e_rows,
                                  all_err=e_all, scratch_mb=scratch_mb)
        log(f"  {tag}: {sym_ms:.3f} ms against gram_matvec's {two_ms:.3f} ms ({sym_ms / two_ms:.3f}); "
            f"scratch {scratch_mb:.1f} MB")
        del res, again, ref
    return out


def phase_banded_kernels(wspecs, device="cuda"):
    """The banded matvec in each mode against its plain version and dense
    K2 on the card, on unsorted points.  Bounds are in units of eps of the
    mode times max_i sum_j |k_ij v_j| (the f64 plain version): the plain
    body sums f32 tiles of ``matvec_tile`` terms (tile + 2), f64 sums a few
    thousand terms (64).  Where a spec's Horner sweeps cancel hard
    (max_i sum_j c_ij |v_j| over that above :data:`CANCEL_RATIO`, c the
    kernel of :func:`abs_terms`), the plain and f64 bodies' bound against
    their plain versions adds :func:`horner_rounding` eps max_i sum_j c_ij
    |v_j|: the kernel evaluates each Horner step with one FMA where the
    plain version rounds twice.  The dense K2 check shares the kernel's pair
    evaluator, so it holds the band schedule, not the evaluation, and
    keeps the summation bound alone.  ff carries the product and the sum in ff and
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
    for name, spec in wspecs.items():
        scale, terms = spec
        d = len(terms[0][1])
        X0np = rng.uniform(0.0, 1.0, (3000, d))
        X1np = rng.uniform(0.0, 1.0, (4000, d))
        # The f64 oracle on the f32-rounded points.
        x0_32 = torch.tensor(X0np, device=dev).float().double()
        x1_32 = torch.tensor(X1np, device=dev).float().double()
        absG = (scale * gram_plain(terms, x0_32, x1_32, "f64")).abs()
        condG = abs(scale) * gram_plain(abs_terms(terms), x0_32, x1_32, "f64")
        mv64 = make_banded_matvec(spec, x0_32, x1_32, mode="f64")
        # The ff entries, for the TPU bodies' f32 sum of hi v and lo v.
        K_hi, K_lo = _eval_block(_collapse_terms(tuple(terms)), x0_32.float(), x1_32.float(), "ff")
        for r in R_CHECK:
            vnp = rng.standard_normal((4000, r))
            v64 = torch.tensor(vnp, dtype=torch.float64, device=dev)
            v32 = v64.float()
            row_absum = absG @ v32.double().abs()
            absum = row_absum.max().item()
            cond_absum = (condG @ v32.double().abs()).max().item()
            oracle = mv64.plain(v32.double())
            outs = {}
            wide0 = _cuda.launches["banded_matvec_wide"]
            for mode in ("plain", "ff", "f64"):
                dt = torch.float64 if mode == "f64" else torch.float32
                X0 = torch.tensor(X0np, dtype=dt, device=dev)
                X1 = torch.tensor(X1np, dtype=dt, device=dev)
                v = v64 if mode == "f64" else v32
                mv = make_banded_matvec(spec, X0, X1, mode=mode)
                out = outs[mode] = mv(v)
                ref = mv.plain(v)
                dense = gram_matvec(spec, X0, X1, v, mode)
                if mode == "ff":  # ff pairs: hold their f32 roundings hi, and the kernel's pair apart
                    pair, out, ref, dense = out, out[0], ref[0], dense[0]
                    outs[mode] = out
                sync()
                eps = torch.finfo(dt).eps
                bound = {"plain": config.matvec_tile + 2, "ff": 1.0, "f64": 64.0}[mode] * eps * absum
                cancels = cond_absum > CANCEL_RATIO * absum
                b_eval = horner_rounding(spec) * eps * cond_absum if cancels and mode != "ff" else 0.0
                e_plain = (out.double() - ref.double()).abs().max().item()
                e_dense = (out.double() - dense.double()).abs().max().item()
                tag = f"banded {name} {mode} r={r} (band {mv.band_tiles}/{mv.total_tiles} tiles)"
                check(e_plain <= bound + b_eval, f"{tag} vs plain: {e_plain / (eps * absum):.3g} eps sum|k v| "
                      f"<= {(bound + b_eval) / (eps * absum):.4g} (sum c|v| / sum|k v| = {cond_absum / absum:.3g})")
                check(e_dense <= bound, f"{tag} vs dense K2: {e_dense / (eps * absum):.3g} eps sum|k v| "
                      f"<= {bound / (eps * absum):g}")
                if mode == "ff":
                    e64 = (out.double() - oracle).abs().max().item()
                    check(e64 <= 0.5 * eps * absum, f"{tag} vs f64 product: {e64 / (eps * absum):.3g} "
                          "eps sum|k v| <= 0.5")
                    e_pair = pair_excess(pair, oracle, row_absum, eps)
                    check(e_pair <= ROW_BOUND, f"{tag} ff pair hi + lo vs the f64 product: {e_pair:.3g} "
                          f"eps sum_j|k_ij v_j| <= {ROW_BOUND:g}")
                # An ff right-hand side with a nonzero lo plane (both routes).
                if mode == "ff" and r >= 4:
                    lo = (v64 - v32.double()).float()
                    out2 = mv((v32, lo))[0]
                    ref2 = mv64.plain(v32.double() + lo.double())
                    sync()
                    e2 = (out2.double() - ref2).abs().max().item()
                    check(e2 <= 0.5 * eps * absum, f"{tag} ff pair rhs vs f64 product: "
                          f"{e2 / (eps * absum):.3g} eps sum|k v| <= 0.5")
            wide = _cuda.launches["banded_matvec_wide"] - wide0
            want = 0 if r in (1, 4) else 4  # the three modes and the ff pair rhs, for r > 4
            check(wide == want, f"banded {name} r={r}: {wide} launches of the multi-column route, {want} expected")

            tpu = scale * (K_hi @ v32 + K_lo @ v32)
            sync()
            tag = f"banded {name} r={r}"
            e_ff = row_excess(outs["ff"], oracle, row_absum, eps32)
            e_tpu = row_excess(tpu, oracle, row_absum, eps32)
            e_plain32 = row_excess(outs["plain"], oracle, row_absum, eps32)
            e_tpu_max = (tpu.double() - oracle).abs().max().item() / (eps32 * absum)
            check(e_ff <= ROW_BOUND, f"{tag} ff is the f64 product rounded, row by row: "
                  f"excess {e_ff:.3g} eps sum_j|k_ij v_j| <= {ROW_BOUND:g}")
            check(e_tpu > ROW_BOUND and e_plain32 > ROW_BOUND,
                  f"{tag} f32 sums fail that bound: TPU-style ff sum {e_tpu:.3g}, plain body {e_plain32:.3g} "
                  f"> {ROW_BOUND:g} (the TPU-style sum reads {e_tpu_max:.3g} eps max sum|k v| vs the f64 product)")
        del absG, condG, K_hi, K_lo
        torch.cuda.empty_cache()
    log(f"kernel launches in this phase: {dict(_cuda.launches)}")


def phase_timing(specs, n, nq, rank):
    """K1 and K2 vs their plain versions at the heat path's shapes, per mode:
    K2 at N x N with r = 1, 4 (the narrow route), 64 (the
    multi-column route at RW = 64, the anchored variance's block) and 256
    (RW = 256, the heat variance's block), its symmetric route at N x N with
    r = 1 (the CG's matvec; bound by its N (N + 1) / 2 pairs, held to the
    plain version's result of the N x N row), and on the cross kernel at
    nq x N with r = 1."""
    import torch

    from linpde_gp_tpu_torch.ops.gram import gram, gram_matvec, gram_matvec_plain, gram_matvec_sym, gram_plain
    from linpde_gp_tpu_torch.ops.linalg.pcg import landmark_indices

    spec, cross = specs["obs"], specs["cross"]
    scale, terms = spec
    # The product alone, as cuBLAS runs it on this card's FP64 tensor cores:
    # a yardstick for the multi-column route's DMMA product (log only; no
    # PyTorch call computes the kernels' function).
    A = torch.randn(8192, 32768, dtype=torch.float64, device="cuda")
    B = torch.randn(32768, 256, dtype=torch.float64, device="cuda")
    torch.matmul(A, B)
    ms, _ = timed(lambda: torch.matmul(A, B), reps=5)
    log(f"  yardstick: torch.matmul f64 (8192 x 32768) @ (32768 x 256): {ms:.3f} ms, "
        f"{2 * 8192 * 32768 * 256 / ms / 1e9:.2f} TFLOP/s (FP64 tensor-core peak 67)")
    del A, B
    X, _, Xq = bench_data(n, nq)
    idx = landmark_indices(n, rank)
    v_np = np.random.default_rng(2).standard_normal(n)
    V_np = np.random.default_rng(5).standard_normal((n, 256))
    rows = {}
    for mode in ("ff", "f64", "plain"):
        dt = torch.float64 if mode == "f64" else torch.float32
        Xd = torch.tensor(X, device="cuda").to(dt)
        Zd = Xd[idx.to("cuda")].contiguous()
        Qd = torch.tensor(Xq, device="cuda").to(dt)
        v = torch.tensor(v_np, device="cuda").to(dt)
        V = torch.tensor(V_np, device="cuda").to(dt)
        # The CG hands K2 its direction as an ff pair in mode ff.
        v_main = (v, v * 1e-8) if mode == "ff" else v
        V_main = (V, V * 1e-8) if mode == "ff" else V
        V4_main, V64_main = (
            (V[:, :r].contiguous(), V[:, :r] * 1e-8) if mode == "ff" else V[:, :r].contiguous() for r in (4, 64)
        )
        # warm-up launches (and cuBLAS/allocator set-up) at small shapes
        gram(terms, Zd[:256], Zd[:256], mode)
        gram_plain(terms, Zd[:256], Zd[:256], mode)
        gram_matvec(spec, Zd[:256], Zd[:256], v[:256], mode)
        gram_matvec(spec, Zd[:256], Zd[:256], V[:256], mode)
        gram_matvec_plain(spec, Zd[:256], Zd[:256], v[:256], mode)
        gram_matvec_sym(spec, Xd, v_main, mode)  # its tables and its scratch at N
        sync()
        size = 8 if mode == "f64" else 4
        planes = 2 if mode == "ff" else 1
        bounds = {
            "gram_zz": kernel_bound(spec, mode, rank * rank, size * rank * (rank + 4), r=0),
            "gram_xz": kernel_bound(spec, mode, n * rank, size * n * (rank + 2) + size * rank * 2, r=0),
            "gram_matvec_xx": kernel_bound(spec, mode, n * n, matvec_bytes(mode, n, n, 2, 1), r=1),
            # X and v read once, the result written once
            "gram_matvec_sym_xx": kernel_bound(spec, mode, n * (n + 1) // 2, size * n * (2 + 2 * planes), r=1),
            "gram_matvec_xx_r4": kernel_bound(spec, mode, n * n, matvec_bytes(mode, n, n, 2, 4), r=4),
            "gram_matvec_xx_r64": kernel_bound(spec, mode, n * n, matvec_bytes(mode, n, n, 2, 64), r=64, wide=True),
            "gram_matvec_xx_r256": kernel_bound(spec, mode, n * n, matvec_bytes(mode, n, n, 2, 256), r=256, wide=True),
            "gram_matvec_qx": kernel_bound(cross, mode, nq * n, matvec_bytes(mode, nq, n, 2, 1), r=1),
        }
        row = {}
        for key, fk, fp, reps in (
            ("gram_zz", lambda: gram(terms, Zd, Zd, mode), lambda: gram_plain(terms, Zd, Zd, mode), 3),
            ("gram_xz", lambda: gram(terms, Xd, Zd, mode), lambda: gram_plain(terms, Xd, Zd, mode), 3),
            ("gram_matvec_xx", lambda: gram_matvec(spec, Xd, Xd, v_main, mode),
             lambda: gram_matvec_plain(spec, Xd, Xd, v_main, mode), 3),
            # the CG's matvec; its plain version is the row above's, on the same inputs
            ("gram_matvec_sym_xx", lambda: gram_matvec_sym(spec, Xd, v_main, mode), None, 3),
            # the r <= 4 route at its widest: r = 256 on it took 64 such launches
            ("gram_matvec_xx_r4", lambda: gram_matvec(spec, Xd, Xd, V4_main, mode),
             lambda: gram_matvec_plain(spec, Xd, Xd, V4_main, mode), 2),
            # the multi-column route at the anchored variance's block width
            ("gram_matvec_xx_r64", lambda: gram_matvec(spec, Xd, Xd, V64_main, mode),
             lambda: gram_matvec_plain(spec, Xd, Xd, V64_main, mode), 2),
            # and at the heat variance's
            ("gram_matvec_xx_r256", lambda: gram_matvec(spec, Xd, Xd, V_main, mode),
             lambda: gram_matvec_plain(spec, Xd, Xd, V_main, mode), 2),
            # the posterior mean: cross kernel at nq x N
            ("gram_matvec_qx", lambda: gram_matvec(cross, Qd, Xd, v_main, mode),
             lambda: gram_matvec_plain(cross, Qd, Xd, v_main, mode), 3),
        ):
            ms, out = timed(fk, reps=reps)
            if fp is None:
                pms, ref = plain_xx
            else:
                pms, ref = timed(fp, reps=1)
                if mode == "ff" and key.startswith("gram_matvec"):
                    ref = ref[0]
            if mode == "ff" and key.startswith("gram_matvec"):  # ff pairs: compare their f32 roundings hi
                out = out[0]
            if key == "gram_matvec_xx":
                plain_xx = (pms, ref)
            err = (out.double() - ref.double()).abs().max().item()
            sc = ref.abs().max().item()
            del out, ref
            torch.cuda.empty_cache()
            b = bounds[key]
            row[key] = {"ms": ms, "plain_ms": pms, "max_abs_err": err, "rel_err": err / sc, **b,
                        "share_of_bound": b["bound_ms"] / ms}
            log(f"  {mode:5s} {key:19s} kernel {ms:10.3f} ms  plain {pms:10.3f} ms  bound {b['bound_ms']:9.3f} ms "
                f"({b['pipe']}, {100 * b['bound_ms'] / ms:5.1f} %)  max|kernel - plain| {err:.3e} ({err / sc:.3e} of max)")
            # K1 entries match bit for bit; K2 sums 1e5 terms in another order
            # than its plain version (f32 in plain mode, ff vs f64 in ff mode).
            bound = {"plain": 1e-4, "ff": 1e-6, "f64": 1e-10}[mode]
            check(np.isfinite(err) and err <= bound * sc, f"{mode} {key} at full shape within {bound:g} of max")
        r4 = row["gram_matvec_xx_r4"]["ms"]
        log(f"  {mode:5s} K2 r=256: multi-column route {row['gram_matvec_xx_r256']['ms']:.3f} ms; the r <= 4 route "
            f"would take 64 launches of r=4: {64 * r4:.1f} ms (an estimate: 64 x the r=4 time)")
        rows[mode] = row
        del Xd, Zd, Qd, v, v_main, V, V_main, V4_main, V64_main, plain_xx
        torch.cuda.empty_cache()
    return rows


def phase_banded_timing(n):
    """The banded matvec vs its plain version (and at r = 1 dense K2) on the
    Wendland experiment's spec and data at N x N, r in {1, 4, 256}, per mode."""
    import torch

    from linpde_gp_tpu_torch.ops.banded import make_banded_matvec
    from linpde_gp_tpu_torch.ops.gram import gram_matvec

    spec = wendland_specs()["1d"]
    X, v_np, _, _ = wendland_data(n, 0)
    V_np = np.random.default_rng(6).standard_normal((n, 256))
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
        if mode == "ff":  # ff pairs: compare their f32 roundings hi
            out, ref, dense = out[0], ref[0], dense[0]
        sc = ref.abs().max().item()
        err = (out.double() - ref.double()).abs().max().item()
        err_dense = (out.double() - dense.double()).abs().max().item()
        pairs = mv.pair_fraction * n * n  # the pairs this data's windows hold
        b = kernel_bound(spec, mode, pairs, matvec_bytes(mode, n, n, 1, 1), r=1)
        row = {"ms": ms, "plain_ms": pms, "dense_k2_ms": dms, "max_abs_err": err, "rel_err": err / sc,
               "rel_err_vs_dense": err_dense / sc, "setup_s": setup_s, "band_tiles": mv.band_tiles,
               "total_tiles": mv.total_tiles, "band_fraction": mv.band_tiles / mv.total_tiles,
               "pair_fraction": mv.pair_fraction, **b, "share_of_bound": b["bound_ms"] / ms}
        log(f"  {mode:5s} banded {n}x{n} r=1: kernel {ms:10.3f} ms  plain {pms:10.3f} ms  dense K2 {dms:10.3f} ms  "
            f"bound {b['bound_ms']:.3f} ms ({b['pipe']})  "
            f"band {mv.band_tiles}/{mv.total_tiles} tiles ({100 * row['band_fraction']:.2f} %), pairs "
            f"{100 * mv.pair_fraction:.2f} %; max|kernel - plain| {err:.3e} ({err / sc:.3e} of max), "
            f"vs dense {err_dense / sc:.3e}; schedule set-up {setup_s:.3f} s")
        # ff: two results each within one rounding of the f64 product, held
        # well under what the f32-summing plain body reads here (~6e-7).
        bound = {"plain": 1e-4, "ff": 1e-8, "f64": 1e-10}[mode]
        check(np.isfinite(err) and err <= bound * sc, f"{mode} banded at full shape within {bound:g} of max")
        check(np.isfinite(err_dense) and err_dense <= bound * sc, f"{mode} banded vs dense K2 within {bound:g}")
        del out, ref, dense
        # At r > 1 some of the 1e5 r entries that round the same f64 value
        # can land on the other side of a tie after a different summation
        # order: one f32 ulp, ~2 eps32 of the max at most, in mode ff.
        bound_r = {"plain": 1e-4, "ff": 2.5e-7, "f64": 1e-10}[mode]
        for r in (4, 256):
            V = torch.tensor(V_np[:, :r], device="cuda").to(dt)
            V_main = (V, V * 1e-8) if mode == "ff" else V
            mv(V_main)  # warm-up
            sync()
            ms_r, out = timed(lambda: mv(V_main), reps=3)
            pms_r, ref = timed(lambda: mv.plain(V_main), reps=1)
            if mode == "ff":
                out, ref = out[0], ref[0]
            sc = ref.abs().max().item()
            err = (out.double() - ref.double()).abs().max().item()
            b = kernel_bound(spec, mode, pairs, matvec_bytes(mode, n, n, 1, r), r=r, wide=r > 4)
            row[f"r{r}"] = {"ms": ms_r, "plain_ms": pms_r, "max_abs_err": err, "rel_err": err / sc, **b,
                            "share_of_bound": b["bound_ms"] / ms_r}
            log(f"  {mode:5s} banded {n}x{n} r={r}: kernel {ms_r:10.3f} ms  plain {pms_r:10.3f} ms  bound "
                f"{b['bound_ms']:.3f} ms ({b['pipe']})  max|kernel - plain| {err:.3e} ({err / sc:.3e} of max)")
            check(np.isfinite(err) and err <= bound_r * sc,
                  f"{mode} banded r={r} at full shape within {bound_r:g} of max")
            del V, V_main, out, ref
        log(f"  {mode:5s} banded r=256: multi-column route {row['r256']['ms']:.3f} ms; the r <= 4 route would take "
            f"64 launches of r=4: {64 * row['r4']['ms']:.1f} ms (an estimate: 64 x the r=4 time)")
        rows[mode] = row
        del Xd, v, v_main, mv
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


def _variance(reg, xq, block_sizes, tag, *, positive=True):
    """``reg.var`` at ``xq`` for each block size: seconds, CG iterations per
    block, std range; checks finite, ``0 <= var <= prior var`` (``0 <``
    where ``positive``), and that the partitions agree.  Returns the
    measurements and the first partition's variance (float64, host)."""
    import torch

    prior_var = reg.prior.cov(torch.from_numpy(np.asarray(xq, np.float64)).to(reg.device)).cpu()
    out, first = {}, None
    for bs in block_sizes:
        t0 = time.perf_counter()
        v = reg.var(torch.from_numpy(xq), block_size=bs)
        sync()
        secs = time.perf_counter() - t0
        v = v.double().cpu()
        lo_ok = bool((v > 0).all()) if positive else bool((v >= 0).all())
        check(bool(torch.isfinite(v).all()) and v.shape == (xq.shape[0],) and lo_ok
              and bool((v <= prior_var * (1 + 1e-6)).all()),
              f"{tag}: var at {xq.shape[0]} queries (block {bs}) finite, {'0 <' if positive else '0 <='} var <= "
              f"prior var; range [{v.min().item():.4e}, {v.max().item():.4e}]")
        out[f"block_{bs}"] = dict(seconds=secs, iterations=[it for it, _ in reg.var_info],
                                  relres=max(rr for _, rr in reg.var_info))
        if first is None:
            first = v
            out.update(var_min=v.min().item(), var_max=v.max().item(),
                       std_range=[float(np.sqrt(v.min().item())), float(np.sqrt(v.max().item()))])
        else:
            rel = ((v - first).abs().max() / first.max()).item()
            out[f"partition_rel_diff_{block_sizes[0]}_{bs}"] = rel
            # Each column is solved to relres tol = 1e-5; the CPU tests read
            # an error of ~0.3 tol relative to max var, the JAX package's TPU
            # run 1.1e-5 between partitions (RESULTS.md:256).  10 tol.
            check(rel <= VAR_REL_BOUND, f"{tag}: blocks {block_sizes[0]} and {bs} agree: {rel:.3e} of max var "
                  f"<= {VAR_REL_BOUND:g}")
    return out, first


def _reference_variance(reg, xq, block_size, tag):
    """``reg.var`` at ``xq`` in one block at each CG tol of ``REF_TOLS``:
    the measurements and the last (tightest) variance (float64, host);
    checks each relres, ``0 < var <= prior var`` and that the two agree
    within ``REF_AGREE`` of var per query."""
    import torch

    prior_var = reg.prior.cov(torch.from_numpy(np.asarray(xq, np.float64)).to(reg.device)).cpu()
    out, refs = {}, []
    for tol in REF_TOLS:
        t0 = time.perf_counter()
        ref = reg.var(torch.from_numpy(xq), block_size=block_size, tol=tol).double().cpu()
        sync()
        secs = time.perf_counter() - t0
        (it, rr), = reg.var_info
        check(rr <= tol and bool((ref > 0).all()) and bool((ref <= prior_var).all()),
              f"{tag}: var at tol {tol:g}: relres {rr:.3e}, 0 < var <= prior var, "
              f"range [{ref.min().item():.4e}, {ref.max().item():.4e}]")
        out[f"tol_{tol:g}"] = dict(seconds=secs, iterations=it, relres=rr,
                                   std_range=[ref.min().sqrt().item(), ref.max().sqrt().item()])
        refs.append(ref)
    rel = ((refs[0] - refs[1]).abs() / refs[1]).max().item()
    out["agree"] = rel
    check(rel <= REF_AGREE, f"{tag}: var at tol {REF_TOLS[0]:g} vs {REF_TOLS[1]:g}: {rel:.3e} of var, per query, "
          f"<= {REF_AGREE:g}")
    return out, refs[1]


def _tight_variance(reg, xq, block_size, tag):
    """``reg.var`` at ``xq`` in one block at CG tol :data:`FF_VAR_TOL`: the
    measurements and the variance (float64, host); checks the relres and
    ``0 < var <= prior var``."""
    import torch

    prior_var = reg.prior.cov(torch.from_numpy(np.asarray(xq, np.float64)).to(reg.device)).cpu()
    t0 = time.perf_counter()
    v = reg.var(torch.from_numpy(xq), block_size=block_size, tol=FF_VAR_TOL).double().cpu()
    sync()
    secs = time.perf_counter() - t0
    (it, rr), = reg.var_info
    check(rr <= FF_VAR_TOL and bool((v > 0).all()) and bool((v <= prior_var).all()),
          f"{tag}: var at tol {FF_VAR_TOL:g}: relres {rr:.3e}, 0 < var <= prior var, "
          f"range [{v.min().item():.4e}, {v.max().item():.4e}]")
    return dict(seconds=secs, iterations=it, relres=rr), v


def run_main_path(specs, k0, mode, n, nq, rank, *, device="cuda", tol=1e-5, maxiter=512, noise_rel=1e-3,
                  var_queries=0):
    """The heat benchmark problem through ``IterativeGPRegressor(prior, X, Y,
    L=H)``; ``specs``: the specs it must derive (``data/heat_bench_specs.json``).
    With ``var_queries``, then ``var`` at the first that many queries with
    ``block_size=256`` and again with ``128``; the variance is returned under
    ``"var"`` (a host float64 tensor)."""
    import torch

    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu_torch.ops.gram import gram_matvec_plain

    from linpde_gp_tpu_torch.ops import _cuda

    X, Y, Xq = bench_data(n, nq)
    sigma_sq = float(noise_rel * k0["obs"])
    prior, H = heat_problem(device)
    sym0 = _cuda.launches["gram_matvec_sym"]
    reg, w, mu, times = _solve_and_mean(lambda: IterativeGPRegressor(
        prior, torch.from_numpy(X), torch.from_numpy(Y), L=H,
        noise_variance=sigma_sq, tol=tol, maxiter=maxiter, precond_rank=rank, mode=mode, device=device,
    ), Xq)
    check(reg._obs_spec == specs["obs"] and reg._cross_spec == specs["cross"],
          f"heat[{mode}]: derived specs equal data/heat_bench_specs.json")
    check(reg._banded is None, f"heat[{mode}]: dense K2 route (no compact support)")
    if torch.device(device).type == "cuda":
        sym = _cuda.launches["gram_matvec_sym"] - sym0
        check(sym == reg.solve_info[0], f"heat[{mode}]: the CG launched K2's symmetric route once an iteration "
              f"({sym} launches, {reg.solve_info[0]} iterations)")
    res = _check_solution(
        reg, w, mu, Xq, mode, tol, sigma_sq,
        lambda X64, w64: gram_matvec_plain(reg._obs_spec, X64, X64, w64, "f64"), "heat",
    )
    out = dict(mode=mode, n=n, nq=nq, rank=rank, noise=sigma_sq, **res, **times)
    var = None
    if var_queries:
        out["variance"], var = _variance(reg, Xq[:var_queries], (256, 128), f"heat[{mode}]")
        s = out["variance"]["std_range"]
        # The JAX package's TPU run over 2048 queries of this distribution
        # read std in [0.6735, 0.8021] (RESULTS.md:256); 1 % slack for other queries.
        check(0.99 * 0.6735 <= s[0] and s[1] <= 1.01 * 0.8021,
              f"heat[{mode}]: std range [{s[0]:.4f}, {s[1]:.4f}] within the JAX run's [0.6735, 0.8021] +- 1 %")
    log(f"main[heat {mode}] " + json.dumps(out))
    out["var"] = var
    return out


def run_wendland_path(mode, n, nq, rank, *, device="cuda", tol=1e-5, maxiter=512, noise=1e-3, var_queries=0):
    """The Wendland experiment's problem through
    ``IterativeGPRegressor(prior, X, Y)``: banded CG, dense K2 mean; with
    ``var_queries``, then ``var`` at the first that many queries with
    ``block_size=256`` (banded CG at r = 256), in mode f64 also at the CG
    tols ``REF_TOLS`` (the reference).  The variances are returned under
    ``"var"`` and ``"var_ref"`` (host float64 tensors, or None)."""
    import torch

    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu_torch.ops.banded import make_banded_matvec

    X, _, Y, Xq = wendland_data(n, nq)
    tight = None
    reg, w, mu, times = _solve_and_mean(lambda: IterativeGPRegressor(
        wendland_prior(device), torch.from_numpy(X), torch.from_numpy(Y),
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
    var = ref = None
    if var_queries:
        xq = Xq[:var_queries].astype(np.float64)
        out["variance"], var = _variance(reg, xq, (256,), f"wendland[{mode}]")
        if mode == "f64":
            out["variance_ref"], ref = _reference_variance(reg, xq, 256, f"wendland[{mode}]")
        else:
            out["variance_tight"], tight = _tight_variance(reg, xq, 256, f"wendland[{mode}]")
    log(f"main[wendland {mode}] " + json.dumps(out))
    out["var"], out["var_ref"], out["var_tight"] = var, ref, tight
    return out


def run_ibvp_path(mode, n, nq, rank, *, device="cuda", n_ic=96, n_bc=48, tol=1e-5, maxiter=512, noise_rel=1e-3,
                  anchor_noise=1e-5, var_queries=64):
    """``experiments/large_scale_tpu.py``'s anchored heat IBVP through
    ``IterativeGPRegressor(prior, X, 0, L=H, anchor_X=..., anchor_Y=...)``:
    H u = 0 at N collocation points, u = u* at the IC and BC anchors,
    jointly by Schur elimination.  Checks finite weights, the solver's
    relres, the joint true relres of the 2 x 2 system by the float64 plain
    versions, the RMSE against u* at nq queries, then ``var`` at
    ``var_queries`` queries (one block), in mode f64 also at the CG tols
    ``REF_TOLS`` (returned under ``"var"`` and ``"var_ref"``)."""
    import torch

    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu_torch.ops.gram import gram_matvec_plain, gram_plain, kernel_term_specs
    from linpde_gp_tpu_torch.specs import spec_diagonal

    prior, H = heat_problem(device)
    X, Xq = ibvp_data(n, nq)
    Xa, Ya = ibvp_anchors(n_ic, n_bc)
    noise = noise_rel * spec_diagonal(heat_specs()["obs"])
    reg, w, mu, times = _solve_and_mean(lambda: IterativeGPRegressor(
        prior, torch.from_numpy(X), torch.zeros(n), L=H, noise_variance=noise, tol=tol, maxiter=maxiter,
        precond_rank=rank, mode=mode, device=device, anchor_X=Xa, anchor_Y=Ya, anchor_noise=anchor_noise,
    ), Xq)
    tag = f"ibvp[{mode}]"
    a = reg._anchors
    aw = reg.anchor_weights
    iters, relres = reg.solve_info
    check(bool(torch.isfinite(w).all()) and bool(torch.isfinite(aw).all()), f"{tag}: weights finite")
    check(relres <= 100 * tol, f"{tag}: solver relres {relres:.3e} <= {100 * tol:g}")
    # The joint residual of [[A11, W^T], [W, A22]] [aw; w] = [Y1; Y] by the f64
    # plain versions (A22 = k_HH + sigma^2 I, A11 = k + anchor_noise I).
    t0 = time.perf_counter()
    X64, X1 = reg.X.double(), a["X1"].double()
    w64, aw64, y1 = w.double(), aw.double(), a["Y1"].double()
    sk, tk = kernel_term_specs(prior.cov)
    sw, tw = kernel_term_specs(a["k_Lk"])
    A11 = sk * gram_plain(tk, X1, X1, "f64") + anchor_noise * torch.eye(X1.shape[0], dtype=torch.float64,
                                                                          device=X1.device)
    W = sw * gram_plain(tw, X64, X1, "f64")
    r1 = A11 @ aw64 + W.T @ w64 - y1
    r2 = W @ aw64 + gram_matvec_plain(reg._obs_spec, X64, X64, w64, "f64") + reg.noise_variance * w64 \
        - reg.Y.double()
    joint = (torch.sqrt(r1.square().sum() + r2.square().sum()) /
             torch.sqrt(y1.square().sum() + reg.Y.double().square().sum())).item()
    sync()
    t_check = time.perf_counter() - t0
    check(joint <= 1e-3, f"{tag}: joint true relres of the 2x2 system (f64 plain versions) {joint:.3e} <= 1e-3")
    err = mu.double().cpu().numpy() - u_star(Xq)
    rmse, max_err = float(np.sqrt(np.mean(err**2))), float(np.max(np.abs(err)))
    check(bool(np.isfinite(err).all()) and rmse <= 4e-4,
          f"{tag}: RMSE vs u* at {nq} queries {rmse:.3e} <= 4e-4 (the JAX package's TPU run: 1.977e-4); "
          f"max error {max_err:.3e}")
    out = dict(mode=mode, n=n, nq=nq, n_anchor=int(Xa.shape[0]), rank=rank, noise=reg.noise_variance,
               anchor_noise=anchor_noise, iterations=iters, relres=relres, joint_true_relres=joint, rmse=rmse,
               max_err=max_err, check_s=t_check, **times)
    var = ref = tight = None
    if var_queries:
        out["variance"], var = _variance(reg, Xq[:var_queries], (var_queries,), tag, positive=False)
        if mode == "f64":
            out["variance_ref"], ref = _reference_variance(reg, Xq[:var_queries], var_queries, tag)
        else:
            out["variance_tight"], tight = _tight_variance(reg, Xq[:var_queries], var_queries, tag)
    log(f"main[ibvp {mode}] " + json.dumps(out))
    out["var"], out["var_ref"], out["var_tight"] = var, ref, tight
    return out


def oracle_posterior(X, Y, Xq, noise, dev, anchors=None, cov_q=0):
    """The mean and variance at ``Xq`` of the float64 dense Cholesky posterior
    of the heat problem with ``H u = Y + eps`` at ``X`` (noise ``noise``) and,
    with ``anchors = (Xa, Ya, anchor_noise)``, ``u = Ya + eps`` at ``Xa``,
    built by hand from the plain versions on ``dev``, on the points as given
    (float32 arrays are read exactly in float64); with ``cov_q``, also the
    covariance matrix at the first ``cov_q`` queries (else ``None``)."""
    import torch

    from linpde_gp_tpu_torch.ops.gram import gram_plain, kernel_term_specs
    from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel

    prior, H = heat_problem(dev)
    specs = heat_specs()
    n = X.shape[0]
    X64, Xq64 = (torch.from_numpy(a.astype(np.float64)).to(dev) for a in (X, Xq))
    k_spec = kernel_term_specs(prior.cov)

    def dense(spec, x0, x1):
        return spec[0] * gram_plain(spec[1], x0, x1, "f64")

    G = dense(specs["obs"], X64, X64) + noise * torch.eye(n, dtype=torch.float64, device=dev)
    Kq = dense(specs["cross"], Xq64, X64)
    y = torch.from_numpy(Y.astype(np.float64)).to(dev)
    if anchors is not None:
        Xa, Ya, anchor_noise = anchors
        Xa64 = torch.from_numpy(Xa.astype(np.float64)).to(dev)
        WL = dense(kernel_term_specs(apply_operator_to_kernel(H, prior.cov, argnum=0)), X64, Xa64)
        A11 = dense(k_spec, Xa64, Xa64) + anchor_noise * torch.eye(Xa.shape[0], dtype=torch.float64, device=dev)
        G = torch.cat([torch.cat([A11, WL.T], 1), torch.cat([WL, G], 1)], 0)
        Kq = torch.cat([dense(k_spec, Xq64, Xa64), Kq], 1)
        y = torch.cat([torch.from_numpy(Ya.astype(np.float64)).to(dev), y])
    C = torch.linalg.cholesky(G)
    m_ref = Kq @ torch.cholesky_solve(y[:, None], C)[:, 0]
    v_ref = prior.cov(Xq64) - torch.sum(Kq * torch.cholesky_solve(Kq.T, C).T, 1)
    C_ref = None
    if cov_q:
        Kc = Kq[:cov_q]
        C_ref = dense(k_spec, Xq64[:cov_q], Xq64[:cov_q]) - Kc @ torch.cholesky_solve(Kc.T, C)
    return m_ref, v_ref, C_ref


def run_oracle_path(mode, *, n=4096, nq=128, n_anchor=24, device="cuda", rank=512, noise_rel=1e-3,
                    anchor_noise=1e-5, maxiter=1024):
    """The heat problem at a size where the dense posterior fits: ``var``
    (and the mean) at ``nq`` queries, without anchors and with ``n_anchor``
    initial-condition anchors, against a float64 dense Cholesky posterior
    on the card, on the same float32-rounded points."""
    import torch

    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu_torch.specs import spec_diagonal

    prior, H = heat_problem(device)
    X, Y, Xq = bench_data(n, nq)
    Xa, Ya = ibvp_anchors(n_anchor, 0)
    noise = noise_rel * spec_diagonal(heat_specs()["obs"])
    tol = ORACLE_TOL[mode]
    dev = torch.device(device)
    out = {}
    for anchored in (False, True):
        tag = f"oracle[{mode}{' anchored' if anchored else ''}]"
        kw = dict(anchor_X=Xa, anchor_Y=Ya, anchor_noise=anchor_noise) if anchored else {}
        t0 = time.perf_counter()
        reg = IterativeGPRegressor(prior, X, Y, L=H, noise_variance=noise, tol=tol, maxiter=maxiter,
                                   precond_rank=rank, mode=mode, device=device, **kw)
        mu = reg.mean(torch.from_numpy(Xq)).double()
        var = reg.var(torch.from_numpy(Xq), block_size=nq).double()
        sync()
        secs = time.perf_counter() - t0
        m_ref, v_ref, _ = oracle_posterior(X, Y, Xq, noise, dev, (Xa, Ya, anchor_noise) if anchored else None)
        e_var = ((var - v_ref).abs().max() / v_ref.max()).item()
        e_mean = ((mu - m_ref).abs().max() / m_ref.abs().max()).item()
        sync()
        bound = ORACLE_VAR_BOUND[mode]
        check(bool(torch.isfinite(var).all()) and e_var <= bound,
              f"{tag}: var at {nq} queries vs the f64 dense posterior: {e_var:.3e} of max var <= {bound:g} "
              f"(mean: {e_mean:.3e} of max |mean|)")
        out[tag] = dict(n=n, nq=nq, tol=tol, seconds=secs, solve=reg.solve_info, var_blocks=reg.var_info,
                        var_rel_err=e_var, mean_rel_err=e_mean, var_range=[v_ref.min().item(), v_ref.max().item()])
        log(f"main[{tag}] " + json.dumps(out[tag]))
    return out


def check_variances(res) -> None:
    """The variances of the heat, Wendland and IBVP runs (``res[path,
    mode]``): heat ff vs f64 (checked); Wendland and IBVP, the ff variance
    at tol :data:`FF_VAR_TOL` vs the f64 reference (checked, per query) and
    each mode's tol-1e-5 variance vs the reference (logged).  A missing
    run fails."""

    def var(path, mode, key="var"):
        v = res.get((path, mode), {}).get(key)
        check(v is not None, f"{path}[{mode}] {key} was computed")
        return v

    ff, f64 = var("heat", "ff"), var("heat", "f64")
    if ff is not None and f64 is not None:
        rel = ((ff - f64).abs().max() / f64.max()).item()
        check(rel <= VAR_REL_BOUND, f"heat var: ff vs f64 {rel:.3e} of max var <= {VAR_REL_BOUND:g}")
    for path in ("wendland", "ibvp"):
        ref = var(path, "f64", "var_ref")
        for mode in ("ff", "f64"):
            v = var(path, mode)
            if v is not None and ref is not None:
                rel = ((v - ref).abs() / ref).max().item()
                log(f"  {path}[{mode}] var at tol 1e-5 vs the f64 tol-{REF_TOLS[1]:g} reference: {rel:.3e} of var, "
                    "per query (not gated)")
        tight = var(path, "ff", "var_tight")
        if tight is not None and ref is not None:
            rel = ((tight - ref) / ref).abs().max().item()
            check(rel <= REF_AGREE, f"{path} var: ff at tol {FF_VAR_TOL:g} vs the f64 tol-{REF_TOLS[1]:g} reference: "
                  f"{rel:.3e} of var, per query <= {REF_AGREE:g}")


def phase_main(specs, k0, n, nq, rank) -> dict:
    """Every path, each run with the launch counts set to 0 before it and
    read after: heat (mean, then var), Wendland (mean, then var) and the
    anchored IBVP in modes ff and f64, then the small dense oracle in all
    three modes.  Returns the launches summed over the runs."""
    from linpde_gp_tpu_torch.ops import _cuda

    dense_paths = ("gram", "gram_matvec", "gram_matvec_wide")
    needed = {"heat": dense_paths, "ibvp": dense_paths, "oracle": dense_paths,
              "wendland": ("gram", "banded_matvec", "gram_matvec", "banded_matvec_wide")}
    runs = [(path, mode) for path in ("heat", "wendland", "ibvp") for mode in ("ff", "f64")]
    runs += [("oracle", mode) for mode in ("plain", "ff", "f64")]
    total = {name: 0 for name in KERNELS}
    res = {}
    for path, mode in runs:
        _cuda.reset_launches()
        try:
            if path == "heat":
                res[path, mode] = run_main_path(specs, k0, mode, n, nq, rank, var_queries=VAR_QUERIES)
            elif path == "wendland":
                res[path, mode] = run_wendland_path(mode, n, nq, WENDLAND_RANK, var_queries=VAR_QUERIES)
            elif path == "ibvp":
                res[path, mode] = run_ibvp_path(mode, n, nq, IBVP_RANK, var_queries=IBVP_VAR_QUERIES)
            else:
                run_oracle_path(mode)
        except Exception as exc:  # noqa: BLE001 - report, go on with the next run, fail at the end
            traceback.print_exc()
            failures.append(f"main[{path} {mode}]: {type(exc).__name__}: {exc}")
        per = dict(_cuda.launches)
        for name in total:
            total[name] += per[name]
        log(f"main[{path} {mode}] launches {per}")
        check(all(per[k] > 0 for k in needed[path]), f"main[{path} {mode}] launched {needed[path]}: {per}")
    check_variances(res)
    for name in KERNELS:
        check(total[name] > 0, f"main paths launched {name} {total[name]} times")
    return total


class Spans:
    """Host seconds (synchronized around each call) and calls of library
    functions, wrapped by name for the length of a ``with`` block; also the
    calls of the kernels' plain versions on CUDA tensors (``plain_on_cuda``),
    which the engine must never make.  ``keep[name](args, out)``, where
    given, picks what to keep of each call of ``name`` in ``kept[name]``."""

    def __init__(self, targets: dict, keep: dict | None = None):
        from linpde_gp_tpu_torch.ops import gram as gram_module

        self.targets = dict(targets)
        self.keep = dict(keep or {})
        self.kept = {name: [] for name in self.keep}
        self.plain = [(gram_module, "gram_plain"), (gram_module, "gram_matvec_plain")]
        self.seconds = {name: 0.0 for name in self.targets}
        self.longest = {name: 0.0 for name in self.targets}
        self.calls = {name: 0 for name in self.targets}
        self.plain_on_cuda = 0
        self._saved = []

    def _timed(self, name, fn):
        def wrapper(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            secs = time.perf_counter() - t0
            self.seconds[name] += secs
            self.longest[name] = max(self.longest[name], secs)
            self.calls[name] += 1
            if name in self.keep:
                self.kept[name].append(self.keep[name](args, out))
            return out

        return wrapper

    def _counted(self, fn):
        def wrapper(*args, **kwargs):
            import torch

            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                self.plain_on_cuda += 1
            return fn(*args, **kwargs)

        return wrapper

    def __enter__(self):
        for name, (module, attr) in self.targets.items():
            self._saved.append((module, attr, getattr(module, attr)))
            setattr(module, attr, self._timed(name, getattr(module, attr)))
        for module, attr in self.plain:
            self._saved.append((module, attr, getattr(module, attr)))
            setattr(module, attr, self._counted(getattr(module, attr)))
        return self

    def __exit__(self, *exc):
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        self._saved.clear()


def _strided(K):
    """About 64 x 64 entries of a K1 output, strided over both axes."""
    return K[:: max(1, K.shape[0] // 64), :: max(1, K.shape[1] // 64)]


def _k1_sample(args, out):
    """A K1 call's operands and a strided sample of its output (the whole
    output may be the 8.6 GB PDE block)."""
    return args, tuple(out.shape), _strided(out).clone()


def dense_spans() -> "Spans":
    """The dense engine's stages: every K1 Gram block (``ops/gram.gram``,
    each kept as :func:`_k1_sample`), the Cholesky factorizations
    (``chol._factor``, the Schur complements of ``chol_extend`` included),
    ``chol_extend`` whole, the weights' ``cho_solve``, and every K2 call
    (``ops/gram.gram_matvec``, kept whole: the mean's blocks)."""
    from linpde_gp_tpu_torch.models import gp as gp_module
    from linpde_gp_tpu_torch.ops import gram as gram_module
    from linpde_gp_tpu_torch.ops.linalg import chol as chol_module

    return Spans({"k1_gram_blocks": (gram_module, "gram"), "cholesky": (chol_module, "_factor"),
                  "chol_extend": (gp_module, "chol_extend"), "weights": (gp_module, "cho_solve"),
                  "k2_calls": (gram_module, "gram_matvec")},
                 keep={"k1_gram_blocks": _k1_sample, "k2_calls": lambda args, out: (args, out)})


def _check_dense_kernels(spans, tag, on_card) -> dict:
    """The dense engine's kernels against their plain versions on the same
    operands: the largest K1 block (launched again, after an untimed launch,
    and timed with CUDA events beside the plain version; the relaunch must give the engine's
    output exactly on a strided sample) within 1e-12 of its largest entry,
    k(0) of its kernel; every K2 call of the mean within 1e-12 of its row's
    sum_j |k_ij v_j|."""
    import torch

    from linpde_gp_tpu_torch.ops.gram import gram, gram_matvec_plain, gram_plain

    args, shape, sample = max(spans.kept["k1_gram_blocks"], key=lambda k: k[1][0] * k[1][1])
    terms, X0, X1, mode = args
    if on_card:
        # One untimed launch of each first: after empty_cache the first takes
        # its output from cudaMalloc.
        gram(terms, X0, X1, mode), gram_plain(terms, X0, X1, mode)
        k1_ms, K = timed(lambda: gram(terms, X0, X1, mode), reps=3)
        plain_ms, P = timed(lambda: gram_plain(terms, X0, X1, mode))
    else:
        k1_ms = plain_ms = None
        K, P = gram(terms, X0, X1, mode), gram_plain(terms, X0, X1, mode)
    same = torch.equal(_strided(K), sample)
    kd = P.abs().max().item()
    err = (K - P).abs().max().item()
    del K, P
    nd = X0.shape[1]
    b = kernel_bound((1.0, terms), mode, shape[0] * shape[1], 8 * (shape[0] * shape[1] + nd * (shape[0] + shape[1])))
    out = {"k1": dict(shape=list(shape), ms=k1_ms, plain_ms=plain_ms, max_abs_err=err, rel_err=err / kd, **b)}
    check(same, f"{tag}: K1 launched again on the {shape[0]}x{shape[1]} block's operands gives the engine's block")
    check(err <= 1e-12 * kd, f"{tag}: K1 f64 {shape[0]}x{shape[1]} block vs plain f64: {err / kd:.3e} k(0) <= 1e-12")
    if on_card:
        log(f"  {tag}: K1 f64 {shape[0]}x{shape[1]} {k1_ms:.3f} ms (CUDA events, mean of 3), plain {plain_ms:.1f} ms, "
            f"bound {b['bound_ms']:.3f} ms ({b['bound_by']}, {b['pipe']})")
    k2 = []
    for (spec, x, pts, v, mode), res in spans.kept["k2_calls"]:
        scale, terms = spec
        ref = gram_matvec_plain(spec, x, pts, v, mode)
        row_absum = abs(scale) * (gram_plain(terms, x, pts, mode).abs() @ v.abs())
        e_row = ((res - ref).abs() / row_absum).max().item()
        k2.append(dict(n0=x.shape[0], n1=pts.shape[0], r=1 if v.ndim == 1 else v.shape[1], row_rel_err=e_row,
                       max_abs_err=(res - ref).abs().max().item()))
        check(e_row <= 1e-12, f"{tag}: K2 f64 {x.shape[0]}x{pts.shape[0]} mean block vs plain f64: {e_row:.3e} of "
              "sum_j |k_ij v_j| <= 1e-12")
    out["k2"] = k2
    return out


def _panel_spans(fn) -> dict:
    """Counts of the ``lgt.chol.panel_*`` spans while ``fn()`` runs."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
        sync()
    names = [e.name for e in prof.events() if e.name.startswith("lgt.chol.panel")]
    return {k: names.count(k) for k in ("lgt.chol.panel_inv", "lgt.chol.panel_solve")}


def check_blocked_std(post, Xq, tag, on_card, reps=5) -> dict:
    """The variance's blocked substitution (``chol.panel_solve_sumsq``, the
    route ``var`` takes at this size) against cuBLAS's ``dtrsm`` route
    (``torch.linalg.solve_triangular``) at each of ``BLOCKED_STD_BATCHES``
    query points: var by both, and a reference's, dtrsm refined twice
    (``q += L^-1 (u - L q)``).  Checked per batch: the two routes within
    1e-12 of the prior variance, and the blocked var within 1e-8 of var per
    query of the reference's (var is up to ~3e6 times smaller than the prior
    variance it is taken from, so a per-query gap of 1e-12 between two
    float64 orders cannot hold; the explicit inverses alone, unrefined, read
    2e-8 to 1e-7).  Timed with CUDA events (median of ``reps``, after one
    untimed run): each route's solve, and the blocked one at each panel
    size of ``BLOCKED_STD_PANELS`` with its inverses' build.  The route
    engages: two ``var`` calls of a posterior without inverses build them
    once and take the blocked solve twice (``lgt.chol.panel_*`` span
    counts)."""
    import torch

    from linpde_gp_tpu_torch.ops.linalg import chol as chol_ops

    L = post.gram_cholesky
    n = L.shape[0]
    dev = L.device

    def median_ms(fn):
        fn()
        sync()
        if not on_card:
            return None
        return sorted(timed(fn)[0] for _ in range(reps))[reps // 2]

    out = {"n": n, "panel_rows": chol_ops.PANEL_ROWS}
    post._panels = None
    xs = torch.as_tensor(Xq[:2], dtype=torch.float64, device=dev)
    out["spans"] = _panel_spans(lambda: (post.var(xs), post.var(xs)))
    check(n <= chol_ops.PANEL_ROWS or out["spans"] == {"lgt.chol.panel_inv": 1, "lgt.chol.panel_solve": 2},
          f"{tag}: two var calls built the panel inverses once and took the blocked solve twice: {out['spans']}")
    out["refined_panels"] = [k for k, p in enumerate(post._panels.refine) if p is not None]
    panels = {nb: chol_ops.panel_inverses(L, nb) for nb in BLOCKED_STD_PANELS}
    out["build_ms"] = {nb: median_ms(lambda: chol_ops.panel_inverses(L, nb)) for nb in BLOCKED_STD_PANELS}
    rows = []
    for b in BLOCKED_STD_BATCHES:
        xq = torch.as_tensor(Xq[:b], dtype=torch.float64, device=dev)
        u = post.kLas.evaluate(xq).reshape(-1, n).T
        pv = post.prior.var(xq)
        q = torch.linalg.solve_triangular(L, u, upper=False)
        for _ in range(2):
            q += torch.linalg.solve_triangular(L, u - L @ q, upper=False)
        ref = pv - torch.sum(q * q, 0)
        del q
        v_blk = post.var(xq)
        v_cub = pv - torch.sum(torch.linalg.solve_triangular(L, u, upper=False) ** 2, 0)
        row = dict(b=b, pv_over_var=(pv / ref).max().item(),
                   vs_cublas_of_prior=((v_blk - v_cub).abs() / pv).max().item(),
                   blocked_err=((v_blk - ref).abs() / ref).max().item(),
                   cublas_err=((v_cub - ref).abs() / ref).max().item(),
                   cublas_ms=median_ms(lambda: torch.linalg.solve_triangular(L, u, upper=False)),
                   blocked_ms={nb: median_ms(lambda: chol_ops.panel_solve_sumsq(L, panels[nb], u))
                               for nb in BLOCKED_STD_PANELS})
        rows.append(row)
        check(row["vs_cublas_of_prior"] <= 1e-12,
              f"{tag}: blocked vs dtrsm var at {b} queries {row['vs_cublas_of_prior']:.3e} of the prior variance "
              "<= 1e-12")
        check(row["blocked_err"] <= 1e-8,
              f"{tag}: blocked var at {b} queries {row['blocked_err']:.3e} of var per query vs dtrsm refined twice "
              f"<= 1e-8 (dtrsm alone: {row['cublas_err']:.3e})")
        if on_card:
            log(f"  {tag}: std solve at b = {b}: dtrsm {row['cublas_ms']:.3f} ms, blocked "
                + ", ".join(f"nb {nb} {ms:.3f} ms" for nb, ms in row["blocked_ms"].items()))
        del u
    out["batches"] = rows
    log(f"dense[{tag} blocked std] " + json.dumps(out))
    return out


def condition_dense_ibvp(prior, H, X, Xa, Ya, cuts, noise, anchor_noise):
    """The dense IBVP posterior: ``prior`` conditioned on the anchors
    ``Xa[cuts[i]:cuts[i + 1]]`` one set at a time (noise ``anchor_noise``),
    then on ``H u = 0`` at ``X`` (noise ``noise``)."""
    import linpde_gp_tpu_torch as lgt

    post = prior
    for a, b in zip(cuts[:-1], cuts[1:]):
        m = b - a
        post = post.condition_on_observations(Ya[a:b], X=Xa[a:b], b=lgt.Normal(np.zeros(m), anchor_noise * np.ones(m)))
    n = X.shape[0]
    return post.condition_on_observations(np.zeros(n), X=X, L=H, b=lgt.Normal(np.zeros(n), noise * np.ones(n)))


def run_dense_path(n, nq, *, device="cuda", n_ic=96, n_bc=48, noise_rel=1e-3, anchor_noise=1e-5, var_q=256,
                   cov_q=256, rank=IBVP_RANK, it_tol=1e-10, maxiter=2000):
    """The dense conditioning engine on the anchored heat IBVP
    (``GaussianProcess.condition_on_observations``, float64): the 96 IC
    anchors, then each 48-point BC set (``chol_extend`` twice), then ``H u =
    0 + eps`` at ``n`` collocation points (``chol_extend`` once more); then
    ``mean`` and ``std`` at ``nq`` queries, ``var`` and ``cov.matrix`` at the
    first ``cov_q``.  The launch counts are set to 0 just before the engine's
    work and read just after it (``launches``), the mean's apart
    (``mean_launches``: K2 once per block, no K1, no multi-column route).
    Checks the engine's K1 and K2 calls against their plain versions
    (:func:`_check_dense_kernels`), the RMSE against u*, diag(cov.matrix)
    against var, finite values, peak device memory, no plain version on a
    CUDA tensor, and then, outside the counted window, the agreement with the
    port's ``IterativeGPRegressor`` on the same data (f64, CG tol ``it_tol``:
    mean at ``nq`` queries, var at ``var_q``).  Returns the measurements."""
    import torch

    import linpde_gp_tpu_torch as lgt
    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.specs import spec_diagonal

    tag = "dense ibvp"
    prior, H = heat_problem(device)
    X, Xq = ibvp_data(n, nq)
    Xa, Ya = ibvp_anchors(n_ic, n_bc)
    noise = noise_rel * spec_diagonal(heat_specs()["obs"])
    cuts = (0, n_ic, n_ic + n_bc, n_ic + 2 * n_bc)
    on_card = torch.device(device).type == "cuda"
    # Warm-up at a small size (library handles, allocator), not timed.
    warm = prior.condition_on_observations(Ya[:8], X=Xa[:8], b=lgt.Normal(np.zeros(8), anchor_noise * np.ones(8)))
    warm = warm.condition_on_observations(np.zeros(256), X=X[:256], L=H,
                                          b=lgt.Normal(np.zeros(256), noise * np.ones(256)))
    warm.std(Xq[:256]), warm.mean(Xq[:256]), warm.cov.matrix(Xq[:16])
    del warm
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    spans = dense_spans()
    out = dict(n=n, nq=nq, n_anchor=int(Xa.shape[0]), noise=noise, anchor_noise=anchor_noise)
    _cuda.reset_launches()
    with spans:
        t0 = time.perf_counter()
        post = condition_dense_ibvp(prior, H, X, Xa, Ya, cuts, noise, anchor_noise)
        sync()
        out["condition_s"] = time.perf_counter() - t0
        out["stages_s"] = {k: v for k, v in spans.seconds.items() if k != "k2_calls"}
        out["stage_calls"] = {k: v for k, v in spans.calls.items() if k != "k2_calls"}
        out["stage_longest_s"] = {k: v for k, v in spans.longest.items() if k != "k2_calls"}
        before = dict(_cuda.launches)
        spans.kept["k2_calls"].clear()
        t0 = time.perf_counter()
        mu = post.mean(Xq)
        sync()
        out["mean_s"] = time.perf_counter() - t0
        out["mean_launches"] = {k: _cuda.launches[k] - before[k] for k in before}
        k2_mean = list(spans.kept["k2_calls"])
        t0 = time.perf_counter()
        sd = post.std(Xq)
        sync()
        out["std_s"] = time.perf_counter() - t0
        out["std_s_per_256"] = out["std_s"] * 256 / nq
        var = post.var(Xq[:cov_q])
        t0 = time.perf_counter()
        C = post.cov.matrix(Xq[:cov_q])
        sync()
        out["cov_matrix_s"] = time.perf_counter() - t0
    out["launches"] = dict(_cuda.launches)
    spans.kept["k2_calls"] = k2_mean
    out["plain_calls_on_cuda"] = spans.plain_on_cuda
    routes = [blk.matvec_route for blk in post.kLas]
    out["mean_routes"] = routes
    out["factor"] = list(post.gram_cholesky.shape)
    if on_card:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {tag}: engine launches {out['launches']}; the mean's {out['mean_launches']}; "
        f"routes by block (IC, BC x=-1, BC x=1, PDE): {routes}")
    out["blocked_std"] = check_blocked_std(post, Xq, tag, on_card)
    check(post.gram_cholesky.shape == (n + Xa.shape[0],) * 2 and post.gram_cholesky.dtype == torch.float64,
          f"{tag}: one f64 factor of {n + Xa.shape[0]}^2, grown by chol_extend {spans.calls['chol_extend']} times")
    check(spans.calls["chol_extend"] == 3, f"{tag}: chol_extend ran 3 times")
    check(spans.plain_on_cuda == 0 or not on_card,
          f"{tag}: no plain version on a CUDA tensor ({spans.plain_on_cuda} calls)")
    check(all(r == "K2" for r in routes) and len(k2_mean) == len(routes),
          f"{tag}: every mean block routed to K2 ({len(k2_mean)} K2 calls for {len(routes)} blocks)")
    if on_card:
        ml, el = out["mean_launches"], out["launches"]
        check(ml["gram_matvec"] == len(routes) and ml["gram"] == 0 and ml["gram_matvec_wide"] == 0,
              f"{tag}: the mean launched K2 at r = 1 once per block and no K1 or multi-column route: {ml}")
        check(el["gram"] > 0 and el["gram_matvec"] > 0 and el["gram_matvec_wide"] == 0
              and el["banded_matvec"] == 0 and el["banded_matvec_wide"] == 0,
              f"{tag}: the engine launched K1 and K2 at r = 1, nothing else: {el}")
    finite = all(bool(torch.isfinite(t).all()) for t in (mu, sd, var, C))
    check(finite and mu.shape == (nq,) and sd.shape == (nq,) and C.shape == (cov_q, cov_q),
          f"{tag}: mean, std at {nq} queries, var and cov.matrix at {cov_q} finite, of their shapes")
    err = mu.double().cpu().numpy() - u_star(Xq)
    rmse = float(np.sqrt(np.mean(err**2)))
    out.update(rmse=rmse, max_err=float(np.max(np.abs(err))))
    check(rmse <= 4e-4, f"{tag}: RMSE vs u* at {nq} queries {rmse:.3e} <= 4e-4")
    # cov.matrix's diagonal is a GEMM's (K - q0^T q0, as in the JAX package),
    # var a column sum of q0^2: each rounds ~1e4 products summing to ~k(0).
    k_prior = prior.cov(Xq[:cov_q]).abs().max().item()
    diag_err = (torch.diagonal(C) - var).abs().max().item() / k_prior
    out.update(diag_vs_var=diag_err, diag_vs_var_of_max_var=diag_err * k_prior / var.max().item())
    check(diag_err <= DIAG_BOUND, f"{tag}: diag(cov.matrix) vs var at {cov_q} queries {diag_err:.3e} of the prior "
          f"variance <= {DIAG_BOUND:g} ({out['diag_vs_var_of_max_var']:.3e} of max var)")
    if on_card:
        check(out["peak_gb"] < 40, f"{tag}: peak device memory {out['peak_gb']:.2f} GB < 40")
    mu_d, var_d = mu.double().cpu(), var.double().cpu()
    out["var_range"] = [var_d.min().item(), var_d.max().item()]
    del post, mu, sd, var, C
    if on_card:
        torch.cuda.empty_cache()
    out.update(_check_dense_kernels(spans, tag, on_card))
    del spans
    if on_card:
        torch.cuda.empty_cache()

    # The gram-free regressor on the same data and anchors, f64, tight tol.
    t0 = time.perf_counter()
    reg = IterativeGPRegressor(prior, X, np.zeros(n), L=H, noise_variance=noise, tol=it_tol, maxiter=maxiter,
                               precond_rank=rank, mode="f64", device=device, anchor_X=Xa, anchor_Y=Ya,
                               anchor_noise=anchor_noise)
    mu_it = reg.mean(torch.from_numpy(Xq)).double().cpu()
    var_it = reg.var(torch.from_numpy(Xq[:var_q]), block_size=var_q, tol=it_tol).double().cpu()
    sync()
    out["iterative"] = dict(seconds=time.perf_counter() - t0, solve=reg.solve_info, var_blocks=reg.var_info)
    e_mean = ((mu_d - mu_it).abs().max() / mu_it.abs().max()).item()
    e_var = ((var_d[:var_q] - var_it).abs() / var_it).max().item()
    out.update(mean_vs_iterative=e_mean, var_vs_iterative=e_var)
    check(e_mean <= 1e-6, f"{tag}: mean vs IterativeGPRegressor (f64, tol {it_tol:g}) {e_mean:.3e} of max |mean| "
          "<= 1e-6")
    check(e_var <= 1e-3, f"{tag}: var vs IterativeGPRegressor at {var_q} queries {e_var:.3e} of var, per query "
          "<= 1e-3")
    log(f"dense[{tag}] " + json.dumps(out))
    return out


def run_dense_oracle(*, refine=False, n=4096, nq=128, n_anchor=24, device="cuda", noise_rel=1e-3,
                     anchor_noise=1e-5):
    """The dense engine at ``run_oracle_path``'s size (24 IC anchors, then
    N = 4,096 PDE points) against the hand-built f64 Cholesky posterior
    (:func:`oracle_posterior`): mean, var and ``cov.matrix`` (all its
    entries) at ``nq`` queries within 1e-9 of max |mean| and max var; with
    ``refine`` (``config.solve_refinement``, a float32 factor refined in
    f64) the mean and ``cov.matrix`` within 1e-6.  The launch counts are
    set to 0 just before the engine's work and read just after
    (``launches``)."""
    import torch

    import linpde_gp_tpu_torch as lgt
    from linpde_gp_tpu_torch.config import config
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.specs import spec_diagonal

    tag = f"dense oracle{' refined' if refine else ''}"
    prior, H = heat_problem(device)
    X, Y, Xq = bench_data(n, nq)
    Xa, Ya = ibvp_anchors(n_anchor, 0)
    noise = noise_rel * spec_diagonal(heat_specs()["obs"])
    config.set(solve_refinement=refine)
    _cuda.reset_launches()
    try:
        t0 = time.perf_counter()
        post = prior.condition_on_observations(Ya, X=Xa, b=lgt.Normal(np.zeros(n_anchor),
                                                                      anchor_noise * np.ones(n_anchor)))
        post = post.condition_on_observations(Y, X=X, L=H, b=lgt.Normal(np.zeros(n), noise * np.ones(n)))
        mu, var, C = post.mean(Xq), post.var(Xq), post.cov.matrix(Xq)
        sync()
        secs = time.perf_counter() - t0
        factor = str(post.gram_cholesky.dtype)
    finally:
        config.set(solve_refinement=False)
    launches = dict(_cuda.launches)
    m_ref, v_ref, C_ref = oracle_posterior(X, Y, Xq, noise, torch.device(device), (Xa, Ya, anchor_noise), cov_q=nq)
    e_mean = ((mu - m_ref).abs().max() / m_ref.abs().max()).item()
    e_var = ((var - v_ref).abs().max() / v_ref.max()).item()
    e_cov = ((C - C_ref).abs().max() / v_ref.max()).item()
    sync()
    out = dict(n=n, nq=nq, n_anchor=n_anchor, factor=factor, seconds=secs, mean_rel_err=e_mean, var_rel_err=e_var,
               cov_rel_err=e_cov, launches=launches)
    finite = all(bool(torch.isfinite(t).all()) for t in (mu, var, C))
    if refine:
        check(finite and factor == "torch.float32" and e_mean <= 1e-6 and e_cov <= 1e-6,
              f"{tag}: float32 factor; mean {e_mean:.3e} of max |mean| and cov.matrix {e_cov:.3e} of max var vs the "
              f"f64 dense posterior <= 1e-6 (var: {e_var:.3e} of max var)")
    else:
        check(finite and e_mean <= 1e-9 and e_var <= 1e-9 and e_cov <= 1e-9,
              f"{tag}: mean {e_mean:.3e} of max |mean|, var {e_var:.3e} and cov.matrix {e_cov:.3e} of max var vs "
              "the f64 dense posterior <= 1e-9")
    log(f"dense[{tag}] " + json.dumps(out))
    return out


def phase_dense(n, nq) -> dict:
    """The dense engine's runs: the dense IBVP at ``n`` PDE points, then the
    oracle plain and refined.  Each run sets the launch counts to 0 just
    before the engine's work and reads them just after (K1 and K2 must
    launch); its references run outside that window.  Returns the engine's
    launches summed over the runs."""
    total = {name: 0 for name in KERNELS}
    for name, run in (("ibvp", lambda: run_dense_path(n, nq)), ("oracle", lambda: run_dense_oracle()),
                      ("oracle refined", lambda: run_dense_oracle(refine=True))):
        per = None
        try:
            per = run()["launches"]
        except Exception as exc:  # noqa: BLE001 - report, go on with the next run, fail at the end
            traceback.print_exc()
            failures.append(f"dense[{name}]: {type(exc).__name__}: {exc}")
        if per is None:
            continue
        for key in total:
            total[key] += per[key]
        log(f"dense[{name}] engine launches {per}")
        check(per["gram"] > 0 and per["gram_matvec"] > 0, f"dense[{name}] launched K1 and K2: {per}")
    return total


#: The mean phase's prior mean: m(t, x) = exp(-MEAN_DECAY t) sin(pi (x + 1)
#: / 2), the IBVP's solution with the wrong decay rate (u* decays at 0.1 pi^2
#: / 4 = 0.247); under H = d/dt - 0.1 d^2/dx^2 it is (0.1 pi^2 / 4 -
#: MEAN_DECAY) m.
MEAN_DECAY = 0.3
#: The dense engine's size in the mean phase, held to the regressor there.
MEAN_DENSE_N = 4096


def prior_mean_fn(x):
    """The mean phase's prior mean on torch tensors of shape (..., 2)."""
    import torch

    return torch.exp(-MEAN_DECAY * x[..., 0]) * torch.sin(torch.pi * (x[..., 1] + 1.0) / 2.0)


def heat_mean_closed_form(x):
    """``H m`` in closed form."""
    import torch

    return (0.1 * torch.pi**2 / 4.0 - MEAN_DECAY) * prior_mean_fn(x)


def mean_prior(device="cuda"):
    """The heat prior with the mean :func:`prior_mean_fn` (a torch
    ``LambdaFunction``) on ``device``, and H."""
    from linpde_gp_tpu_torch import GaussianProcess
    from linpde_gp_tpu_torch.models.functions import LambdaFunction

    prior, H = heat_problem(device)
    return GaussianProcess(LambdaFunction(prior_mean_fn, (2,)), prior.cov, device=device), H


def run_mean_path(mode, n, nq, rank, *, device="cuda", n_ic=96, n_bc=48, tol=1e-5, maxiter=512, noise_rel=1e-3,
                  anchor_noise=1e-5):
    """The anchored heat IBVP of :func:`run_ibvp_path` with the prior mean
    :func:`prior_mean_fn`: ``IterativeGPRegressor(prior, X, 0, L=H,
    anchor_X=..., anchor_Y=...)``, whose CG solves for the residual data
    ``0 - H m(X)`` and ``Y1 - m(X1)``.  The launch counts are read just
    after the path's work (build, solve, mean), before its checks: finite
    weights, the solver's relres, the joint true relres of the 2 x 2 system
    on the residual data (f64 plain versions), the RMSE against u*, ``H m``
    on the card against its closed form, and on the card the run's K1 and
    K2 calls against their plain versions.  Returns the measurements and,
    under ``"reg"``, the regressor."""
    import torch

    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.ops.gram import gram_matvec_plain, gram_plain, kernel_term_specs
    from linpde_gp_tpu_torch.specs import spec_diagonal

    tag = f"mean[{mode}]"
    prior, H = mean_prior(device)
    X, Xq = ibvp_data(n, nq)
    Xa, Ya = ibvp_anchors(n_ic, n_bc)
    noise = noise_rel * spec_diagonal(heat_specs()["obs"])
    on_card = torch.device(device).type == "cuda"
    # The first nested jvp in a process costs seconds on the card (6.5 s in
    # a solve, PERF.md), once: it is timed here, apart from the solve.
    sync()
    t0 = time.perf_counter()
    H(prior.mean)(torch.from_numpy(X.astype(np.float64)).to(device))
    sync()
    hm_first_s = time.perf_counter() - t0
    with grid_spans(_keep_mean_k2) as spans:
        _cuda.reset_launches()
        reg, w, mu, times = _solve_and_mean(lambda: IterativeGPRegressor(
            prior, torch.from_numpy(X), torch.zeros(n), L=H, noise_variance=noise, tol=tol, maxiter=maxiter,
            precond_rank=rank, mode=mode, device=device, anchor_X=Xa, anchor_Y=Ya, anchor_noise=anchor_noise,
        ), Xq)
        launches = dict(_cuda.launches)
    out = dict(mode=mode, n=n, nq=nq, n_anchor=int(Xa.shape[0]), rank=rank, noise=noise, anchor_noise=anchor_noise,
               hm_first_s=hm_first_s, **times, launches=launches,
               spans={name: dict(calls=spans.calls[name], seconds=spans.seconds[name], longest=spans.longest[name])
                      for name in spans.calls})
    if on_card:
        out["kernel_check"] = _check_grid_kernels(spans, tag, min_k1=3)
    # H m at the points as the regressor holds them, on the card, against its closed form.
    X64 = reg.X.double()
    sync()
    t0 = time.perf_counter()
    hm = reg._mean_obs(X64)
    sync()
    out["hm_s"] = time.perf_counter() - t0
    hm_ref = heat_mean_closed_form(X64)
    e_hm = ((hm - hm_ref).abs().max() / hm_ref.abs().max()).item()
    check(type(reg._mean_obs).__name__ == "DiffopFunction" and hm.device == X64.device and e_hm <= 1e-12,
          f"{tag}: H m by nested jvp at {n} points on {hm.device} vs its closed form: {e_hm:.3e} of max |H m| "
          f"<= 1e-12; {out['hm_s']:.3f} s")
    aw = reg.anchor_weights
    iters, relres = reg.solve_info
    check(bool(torch.isfinite(w).all()) and bool(torch.isfinite(aw).all()), f"{tag}: weights finite")
    check(relres <= 100 * tol, f"{tag}: solver relres {relres:.3e} <= {100 * tol:g}")
    # The joint residual of [[A11, W^T], [W, A22]] [aw; w] = [Y1 - m(X1); Y - H m(X)].
    a = reg._anchors
    X1 = a["X1"].double()
    w64, aw64 = w.double(), aw.double()
    y1 = a["Y1"].double() - prior_mean_fn(X1)
    y2 = reg.Y.double() - hm_ref
    sk, tk = kernel_term_specs(prior.cov)
    sw, tw = kernel_term_specs(a["k_Lk"])
    A11 = sk * gram_plain(tk, X1, X1, "f64") + anchor_noise * torch.eye(X1.shape[0], dtype=torch.float64,
                                                                          device=X1.device)
    W = sw * gram_plain(tw, X64, X1, "f64")
    r1 = A11 @ aw64 + W.T @ w64 - y1
    r2 = W @ aw64 + gram_matvec_plain(reg._obs_spec, X64, X64, w64, "f64") + noise * w64 - y2
    joint = (torch.sqrt(r1.square().sum() + r2.square().sum()) /
             torch.sqrt(y1.square().sum() + y2.square().sum())).item()
    check(joint <= 1e-3, f"{tag}: joint true relres of the 2x2 system on the residual data (f64 plain versions) "
          f"{joint:.3e} <= 1e-3")
    err = mu.double().cpu().numpy() - u_star(Xq)
    rmse, max_err = float(np.sqrt(np.mean(err**2))), float(np.max(np.abs(err)))
    check(bool(np.isfinite(err).all()) and rmse <= 4e-4,
          f"{tag}: RMSE vs u* at {nq} queries {rmse:.3e} <= 4e-4; max error {max_err:.3e}")
    out.update(iterations=iters, relres=relres, joint_true_relres=joint, rmse=rmse, max_err=max_err, hm_rel_err=e_hm,
               solve_ms_per_iteration=1e3 * times["solve_s"] / max(iters, 1))
    log(f"mean[{mode}] " + json.dumps(out))
    out["reg"] = reg
    return out


def check_mean_identities(reg, n, nq, *, it_tol=1e-10, maxiter=4000, n_dense=MEAN_DENSE_N, dense_q=1024):
    """Outside the counted window, in f64: (1) the regressor with the mean
    ``reg`` (re-solved at CG tol ``it_tol``) against a zero-mean regressor on
    the shifted data ``0 - H m(X)`` and ``Y1 - m(X1)``, plus ``m(xq)``, at
    ``nq`` queries; (2) the dense engine with the mean at ``n_dense`` PDE
    points and the anchors against the regressor with the mean on the same
    data (tol ``it_tol``) at ``dense_q`` queries.  Each within 1e-6 of max
    |mean|.  Returns the measurements."""
    import torch

    import linpde_gp_tpu_torch as lgt
    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor

    device = reg.device
    prior, H = mean_prior(device)
    zero, _ = heat_problem(device)
    X, Xq = ibvp_data(n, nq)
    a = reg._anchors
    Xa, Ya = a["X1"].double(), a["Y1"].double()
    kw = dict(L=H, noise_variance=reg.noise_variance, tol=it_tol, maxiter=maxiter, precond_rank=reg.precond_rank,
              mode="f64", device=device, anchor_X=Xa, anchor_noise=a["noise"])
    out = {}
    t0 = time.perf_counter()
    reg.tol, reg.maxiter = it_tol, maxiter
    mu = reg.refit(reg.Y).mean(torch.from_numpy(Xq)).double()
    X64 = torch.from_numpy(X.astype(np.float64)).to(device)
    shifted = IterativeGPRegressor(zero, X64, -heat_mean_closed_form(X64), anchor_Y=Ya - prior_mean_fn(Xa), **kw)
    xq64 = torch.from_numpy(Xq.astype(np.float64)).to(device)
    want = shifted.mean(xq64) + prior_mean_fn(xq64)
    sync()
    e = ((mu - want).abs().max() / want.abs().max()).item()
    out["shifted"] = dict(seconds=time.perf_counter() - t0, solve=reg.solve_info, shifted_solve=shifted.solve_info,
                          rel_err=e)
    check(e <= 1e-6, f"mean[f64] at tol {it_tol:g} vs a zero-mean regressor on the shifted data plus m: {e:.3e} of "
          f"max |mean| <= 1e-6 (solves {reg.solve_info}, {shifted.solve_info})")
    del shifted
    # The dense engine with the mean against the regressor with the mean.
    t0 = time.perf_counter()
    Xd = X[:n_dense]
    m1 = Xa.shape[0]
    post = prior.condition_on_observations(Ya, X=Xa, b=lgt.Normal(np.zeros(m1), a["noise"] * np.ones(m1)))
    post = post.condition_on_observations(np.zeros(n_dense), X=Xd, L=H,
                                          b=lgt.Normal(np.zeros(n_dense), reg.noise_variance * np.ones(n_dense)))
    mu_dense = post.mean(Xq[:dense_q]).double()
    sync()
    dense_s = time.perf_counter() - t0
    small = IterativeGPRegressor(prior, Xd, np.zeros(n_dense), anchor_Y=Ya, **dict(kw, precond_rank=512))
    mu_it = small.mean(torch.from_numpy(Xq[:dense_q])).double()
    e = ((mu_dense - mu_it).abs().max() / mu_it.abs().max()).item()
    out["dense"] = dict(n=n_dense, nq=dense_q, seconds=dense_s, solve=small.solve_info, rel_err=e)
    check(e <= 1e-6, f"mean: the dense engine with the mean at N = {n_dense} vs the regressor with the mean (f64, tol "
          f"{it_tol:g}): {e:.3e} of max |mean| <= 1e-6 (CG {small.solve_info})")
    log("mean[identities] " + json.dumps(out))
    return out


def phase_mean(n, nq) -> dict:
    """The mean path (:func:`run_mean_path`) in modes ff and f64, each with
    the launch counts set to 0 before it and read just after its work: K1
    and K2 at r = 1 must launch, the multi-column and banded routes must
    not.  Then :func:`check_mean_identities` on the f64 regressor.  Returns
    the launches summed over the two runs."""
    total = {name: 0 for name in KERNELS}
    regs = {}
    for mode in ("ff", "f64"):
        res = run_mean_path(mode, n, nq, IBVP_RANK)
        per = res["launches"]
        for name in total:
            total[name] += per[name]
        log(f"mean[{mode}] launches {per}")
        check(per["gram"] > 0 and per["gram_matvec"] > 0 and per["gram_matvec_wide"] == 0
              and per["banded_matvec"] == per["banded_matvec_wide"] == 0,
              f"mean[{mode}] launched K1 and K2 at r = 1 and no multi-column or banded route: {per}")
        regs[mode] = res["reg"]
    del regs["ff"]
    check_mean_identities(regs["f64"], n, nq)
    return total


def _radial_poisson(device):
    """The radial-Matérn 2-D Poisson dense posterior of
    ``tests/test_radial_matern.py:96`` on ``device``, with observation noise
    1e-8 (the reference-parity fixtures'): its mean and std at 64 seeded
    queries.  Noiseless, boundary points 1.4e-6 apart at the corners make
    the std rounding-sensitive: permuting the points moves it by 2e-5 of
    its max on the CPU, where with the noise it moves by 2e-13."""
    import linpde_gp_tpu_torch as lgt

    bvp = lgt.problems.PoissonEquationDirichletProblem(
        domain=lgt.domains.Box([[-1.0, 1.0], [-1.0, 1.0]]), rhs=lgt.functions.Constant((2,), 2.0),
        boundary_values=lgt.functions.Constant((2,), 0.0),
    )
    post = lgt.GaussianProcess(lgt.functions.Zero((2,)), 2.0**2 * lgt.kernels.Matern((2,), nu=2.5, lengthscales=1.0),
                               device=device)
    for bc in bvp.boundary_conditions:
        X_bc = np.asarray(bc.boundary.uniform_grid(6, inset=1e-6)).reshape(-1, 2)
        m = X_bc.shape[0]
        post = post.condition_on_observations(np.zeros(m), X=X_bc, b=lgt.Normal(np.zeros(m), 1e-8 * np.ones(m)))
    X_pde = np.asarray(bvp.domain.uniform_grid((7, 7))).reshape(-1, 2)
    post = post.condition_on_observations(np.full(49, 2.0), X=X_pde, L=bvp.pde.diffop,
                                          b=lgt.Normal(np.zeros(49), 1e-8 * np.ones(49)))
    xq = np.random.default_rng(5).uniform(-1.0, 1.0, (64, 2))
    return post.mean(xq), post.std(xq)


def _autodiff_gram(device):
    """``Laplacian k Laplacian*`` of a 2-D ExpQuad with the autodiff route
    forced: its Gram at 300 x 200 seeded points (no pair on the diagonal)."""
    import torch

    import linpde_gp_tpu_torch as lgt
    from linpde_gp_tpu_torch.ops.gram import gram_matrix
    from linpde_gp_tpu_torch.ops.transforms import AutodiffTransformedKernel, as_coefficients

    c = as_coefficients(lgt.diffops.Laplacian((2,)))
    kk = AutodiffTransformedKernel(lgt.kernels.ExpQuad((2,), lengthscales=np.array([0.7, 1.3])), c, c)
    rng = np.random.default_rng(6)
    X0, X1 = (torch.from_numpy(rng.uniform(-1.0, 1.0, (m, 2))).to(device) for m in (300, 200))
    return (gram_matrix(kk, X0, X1, "f64"),)


def _general_nu_gram(device):
    """The Gram of a 2-D Matérn nu = 1.2 (the host Bessel round trip) at 300
    x 200 seeded points."""
    import torch

    import linpde_gp_tpu_torch as lgt
    from linpde_gp_tpu_torch.ops.gram import gram_matrix

    rng = np.random.default_rng(8)
    X0, X1 = (torch.from_numpy(rng.uniform(-1.0, 1.0, (m, 2))).to(device) for m in (300, 200))
    return (gram_matrix(lgt.kernels.Matern((2,), nu=1.2, lengthscales=0.8), X0, X1, "f64"),)


def phase_symbolic(device="cuda") -> dict:
    """The symbolic routes without a kernel spec on CUDA tensors, each held
    to the same call on the CPU within 1e-12 of max |value| and checked to
    leave its results on the card."""
    out = {}
    for name, fn in (("radial poisson", _radial_poisson), ("autodiff gram", _autodiff_gram),
                     ("general nu gram", _general_nu_gram)):
        t0 = time.perf_counter()
        got = fn(device)
        sync()
        secs = time.perf_counter() - t0
        ref = fn("cpu")
        on_card = all(g.device.type == "cuda" for g in got)
        err = max(((g.cpu() - r).abs().max() / r.abs().max()).item() for g, r in zip(got, ref))
        out[name] = dict(seconds=secs, rel_err=err, devices=sorted({str(g.device) for g in got}))
        check(on_card and err <= 1e-12, f"symbolic[{name}]: results on {out[name]['devices']}, vs the same call on "
              f"the CPU {err:.3e} of max |value| <= 1e-12; {secs:.2f} s")
    log("symbolic " + json.dumps(out))
    return out


def grid_spans(keep_k2=None) -> "Spans":
    """The grid path's kernel calls, each kept: K1 from the regressor (the
    Nystrom blocks) and from ``gram_matrix`` (the anchors' Grams, ``W``,
    ``var``'s ``kxX``), each as :func:`_k1_sample`; K2 from the regressor
    (the mean), whole, or as ``keep_k2(args, out)`` picks."""
    from linpde_gp_tpu_torch.models import iterative as iterative_module
    from linpde_gp_tpu_torch.ops import gram as gram_module

    return Spans({"k1_blocks": (iterative_module, "gram"), "k1_gram_matrix": (gram_module, "gram"),
                  "k2_calls": (iterative_module, "gram_matvec")},
                 keep={"k1_blocks": _k1_sample, "k1_gram_matrix": _k1_sample,
                       "k2_calls": keep_k2 or (lambda args, out: (args, out))})


def _keep_mean_k2(args, out):
    """Of K2's calls from the regressor, the mean's (queries x points) whole;
    the CG's (points x points) as ``None``."""
    return (args, out) if args[1].shape[0] != args[2].shape[0] else None


def _check_grid_kernels(spans, tag, min_k1=4, k1_what=None) -> dict:
    """The grid path's K1 and K2 launches against their plain versions on
    the run's own operands.  K1: per spec and mode the largest call (the
    Nystrom block, ``W``, ``kxX``, the anchors' Grams) launched again (CUDA
    events, beside the plain version) must give the run's output exactly on
    a strided sample, and is held to the plain f64 version on the same
    points: within 1e-12 of its largest entry in f64, 1e-7 in ff (K1 rounds
    to float32 there; a float32 body reads ~4e-7, PR 6's kernel table).
    K2 (the mean's calls): the f64 result within 1e-12 of its row's sum_j
    |k_ij v_j|; ff's rounded row by row from the f64 product and its ff pair
    within ``ROW_BOUND`` eps of that sum, the bounds of the kernels phase.
    K2 calls kept as ``None`` (the CG's) are not checked.  ``min_k1``: the
    (spec, mode) pairs the run must have launched K1 on.  The run must call
    no plain version on a CUDA tensor.  ``k1_what`` names the K1 calls in the
    log (default: the grid path's)."""
    import torch

    from linpde_gp_tpu_torch.ops.gram import gram, gram_matvec_plain, gram_plain

    check(spans.plain_on_cuda == 0, f"{tag}: no plain version called on CUDA tensors ({spans.plain_on_cuda})")
    largest = {}
    for args, shape, sample in spans.kept["k1_blocks"] + spans.kept["k1_gram_matrix"]:
        key = (args[0], args[3])
        if key not in largest or shape[0] * shape[1] > largest[key][1][0] * largest[key][1][1]:
            largest[key] = (args, shape, sample)
    k1 = []
    for args, shape, sample in largest.values():
        terms, X0, X1, mode = args
        k1_ms, K = timed(lambda: gram(terms, X0, X1, mode), reps=3)
        plain_ms, P = timed(lambda: gram_plain(terms, X0.double(), X1.double(), "f64"))
        same = torch.equal(_strided(K), sample)
        kd = P.abs().max().item()
        err = (K.double() - P).abs().max().item() / kd
        del K, P
        bound = 1e-12 if mode == "f64" else 1e-7
        what = f"{tag}: K1 {mode} {shape[0]}x{shape[1]} ({len(terms)} terms)"
        check(same, f"{what} launched again gives the run's block")
        check(err <= bound, f"{what} vs plain f64 on the same points: {err:.3e} of max |k| <= {bound:g}; "
              f"{k1_ms:.3f} ms (CUDA events, mean of 3), plain {plain_ms:.1f} ms")
        k1.append(dict(shape=list(shape), mode=mode, terms=len(terms), ms=k1_ms, plain_ms=plain_ms, rel_err=err))
    if k1_what is None:
        k1_what = f"Nystrom, W, {'kxX, ' if min_k1 > 3 else ''}the anchors"
    check(len(k1) >= min_k1, f"{tag}: K1 checked on {len(k1)} >= {min_k1} (spec, mode) pairs: {k1_what}")
    eps32 = torch.finfo(torch.float32).eps
    k2 = []
    for (spec, x, pts, v, mode), res in filter(None, spans.kept["k2_calls"]):
        scale, terms = spec
        v64 = v[0].double() + v[1].double() if isinstance(v, tuple) else v.double()
        x64, pts64 = x.double(), pts.double()
        oracle = gram_matvec_plain(spec, x64, pts64, v64, "f64")
        row_absum = torch.cat([abs(scale) * (gram_plain(terms, x64[s:s + 1024], pts64, "f64").abs() @ v64.abs())
                               for s in range(0, x.shape[0], 1024)])
        what = f"{tag}: K2 {mode} {x.shape[0]}x{pts.shape[0]} mean"
        if mode == "f64":
            e = torch.nan_to_num((res - oracle).abs() / row_absum, nan=0.0).max().item()
            check(e <= 1e-12, f"{what} vs plain f64: {e:.3e} of sum_j |k_ij v_j| <= 1e-12")
            k2.append(dict(n0=x.shape[0], n1=pts.shape[0], mode=mode, row_rel_err=e))
        else:
            e_row = row_excess(res[0], oracle, row_absum, eps32)
            e_pair = pair_excess(res, oracle, row_absum, eps32)
            check(e_row <= ROW_BOUND and e_pair <= ROW_BOUND,
                  f"{what} is the f64 product rounded, row by row: excess {e_row:.3g}, ff pair {e_pair:.3g} "
                  f"eps sum_j|k_ij v_j| <= {ROW_BOUND:g}")
            k2.append(dict(n0=x.shape[0], n1=pts.shape[0], mode=mode, row_excess=e_row, pair_excess=e_pair))
    check(len(k2) >= 1, f"{tag}: the mean's K2 calls checked ({len(k2)})")
    return {"k1": k1, "k2": k2}


def grid_problem(nt: int, nx: int, device="cuda"):
    """``experiments/grid_mode_tpu.py:79-99``'s problem through the port's
    public layer: the heat ``HeatEquationDirichletProblem`` on [0, 5] x [-1,
    1] (alpha 0.1, initial values the first sine), the heat prior on
    ``device``, H = the problem's operator, and the collocation grid
    ``TensorProductGrid(linspace(1e-3, 5, nt), linspace(-1, 1, nx + 2)[1:-1])``
    with float32 factors, as the experiment builds it on the chip."""
    import linpde_gp_tpu_torch as lgt

    sd = lgt.domains.asdomain([-1.0, 1.0])
    ibvp = lgt.problems.HeatEquationDirichletProblem(
        t0=0.0, T=5.0, spatial_domain=sd, alpha=0.1,
        initial_values=lgt.functions.TruncatedSineSeries(sd, coefficients=[1.0]),
    )
    prior, _ = heat_problem(device)
    grid = lgt.domains.TensorProductGrid(
        np.linspace(1e-3, 5.0, nt).astype(np.float32), np.linspace(-1.0, 1.0, nx + 2)[1:-1].astype(np.float32)
    )
    return ibvp, prior, ibvp.pde.diffop, grid


def _structured_matvecs(reg, reps):
    """The grid path's structured matvecs on ``reg``'s card and their
    CUDA-event milliseconds at r = 1 and 256 (mean of ``reps``): the float64
    Kronecker operator (the CG's in modes f64 and ff), the plain float32 one
    and, in mode ff, the compensated ``KronFFMatvec`` (the JAX package's ff
    route, which the regressor no longer takes); ``||err|| / ||v||`` of
    each against the float64 one."""
    import torch

    from linpde_gp_tpu_torch.ops.ff import ff_split
    from linpde_gp_tpu_torch.ops.kron_ff import KronFFMatvec, kron_linop

    factors = [g.astype(np.float64) for g in reg._grid_factors]
    shape = tuple(len(g) for g in factors)
    f64 = kron_linop(reg._obs_spec, factors, device=reg.device)
    f32 = kron_linop(reg._obs_spec, factors, dtype=torch.float32, device=reg.device)
    kron_ff = KronFFMatvec(reg._obs_spec, factors, device=reg.device) if reg.mode == "ff" else None
    gen = torch.Generator(device=reg.device).manual_seed(11)
    out = {}
    for r in (1, 256):
        v = torch.randn(reg.X.shape[0], r, generator=gen, dtype=torch.float64, device=reg.device)
        ref = f64 @ v
        v_ff, v32 = ff_split(v), v.float()
        routes = {"f64": lambda: f64 @ v, "plain": lambda: f32 @ v32}
        if kron_ff is not None:
            routes["ff"] = lambda: kron_ff(v_ff)
        for name, fn in routes.items():
            fn()  # warm-up
            ms, y = timed(fn, reps)
            y = y[0].double() + y[1].double() if isinstance(y, tuple) else y.double()
            out[f"{name}_r{r}"] = dict(ms=ms, err=((y - ref).norm() / v.norm()).item(),
                                       **kron_bound(name, shape, len(reg._obs_spec[1]), r))
    return out


def kron_bound(route, shape, T, r):
    """The least time of a structured matvec at ``r`` columns on an ``shape
    = (n_t, n_x)`` grid with ``T`` terms: its GEMMs' FMAs over the pipe's
    peak (ff: the hi x hi, hi x lo and lo x hi products in float32; f64: the
    FP64 tensor cores; plain: float32), or ``v`` read and the result written
    once over the memory rate, whichever is larger (:data:`PEAK`)."""
    nt, nx = shape
    fmas = T * nt * nx * r * (nt + nx) * (3 if route == "ff" else 1)
    pipe = "fp64_tc" if route == "f64" else "fp32"
    nbytes = 2 * nt * nx * r * {"ff": 8, "f64": 8, "plain": 4}[route]
    t_ops, t_bytes = fmas / PEAK[pipe], nbytes / PEAK["bytes"]
    return {"bound_ms": 1e3 * max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def run_grid_path(mode, *, nt=500, nx=200, nq=8192, rank=2048, device="cuda", n_ic=96, n_bc=48, tol=1e-5,
                  maxiter=512, noise_rel=1e-3, anchor_noise=1e-5, var_queries=VAR_QUERIES, timing_reps=5):
    """Grid mode: ``experiments/grid_mode_tpu.py``'s anchored heat problem on
    an (nt x nx) ``TensorProductGrid`` through ``IterativeGPRegressor(prior,
    grid, 0, L=H, anchor_X=..., anchor_Y=...)``: the CG's matvec is the
    float64 Kronecker operator (in mode ff split into the CG's ff pair); the
    Nystrom blocks, the anchors, the mean and ``var``'s
    ``kxX`` are K1 and K2 at the flattened points.  The launch counts are
    read just after the path's work (build, solve, mean, ``var`` at
    ``var_queries`` queries in one block), before its checks: finite
    weights, the solver's relres, the joint true relres of the 2 x 2 system
    (float64, ``A22 w`` by K2), the RMSE against u* at ``nq`` queries, the
    problem's solution against :func:`u_star`, ``0 < var <= prior var``, the
    structured matvec against K2 on the flattened points (float64, per row,
    within 1e-12 of sum_j |k_ij v_j| from K1 blocks), and in mode ff the
    compensated matvec against the float64 Kronecker operator at r = 1 and
    256 (5e-5 ||v||).  On the card it also holds the run's K1 and K2 calls
    to their plain versions (:func:`_check_grid_kernels`) and times the
    structured matvecs.
    Returns the measurements; the variance under ``"var"`` (host float64)."""
    import torch

    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.ops.gram import gram, gram_matvec, gram_plain, kernel_term_specs
    from linpde_gp_tpu_torch.specs import spec_diagonal

    tag = f"grid[{mode}]"
    ibvp, prior, H, grid = grid_problem(nt, nx, device)
    Xa, _ = ibvp_anchors(n_ic, n_bc)
    Ya = ibvp.solution(torch.from_numpy(Xa.astype(np.float64))).numpy().astype(np.float32)
    rng = np.random.default_rng(7)
    Xq = np.stack([rng.uniform(0.0, 5.0, nq), rng.uniform(-1.0, 1.0, nq)], axis=-1).astype(np.float32)
    n = nt * nx
    noise = noise_rel * spec_diagonal(heat_specs()["obs"])
    on_card = torch.device(device).type == "cuda"
    xv = Xq[:var_queries]
    with grid_spans() as spans:
        _cuda.reset_launches()
        reg, w, mu, times = _solve_and_mean(lambda: IterativeGPRegressor(
            prior, grid, np.zeros(n, np.float32), L=H, noise_variance=noise, tol=tol, maxiter=maxiter,
            precond_rank=min(rank, n // 4), mode=mode, device=device, anchor_X=Xa, anchor_Y=Ya,
            anchor_noise=anchor_noise,
        ), Xq)
        t0 = time.perf_counter()
        var = reg.var(torch.from_numpy(xv), block_size=var_queries).double().cpu()
        sync()
        var_s = time.perf_counter() - t0
        launches = dict(_cuda.launches)
    out = dict(mode=mode, grid=[nt, nx], n=n, nq=nq, n_anchor=int(Xa.shape[0]), rank=min(rank, n // 4),
               noise=noise, anchor_noise=anchor_noise, **times, var_s=var_s, launches=launches)
    if on_card:
        out["kernel_check"] = _check_grid_kernels(spans, tag)
    (out["var_iterations"], out["var_relres"]), = reg.var_info
    iters, relres = reg.solve_info
    out.update(iterations=iters, relres=relres, solve_ms_per_iteration=1e3 * times["solve_s"] / max(iters, 1),
               var_ms_per_iteration=1e3 * out["var_s"] / max(out["var_iterations"], 1))
    check(reg._gram_linop is not None and reg._gram_linop.dtype == torch.float64 and reg._banded is None,
          f"{tag}: CG routed through the float64 Kronecker operator{' (its ff split)' if mode == 'ff' else ''}")
    aw = reg.anchor_weights
    check(bool(torch.isfinite(w).all()) and bool(torch.isfinite(aw).all()), f"{tag}: weights finite")
    check(relres <= 100 * tol, f"{tag}: solver relres {relres:.3e} <= {100 * tol:g}")

    # The joint residual of the 2 x 2 system in float64, A22 w by K2 at the
    # flattened grid points (an independent route to the same operator).
    t0 = time.perf_counter()
    a = reg._anchors
    X64, X1 = reg.X.double(), a["X1"].double()
    w64, aw64, y1 = w.double(), aw.double(), a["Y1"].double()
    sk, tk = kernel_term_specs(prior.cov)
    sw, tw = kernel_term_specs(a["k_Lk"])
    A11 = sk * gram_plain(tk, X1, X1, "f64") + anchor_noise * torch.eye(X1.shape[0], dtype=torch.float64,
                                                                          device=X1.device)
    W = sw * gram(tw, X64, X1, "f64")
    r1 = A11 @ aw64 + W.T @ w64 - y1
    r2 = W @ aw64 + gram_matvec(reg._obs_spec, X64, X64, w64, "f64") + noise * w64 - reg.Y.double()
    joint = (torch.sqrt(r1.square().sum() + r2.square().sum()) /
             torch.sqrt(y1.square().sum() + reg.Y.double().square().sum())).item()
    check(joint <= 1e-3, f"{tag}: joint true relres of the 2x2 system (f64, A22 by K2) {joint:.3e} <= 1e-3")
    sol = ibvp.solution(torch.from_numpy(Xq.astype(np.float64))).numpy()
    sol_err = float(np.abs(sol - u_star(Xq)).max())
    check(sol_err <= 1e-12, f"{tag}: the problem's solution vs u* at {nq} queries: {sol_err:.3e} <= 1e-12")
    err = mu.double().cpu().numpy() - u_star(Xq)
    rmse, max_err = float(np.sqrt(np.mean(err**2))), float(np.max(np.abs(err)))
    check(bool(np.isfinite(err).all()) and rmse <= 4e-4,
          f"{tag}: RMSE vs u* at {nq} queries {rmse:.3e} <= 4e-4 (the JAX package's TPU run: 2.10e-4); "
          f"max error {max_err:.3e}")
    prior_var = prior.cov(torch.from_numpy(xv.astype(np.float64)).to(reg.device)).cpu()
    check(bool(torch.isfinite(var).all()) and bool((var > 0).all()) and bool((var <= prior_var).all()),
          f"{tag}: var at {var_queries} queries finite, 0 < var <= prior var; range "
          f"[{var.min().item():.4e}, {var.max().item():.4e}], {out['var_iterations']} iterations")

    # The structured matvec against K2 on the flattened points, per row, in
    # units of sum_j |k_ij v_j| (K1 blocks of the observation kernel, f64).
    gen = torch.Generator(device=reg.device).manual_seed(5)
    v = torch.randn(n, generator=gen, dtype=torch.float64, device=reg.device)
    y_struct = reg._gram_linop @ v  # float64 in modes ff and f64
    y_k2 = gram_matvec(reg._obs_spec, X64, X64, v, "f64")
    scale, terms = reg._obs_spec
    absum = torch.cat([(scale * gram(terms, X64[s:s + 4096], X64, "f64")).abs() @ v.abs()
                       for s in range(0, n, 4096)])
    row = ((y_struct - y_k2).abs() / absum).max().item()
    check(row <= 1e-12, f"{tag}: Kronecker operator vs K2 at the flattened grid (f64): {row:.3e} of "
          f"sum_j |k_ij v_j| per row <= 1e-12")
    out.update(joint_true_relres=joint, rmse=rmse, max_err=max_err, solution_vs_u_star=sol_err,
               kron_vs_k2_row=row, var_min=var.min().item(), var_max=var.max().item(),
               check_s=time.perf_counter() - t0)
    # var is 3e-5 of the prior variance at most here: CG tol 1e-5 does not
    # bound its error (see REF_TOLS), so each mode also solves to tight tols.
    ref = tight = control = None
    if mode == "f64":
        out["variance_ref"], ref = _reference_variance(reg, xv, var_queries, tag)
    else:
        out["variance_tight"], tight = _tight_variance(reg, xv, var_queries, tag)
        out["variance_control"], control = _uncompensated_variance(reg, xv, var_queries)
    if on_card:
        out["matvec"] = _structured_matvecs(reg, timing_reps)
        if mode == "ff":
            for r in (1, 256):
                e = out["matvec"][f"ff_r{r}"]["err"]
                check(e <= 5e-5, f"{tag}: KronFFMatvec vs the f64 Kronecker operator at r = {r}: "
                      f"{e:.3e} ||v|| <= 5e-5 (plain f32 Kronecker: {out['matvec'][f'plain_r{r}']['err']:.3e}, "
                      "recorded)")
    log(f"grid[{mode}] " + json.dumps(out))
    out["var"], out["var_ref"], out["var_tight"], out["var_control"] = var, ref, tight, control
    return out


def _uncompensated_variance(reg, xq, block_size):
    """The control of the grid's ff variance gate: ``reg.var`` at ``xq`` in
    one block at CG tol :data:`FF_VAR_TOL` with the CG's operator swapped for
    the float32 Kronecker operator (mode plain's, the JAX package's
    ``compensated=False``: no ff tables, no chunks), applied to the CG's
    vector rounded to float32.  Returns the measurements and the variance
    (float64, host)."""
    import torch

    from linpde_gp_tpu_torch.ops.kron_ff import kron_linop

    class Float32Operator:
        def __init__(self, op):
            self.op = op

        def __matmul__(self, v):
            return (self.op @ v.float()).double()

    f32 = kron_linop(reg._obs_spec, reg._grid_factors, dtype=torch.float32, device=reg.device)
    saved, reg._gram_linop = reg._gram_linop, Float32Operator(f32)
    try:
        t0 = time.perf_counter()
        v = reg.var(torch.from_numpy(xq), block_size=block_size, tol=FF_VAR_TOL).double().cpu()
        sync()
        secs = time.perf_counter() - t0
    finally:
        reg._gram_linop = saved
    (it, rr), = reg.var_info
    return dict(seconds=secs, iterations=it, relres=rr), v


def phase_grid(timing=None, **kw) -> dict:
    """The grid path (:func:`run_grid_path`, ``kw`` passed on) in modes ff and
    f64, each with the launch counts set to 0 before it and read just after
    its work: K1 and K2 must launch, the multi-column and banded routes must
    not (the CG's matvecs are structured).  Then ff's variance at tol
    ``FF_VAR_TOL`` against f64's reference: within :data:`VAR_REL_BOUND`
    of max var, which its control must miss.  Returns the launches summed
    over the runs."""
    total = {name: 0 for name in KERNELS}
    res = {}
    for mode in ("ff", "f64"):
        try:
            res[mode] = run_grid_path(mode, **kw)
        except Exception as exc:  # noqa: BLE001 - report, go on with the next run, fail at the end
            traceback.print_exc()
            failures.append(f"grid[{mode}]: {type(exc).__name__}: {exc}")
            continue
        per = res[mode]["launches"]
        for name in total:
            total[name] += per[name]
        log(f"grid[{mode}] launches {per}")
        check(per["gram"] > 0 and per["gram_matvec"] > 0 and per["gram_matvec_wide"] == 0
              and per["banded_matvec"] == per["banded_matvec_wide"] == 0,
              f"grid[{mode}] launched K1 and K2 at r = 1 and no multi-column or banded route: {per}")
    check(set(res) == {"ff", "f64"}, "grid: both modes ran")
    for mode, row in res.items():
        for r, key in ((1, "gram_matvec_xx"), (256, "gram_matvec_xx_r256")):
            k2 = ((timing or {}).get(mode) or {}).get(key) or {}
            mv = row.get("matvec", {}).get(f"{'ff' if mode == 'ff' else 'f64'}_r{r}", {})
            log(f"  grid[{mode}] structured matvec at r = {r}: {mv.get('ms')} ms; K2 at 1e5^2: {k2.get('ms')} ms")
    if set(res) == {"ff", "f64"}:
        # var is at most 3e-5 of the prior variance here, so the tol-1e-5
        # variances are held to nothing (f64's own is ~1e-3 of max var off
        # its tight reference): they are logged, and ff is held to the
        # reference at FF_VAR_TOL, as the Wendland and IBVP cells are.
        ref = res["f64"]["var_ref"]
        ff, f64 = res["ff"]["var"], res["f64"]["var"]
        log(f"  grid var at tol 1e-5: ff vs f64 {((ff - f64).abs().max() / f64.max()).item():.3e} of max var "
            "(not gated)")
        for mode in ("ff", "f64"):
            v = res[mode]["var"]
            log(f"  grid[{mode}] var at tol 1e-5 vs the f64 tol-{REF_TOLS[1]:g} reference: "
                f"{((v - ref).abs().max() / ref.max()).item():.3e} of max var, "
                f"{((v - ref).abs() / ref).max().item():.3e} of var per query (not gated)")
        tight, control = res["ff"]["var_tight"], res["ff"]["var_control"]
        per = ((tight - ref).abs() / ref).max().item()
        check(per <= REF_AGREE, f"grid var: ff at tol {FF_VAR_TOL:g} vs the f64 tol-{REF_TOLS[1]:g} reference: "
              f"{per:.3e} of var, per query <= {REF_AGREE:g}")
        e_ff = ((tight - ref).abs().max() / ref.max()).item()
        e_ctrl = ((control - ref).abs().max() / ref.max()).item()
        check(e_ff <= VAR_REL_BOUND,
              f"grid var: ff at tol {FF_VAR_TOL:g} vs the f64 reference: {e_ff:.3e} of max var <= "
              f"{VAR_REL_BOUND:g}")
        check(e_ctrl > VAR_REL_BOUND,
              f"grid var: the control (the ff CG on the float32 Kronecker operator) fails that bound: "
              f"{e_ctrl:.3e} of max var, {((control - ref).abs() / ref).max().item():.3e} of var per query")
    return total


# -- FEM and integral functionals ------------------------------------------------

#: The FEM phase: the elements of its checked run and of its logged sweep.
FEM_ELEMENTS = 63
FEM_SWEEP = (127, 255, 1023)
#: Rows of the double-projection Gram held to the per-cell oracle, about the
#: middle of the basis.
FEM_ORACLE_ROWS = 4
#: The integral phase: the dense IBVP cell's space-time box, the noise of the
#: integral observation, and the small copy held to the CPU path (PDE points,
#: IC anchors, BC anchors per side, Gauss-Legendre order and panels).
INTEGRAL_BOX = [[0.0, 5.0], [-1.0, 1.0]]
INTEGRAL_NOISE = 1e-10
INTEGRAL_SMALL = dict(n=512, n_ic=12, n_bc=6, order=16, panels=2)


@contextlib.contextmanager
def default_device(device):
    """``config.device`` is ``device`` inside the block: the functionals'
    nodes and weights, their normalizers and the stiffness matrices land
    there."""
    from linpde_gp_tpu_torch.config import config

    saved = config.device
    config.device = str(device)
    try:
        yield
    finally:
        config.device = saved


@contextlib.contextmanager
def quadrature(order, panels):
    from linpde_gp_tpu_torch.config import config

    saved = config.quadrature_order, config.quadrature_panels
    config.set(quadrature_order=order, quadrature_panels=panels)
    try:
        yield
    finally:
        config.set(quadrature_order=saved[0], quadrature_panels=saved[1])


def fem_setup(n_el, device="cuda"):
    """``experiments/poisson_fem.py:15-65``'s GP-FEM Poisson problem with
    ``n_el`` elements on ``device``: ``-u'' = 2`` on [-1, 1], u(-1) = 0,
    u(1) = 1; a free-boundary trial and a zero-boundary test hat basis on
    ``linspace(-1, 1, n_el + 2)``; the Galerkin functional ``L =
    weak_form(test)(trial) @ trial.l2_projection()`` and the test basis's
    load vector ``rhs`` of the right-hand side; the prior Matérn(nu = 1.5,
    l = 1)."""
    import linpde_gp_tpu_torch as lgt

    with default_device(device):
        bvp = lgt.problems.PoissonEquationDirichletProblem(
            domain=lgt.domains.asdomain([-1.0, 1.0]), rhs=lgt.functions.Constant((), 2.0), boundary_values=(0.0, 1.0)
        )
        grid = np.linspace(-1.0, 1.0, n_el + 2)
        trial = lgt.functions.UnivariateLinearInterpolationBasis(grid, zero_boundary=False)
        test = lgt.functions.UnivariateLinearInterpolationBasis(grid, zero_boundary=True)
        trial_proj = trial.l2_projection()
        A = bvp.pde.diffop.weak_form(test)(trial)
        rhs = test.l2_projection(normalized=False)(bvp.pde.rhs)
        prior = lgt.GaussianProcess(lgt.functions.Zero(()), 1.0 * lgt.kernels.Matern((), nu=1.5, lengthscales=1.0),
                                    device=device)
    X_bc, Y_bc = lgt.problems.get_1d_dirichlet_boundary_observations(bvp.boundary_conditions)
    return dict(bvp=bvp, trial=trial, trial_proj=trial_proj, A=A, rhs=rhs, L=A @ trial_proj, prior=prior,
                X_bc=np.asarray(X_bc, np.float64), Y_bc=np.asarray(Y_bc, np.float64), device=device)


def fem_condition(p, noise=None):
    """The prior of :func:`fem_setup`'s problem ``p`` conditioned on the
    boundary values, then on ``L u = rhs`` (``noise``: the variance of every
    observation; ``None``: noiseless, as the experiment)."""
    import linpde_gp_tpu_torch as lgt

    def b(m):
        return None if noise is None else lgt.Normal(np.zeros(m), noise * np.ones(m))

    with default_device(p["device"]):
        post = p["prior"].condition_on_observations(p["Y_bc"], X=p["X_bc"], b=b(2))
        return post.condition_on_observations(p["rhs"], L=p["L"], b=b(p["rhs"].shape[0]))


def classical_fem(A, rhs, Y_bc):
    """The classical FEM nodal values (``poisson_fem.py:55-63``): the
    interior stiffness system solved with the boundary values moved right."""
    A = A.todense().double().cpu().numpy()
    rhs = rhs.double().cpu().numpy()
    w_int = np.linalg.solve(A[:, 1:-1], rhs - A[:, 0] * Y_bc[0] - A[:, -1] * Y_bc[1])
    return np.concatenate([[Y_bc[0]], w_int, [Y_bc[1]]])


def hat_gram_oracle(basis, rows, kernel, device, order=20):
    """The plain version of the hat x hat double-projection Gram, rows
    ``rows`` and every column: ``G_ij = \\int\\int w_i(s) w_j(t) k(s, t)``
    by ``order``-point Gauss-Legendre on every cell of the grid, the inner
    cell that holds ``s`` split at ``s`` (the kink of k there), with
    ``kernel``'s own evaluation, float64 on ``device``."""
    import torch

    cells = basis.grid if basis.zero_boundary else basis.grid[1:-1]
    lo, hi = cells[:-1], cells[1:]
    gx, gw = np.polynomial.legendre.leggauss(order)

    def gl(a, b):  # nodes and weights on [a, b], elementwise: (..., order)
        a, b = np.asarray(a)[..., None], np.asarray(b)[..., None]
        return 0.5 * (b - a) * gx + 0.5 * (a + b), 0.5 * (b - a) * gw

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    T0, W0 = gl(lo, hi)
    cell_of = np.repeat(np.arange(lo.size), order)
    T0t, W0t = t(T0.reshape(-1)), t(W0.reshape(-1))
    phi0 = basis(T0t)  # (cells * order, m)
    out = []
    for i in rows:
        a_i, b_i = basis.support_bounds(i)
        own_cells = np.flatnonzero((lo >= a_i) & (hi <= b_i))
        S, WS = gl(lo[own_cells], hi[own_cells])
        own = np.repeat(own_cells, order)
        S, WS = S.reshape(-1), WS.reshape(-1)
        St = t(S)
        K0 = kernel(St[:, None], T0t[None, :]) * W0t
        K0 = K0.masked_fill(t(cell_of[None, :] == own[:, None]).bool(), 0.0)
        TL, WL = gl(lo[own], S)
        TR, WR = gl(S, hi[own])
        T1, W1 = t(np.concatenate([TL, TR], 1)), t(np.concatenate([WL, WR], 1))
        inner = K0 @ phi0 + torch.einsum("sq,sqm->sm", kernel(St[:, None], T1) * W1, basis(T1))
        out.append((t(WS) * basis.eval_elem(i, St)) @ inner)
    return torch.stack(out)


def _double_projection_error(trial, device):
    """The exact double-projection Gram of ``trial`` (nu = 1.5, l = 1) on its
    middle rows against :func:`hat_gram_oracle`: the largest relative error
    per entry, and whether both are finite."""
    import torch

    import linpde_gp_tpu_torch as lgt
    from linpde_gp_tpu_torch.ops.transforms.integrals_exact import matern_hat_double_projection_gram

    m = len(trial)
    rows = list(range(m // 2 - FEM_ORACLE_ROWS // 2, m // 2 - FEM_ORACLE_ROWS // 2 + FEM_ORACLE_ROWS))
    with default_device(device):
        G = matern_hat_double_projection_gram(1.5, 1.0, trial, trial)
    oracle = hat_gram_oracle(trial, rows, lgt.kernels.Matern((), nu=1.5, lengthscales=1.0), device)
    finite = bool(torch.isfinite(G).all()) and bool(torch.isfinite(oracle).all())
    return ((G[rows] - oracle).abs() / oracle.abs()).max().item(), finite, str(G.device)


def phase_fem(nq=8192, device="cuda") -> dict:
    """GP-FEM on the card (:func:`fem_setup`, :func:`fem_condition`): the reference-parity
    fixture at 5 elements with its noise (mean and std within 1e-6), the
    checked run at :data:`FEM_ELEMENTS` (launches counted; mean and std of
    the posterior and of the parametric GP on its trial projection at ``nq``
    queries; RMSE vs u*, the projection vs the classical FEM, the card vs
    the CPU path, the exact double-projection Gram vs its per-cell oracle),
    then the logged sweep over :data:`FEM_SWEEP` (the Gram's error, the
    Galerkin Gram's eigenvalue range, whether conditioning raised
    ``LinAlgError``; a NaN fails).  Returns the checked run's launches."""
    with default_device(device):
        return _phase_fem(nq, device)


def _phase_fem(nq, device):
    import os

    import torch

    import linpde_gp_tpu_torch as lgt
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.ops.crosscov.base import apply_functional_to_crosscov
    from linpde_gp_tpu_torch.ops.transforms.functionals import apply_functional

    out = {}
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "reference_parity.json")
    with open(path) as fh:
        fixtures = json.load(fh)
    fx = fixtures["poisson_fem"]
    xq5 = np.asarray(fx["xq"])
    post5 = fem_condition(fem_setup(5, device), noise=fixtures["noise"])
    mean5, std5 = post5.mean(xq5).cpu().numpy(), post5.std(xq5).cpu().numpy()
    ref_mean, ref_std = np.asarray(fx["mean"]), np.asarray(fx["std"])
    scale = max(np.abs(ref_mean).max(), 1.0)
    e_mean5 = float(np.abs(mean5 - ref_mean).max() / scale)
    e_std5 = float(np.max((np.abs(std5 - ref_std) - 1e-6 * np.abs(ref_std)) / scale))
    out["fixture"] = dict(mean_err=e_mean5, std_excess=e_std5)
    check(e_mean5 <= 1e-6 and e_std5 <= 1e-6, f"fem[5]: the poisson_fem fixture: mean {e_mean5:.3e} of max(|mean|, "
          f"1) <= 1e-6, std within 1e-6 (excess {e_std5:.3e})")

    tag = f"fem[{FEM_ELEMENTS}]"
    xq = np.linspace(-1.0, 1.0, nq)
    spans = dense_spans()
    _cuda.reset_launches()
    with spans:
        t0 = time.perf_counter()
        p = fem_setup(FEM_ELEMENTS, device)
        post = fem_condition(p)
        sync()
        out["condition_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mean, std = post.mean(xq), post.std(xq)
        Pu = p["trial_proj"](post)
        pgp = lgt.ParametricGaussianProcess(weights=Pu, feature_fn=p["trial"])
        pmean, pstd = pgp.mean(xq), pgp.std(xq)
        sync()
        out["evaluate_s"] = time.perf_counter() - t0
    out["launches"] = dict(_cuda.launches)
    out["routes"] = [c.matvec_route for c in post.kLas]
    results = (mean, std, Pu.mean, Pu.cov.matrix, pmean, pstd)
    check(all(r.device.type == torch.device(device).type for r in results)
          and all(bool(torch.isfinite(r).all()) for r in results) and mean.shape == (nq,) and pstd.shape == (nq,),
          f"{tag}: mean and std of the posterior and of the parametric GP at {nq} queries finite, on {device}")
    check(out["routes"] == ["K2", "evaluate @ w"], f"{tag}: mean routes (BC, Galerkin) {out['routes']}")
    if torch.device(device).type == "cuda":
        el = out["launches"]
        check(el["gram"] > 0 and el["gram_matvec"] > 0 and spans.plain_on_cuda == 0,
              f"{tag}: launched K1 and K2, no plain version on a CUDA tensor: {el}, {spans.plain_on_cuda} plain calls")
    sol = p["bvp"].solution(torch.from_numpy(xq)).numpy()
    mean_np = mean.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mean_np - sol) ** 2)))
    w = classical_fem(p["A"], p["rhs"], p["Y_bc"])
    node_diff = float(np.abs(Pu.mean.cpu().numpy() - w).max())
    out.update(rmse=rmse, pgp_rmse=float(np.sqrt(np.mean((pmean.cpu().numpy() - sol) ** 2))), fem_node_diff=node_diff,
               max_std=std.max().item())
    check(rmse <= 1e-3, f"{tag}: RMSE vs the exact solution at {nq} queries {rmse:.3e} <= 1e-3")
    check(node_diff <= 1e-3, f"{tag}: the projected mean vs the classical FEM solution {node_diff:.3e} <= 1e-3")
    with default_device("cpu"):
        post_c = fem_condition(fem_setup(FEM_ELEMENTS, "cpu"))
        mean_c, std_c = post_c.mean(xq), post_c.std(xq)
    e_cpu = float(np.abs(mean_np - mean_c.numpy()).max() / np.abs(mean_c.numpy()).max())
    out.update(mean_vs_cpu=e_cpu, std_vs_cpu=float(np.abs(std.cpu().numpy() - std_c.numpy()).max()
                                                    / std_c.numpy().max()))
    check(e_cpu <= 1e-9, f"{tag}: the card's mean vs the port's CPU path {e_cpu:.3e} of max |mean| <= 1e-9 "
          f"(std: {out['std_vs_cpu']:.3e} of max std, logged)")
    err, finite, where = _double_projection_error(p["trial"], device)
    out["double_projection_rel_err"] = err
    check(finite and err <= 1e-8 and where.startswith(torch.device(device).type),
          f"{tag}: the exact double-projection Gram ({where}) vs its per-cell Gauss-Legendre oracle on "
          f"{FEM_ORACLE_ROWS} middle rows: {err:.3e} per entry <= 1e-8")

    sweep = {}
    for n_el in FEM_SWEEP:
        row = {}
        p = fem_setup(n_el, device)
        try:
            m = fem_condition(p).mean(xq)
            row.update(raised=None, rmse=float(np.sqrt(np.mean((m.cpu().numpy() - sol) ** 2))),
                       mean_finite=bool(torch.isfinite(m).all()))
        except torch.linalg.LinAlgError as exc:
            row.update(raised=f"LinAlgError: {exc}")
        trial, L, k = p["trial"], p["L"], p["prior"].cov
        with default_device(device):
            gal = apply_functional_to_crosscov(L, apply_functional(L, k, argnum=1)).matrix
        eig = torch.linalg.eigvalsh(0.5 * (gal + gal.T))
        row.update(eig_min=eig[0].item(), eig_max=eig[-1].item())
        row["double_projection_rel_err"], g_finite, _ = _double_projection_error(trial, device)
        sweep[n_el] = row
        nan = not g_finite or not bool(torch.isfinite(eig).all()) or row.get("mean_finite") is False
        log(f"  fem sweep[{n_el}]: " + json.dumps(row))
        check(not nan, f"fem sweep[{n_el}]: no NaN (conditioning {'raised' if row['raised'] else 'ran'}; Galerkin "
              f"Gram eigenvalues [{row['eig_min']:.3e}, {row['eig_max']:.3e}], double-projection Gram "
              f"{row['double_projection_rel_err']:.3e} off its oracle)")
    out["sweep"] = sweep
    log("fem " + json.dumps(out))
    return out["launches"]


def integral_star() -> float:
    """``\\int\\int u*`` over the box: ``(4 / pi) (1 - e^{-5c}) / c``, c = 0.1 pi^2 / 4."""
    c = 0.1 * np.pi**2 / 4.0
    return float(4.0 / np.pi * (1.0 - np.exp(-5.0 * c)) / c)


def integral_path(prior, H, X, Xa, Ya, cuts, noise, anchor_noise, Xq, device):
    """The integral route on a dense IBVP posterior: ``I(prior)``, ``I(post)``,
    the posterior conditioned on ``y = \\int\\int u*`` through ``I`` (noise
    :data:`INTEGRAL_NOISE`), its ``I`` and its mean at ``Xq``."""
    import linpde_gp_tpu_torch as lgt

    with default_device(device):
        I = lgt.functionals.LebesgueIntegral(lgt.domains.Box(INTEGRAL_BOX))
        post = condition_dense_ibvp(prior, H, X, Xa, Ya, cuts, noise, anchor_noise)
        prior_rv, rv = I(prior), I(post)
        post2 = post.condition_on_observations(np.asarray(integral_star()), L=I,
                                               b=lgt.Normal(np.asarray(0.0), np.asarray(INTEGRAL_NOISE)))
        rv2 = I(post2)
        mean2 = post2.mean(Xq)
    return dict(prior_var=float(prior_rv.var), m=float(rv.mean), v=float(rv.var), m2=float(rv2.mean),
                v2=float(rv2.var), mean2=mean2)


def phase_integral(n=DENSE_N, nq=8192, device="cuda") -> dict:
    """``LebesgueIntegral`` over the space-time box on the dense IBVP posterior
    (:func:`run_dense_path`'s problem: N PDE points and 96 + 2 x 48 anchors)
    at the default 64 x 4 Gauss-Legendre panels per axis (65,536 nodes):
    ``I(prior)``, ``I(post)``, conditioning on the integral, the new
    posterior's mean at ``nq`` queries; the launch counts set to 0 just
    before ``I(prior)`` and read after that mean.  Checked: ``I(post)``
    against the closed form and against the same quadrature of the
    posterior mean (K2 at the nodes), 0 <= var <= prior var, the scalar
    Gaussian update, the integral term of the new mean by K2, RMSE vs u*,
    the phase's K1 and K2 calls against their plain versions, the peak
    device memory; then a small copy against the CPU path and the 1-D exact
    hooks against the CPU.  Returns the counted launches."""
    import torch

    import linpde_gp_tpu_torch as lgt
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.ops.transforms.integrals_exact import exact_integral_hooks
    from linpde_gp_tpu_torch.specs import spec_diagonal

    tag = "integral"
    on_card = torch.device(device).type == "cuda"
    prior, H = heat_problem(device)
    X, Xq = ibvp_data(n, nq)
    n_ic, n_bc = 96, 48
    Xa, Ya = ibvp_anchors(n_ic, n_bc)
    cuts = (0, n_ic, n_ic + n_bc, n_ic + 2 * n_bc)
    noise, anchor_noise = 1e-3 * spec_diagonal(heat_specs()["obs"]), 1e-5
    y = integral_star()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    out = dict(n=n, nq=nq, y=y, noise=INTEGRAL_NOISE)
    with default_device(device):
        I = lgt.functionals.LebesgueIntegral(lgt.domains.Box(INTEGRAL_BOX))
        t0 = time.perf_counter()
        post = condition_dense_ibvp(prior, H, X, Xa, Ya, cuts, noise, anchor_noise)
        sync()
        out["dense_condition_s"] = time.perf_counter() - t0
        out["nodes"] = I.discretization().num_points
        spans = dense_spans()
        _cuda.reset_launches()
        with spans:
            t0 = time.perf_counter()
            prior_rv = I(prior)
            sync()
            out["prior_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rv = I(post)
            sync()
            out["post_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            post2 = post.condition_on_observations(np.asarray(y), L=I,
                                                   b=lgt.Normal(np.asarray(0.0), np.asarray(INTEGRAL_NOISE)))
            sync()
            out["condition_s"] = time.perf_counter() - t0
            k2_before = len(spans.kept["k2_calls"])
            before = dict(_cuda.launches)
            t0 = time.perf_counter()
            mean2 = post2.mean(Xq)
            sync()
            out["mean_s"] = time.perf_counter() - t0
            out["mean_launches"] = {k: _cuda.launches[k] - before[k] for k in before}
            mean_k2 = spans.kept["k2_calls"][k2_before:]
        out["launches"] = dict(_cuda.launches)
        out["stages_s"], out["stage_calls"] = dict(spans.seconds), dict(spans.calls)
        out["plain_calls_on_cuda"] = spans.plain_on_cuda
        if on_card:
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        m, v, pv = float(rv.mean), float(rv.var), float(prior_rv.var)
        rv2 = I(post2)
        m2, v2 = float(rv2.mean), float(rv2.var)
        disc = I.discretization()
        quad_mean = (disc.weights @ post.mean(disc.points).reshape(-1)).item()
    out.update(prior_var=pv, m=m, v=v, m2=m2, v2=v2, quad_mean=quad_mean, routes=[c.matvec_route for c in post2.kLas])
    e_star = abs(m - y) / y
    e_quad = abs(m - quad_mean) / abs(quad_mean)
    out.update(rel_err_vs_closed_form=e_star, rel_err_vs_quadrature=e_quad)
    log(f"  {tag}: {out['nodes']} nodes; I(prior) {out['prior_s']:.3f} s, I(post) {out['post_s']:.3f} s, "
        f"conditioning {out['condition_s']:.3f} s, mean {out['mean_s']:.4f} s; stages {out['stages_s']} in "
        f"{out['stage_calls']} calls; launches {out['launches']}, the "
        f"mean's {out['mean_launches']}; peak {out.get('peak_gb', float('nan')):.2f} GB")
    check(out["nodes"] == 65536, f"{tag}: {out['nodes']} quadrature nodes (64 x 4 panels per axis)")
    check(e_star <= 1e-4, f"{tag}: I(post).mean {m:.9f} vs the closed form {y:.9f}: {e_star:.3e} relative <= 1e-4")
    check(e_quad <= 1e-10, f"{tag}: I(post).mean vs w . post.mean(nodes) (K2): {e_quad:.3e} relative <= 1e-10")
    check(0.0 <= v <= pv, f"{tag}: 0 <= I(post).var {v:.6e} <= I(prior).var {pv:.6e}")
    m2_ref = m + v / (v + INTEGRAL_NOISE) * (y - m)
    v2_ref = v * INTEGRAL_NOISE / (v + INTEGRAL_NOISE)
    out.update(m2_err=abs(m2 - m2_ref) / abs(y), v2_err=abs(v2 - v2_ref) / pv)
    check(out["m2_err"] <= 1e-8, f"{tag}: m2 = m + v/(v+s2)(y-m): {m2:.12f} vs {m2_ref:.12f}, {out['m2_err']:.3e} of "
          "|y| <= 1e-8")
    check(out["v2_err"] <= 1e-11, f"{tag}: v2 = v s2/(v+s2): {v2:.6e} vs {v2_ref:.6e}, {out['v2_err']:.3e} of "
          "I(prior).var <= 1e-11")
    integral_k2 = [c for c in mean_k2 if c[0][2].shape[0] == out["nodes"]]
    check(out["routes"][-1] == "K2" and len(integral_k2) == 1
          and (not on_card or out["mean_launches"]["gram_matvec"] == len(out["routes"])),
          f"{tag}: the new mean's integral term took K2 ({len(integral_k2)} call at {nq} x {out['nodes']}; "
          f"routes {out['routes']}; the mean's launches {out['mean_launches']})")
    finite = bool(torch.isfinite(mean2).all()) and all(np.isfinite([m, v, pv, m2, v2]))
    rmse = float(np.sqrt(np.mean((mean2.double().cpu().numpy() - u_star(Xq)) ** 2)))
    out["rmse"] = rmse
    check(finite and rmse <= 4e-4, f"{tag}: the new posterior's mean finite, RMSE vs u* at {nq} queries {rmse:.3e} "
          "<= 4e-4")
    if on_card:
        el = out["launches"]
        check(el["gram"] > 0 and el["gram_matvec"] > 0 and spans.plain_on_cuda == 0,
              f"{tag}: launched K1 and K2, no plain version on a CUDA tensor: {el}, {spans.plain_on_cuda} plain calls")
        check(out["peak_gb"] < 40, f"{tag}: peak device memory {out['peak_gb']:.2f} GB < 40")
    del post, post2, prior_rv, rv, rv2, mean2
    spans.kept["k2_calls"] = mean_k2
    if on_card:
        torch.cuda.empty_cache()
    out.update(_check_dense_kernels(spans, tag, on_card))
    del spans
    if on_card:
        torch.cuda.empty_cache()

    # A small copy on the card against the port's CPU path.
    sm = INTEGRAL_SMALL
    Xs, _ = ibvp_data(sm["n"], 0)
    Xas, Yas = ibvp_anchors(sm["n_ic"], sm["n_bc"])
    cuts_s = (0, sm["n_ic"], sm["n_ic"] + sm["n_bc"], sm["n_ic"] + 2 * sm["n_bc"])
    xq_s = Xq[:256]
    with quadrature(sm["order"], sm["panels"]):
        runs = {}
        for dev in (device, "cpu"):
            prior_d, H_d = heat_problem(dev)
            runs[dev] = integral_path(prior_d, H_d, Xs, Xas, Yas, cuts_s, noise, anchor_noise, xq_s, dev)
    a, b = runs[device], runs["cpu"]
    # Means relative to themselves; the posterior variances, differences of
    # terms the size of the prior variance, relative to it.
    small = {key: abs(a[key] - b[key]) / abs(b[key]) for key in ("prior_var", "m", "m2")}
    small.update({key: abs(a[key] - b[key]) / b["prior_var"] for key in ("v", "v2")})
    small["mean2"] = ((a["mean2"].cpu() - b["mean2"]).abs().max() / b["mean2"].abs().max()).item()
    out["small_vs_cpu"] = small
    worst = max(small.values())
    check(worst <= 1e-10, f"{tag}: N = {sm['n']} + {cuts_s[-1]} anchors, order {sm['order']} x {sm['panels']}: the "
          f"card vs the CPU path {worst:.3e} relative <= 1e-10 ({small})")

    # The 1-D exact hooks at 1e5 points against the CPU.
    x = np.linspace(-1.5, 1.5, 100_000)
    hooks = {}
    for nu in (0.5, 1.5, 2.5, 3.5):
        k = 1.7 * lgt.kernels.Matern((), nu=nu, lengthscales=0.6)
        I1 = lgt.functionals.LebesgueIntegral(lgt.domains.Interval(-1.0, 1.0))
        fn = exact_integral_hooks(k, I1)[0]
        got, ref = fn(torch.as_tensor(x, device=device)), fn(torch.as_tensor(x))
        hooks[nu] = ((got.cpu() - ref).abs().max() / ref.abs().max()).item()
        check(got.device.type == torch.device(device).type and hooks[nu] <= 1e-13,
              f"{tag}: exact Lebesgue crosscov of 1.7 Matern(nu = {nu}) at 1e5 points on {got.device} vs the CPU "
              f"{hooks[nu]:.3e} of max <= 1e-13")
    out["hooks_vs_cpu"] = hooks
    log(f"{tag} " + json.dumps(out))
    return out["launches"]


# -- parallel and native phases ---------------------------------------------------------

#: The parallel phase's dense cell: the distributed factorization's block
#: size (128 block-columns at N = 32,768).
PAR_BLOCK = 256
#: distributed_condition's weights against the dense engine's, relative to
#: max |w|: both factor the same float64 Gram, in two blocked orders, whose
#: results differ by about cond eps ~ 3e-9 at noise 1e-3 k(0) (cond ~3e7).
#: The mean of those weights at a query, K_qX w, inherits the weights' error
#: through sum_j |k_qj w_j|, the scale the gate is stated in (a mean that
#: cancels can differ by more than this bound of max |mean|: it does, 1.9e-10
#: against 1e-10, on the H100; PERF.md).
PAR_W_BOUND = 1e-8
#: The conditioner's IBVP posterior (192 anchors at noise 1e-5 appended by a
#: Schur extension) against the dense engine's (anchors first): the mean
#: relative to max |mean|, the variance relative to the prior variance it
#: is a difference of (as DIAG_BOUND, with a block-order's margin).
PAR_IBVP_MEAN_BOUND, PAR_IBVP_VAR_BOUND = 1e-9, 1e-9
#: The two-rank run on one card (gloo, both ranks on cuda:0).
PAR_TWO_RANK_N = 16384


def parallel_spans() -> "Spans":
    """The distributed regressor's kernel calls, each kept (as
    :func:`grid_spans`): K1 from its Nystrom build (the shared core's
    ``models/iterative.gram``) and from ``gram_matrix`` (``var``'s
    ``kxX``), K2 from it: the mean's calls whole, the CG's as ``None``."""
    from linpde_gp_tpu_torch.models import iterative as iterative_module
    from linpde_gp_tpu_torch.ops import gram as gram_module
    from linpde_gp_tpu_torch.parallel import iterative as par_iterative

    return Spans({"k1_blocks": (iterative_module, "gram"), "k1_gram_matrix": (gram_module, "gram"),
                  "k2_calls": (par_iterative, "gram_matvec")},
                 keep={"k1_blocks": _k1_sample, "k1_gram_matrix": _k1_sample, "k2_calls": _keep_mean_k2})


def _true_relres(reg, w) -> float:
    """``||(K + sigma^2 I) w - Y|| / ||Y||`` on the stored points, by K2 in
    f64 (held to its plain version in the kernels phase)."""
    import torch

    from linpde_gp_tpu_torch.ops.gram import gram_matvec

    X64, w64, y64 = reg.X.double(), w.double(), reg.Y.double()
    r = gram_matvec(reg._obs_spec, X64, X64, w64, "f64") + reg.noise_variance * w64 - y64
    return (torch.linalg.vector_norm(r) / torch.linalg.vector_norm(y64)).item()


def _mean_gap_bound(reg, rho_a, rho_b, prior_var_max) -> float:
    """How far two posterior means from weights with true relres ``rho_a``
    and ``rho_b`` on one system can differ: with ``A = K + sigma^2 I`` and
    the residuals ``r_a``, ``r_b``, the weights differ by ``A^{-1} (r_a -
    r_b)``, so at a query ``q`` (Cauchy-Schwarz in ``A``'s inner product,
    ``k_q^T A^{-1} k_q <= k(q, q)``, ``A >= sigma^2 I``) the means differ by
    at most ``sqrt(k(q, q)) (rho_a + rho_b) ||Y|| / sigma``; at CG tol it is
    ``2 tol ||Y|| sqrt(k(q, q)) / sigma``."""
    import torch

    y = torch.linalg.vector_norm(reg.Y.double()).item()
    return float(np.sqrt(prior_var_max) * (rho_a + rho_b) * y / np.sqrt(reg.noise_variance))


def _check_banded_call(banded, mode, tag, r) -> dict:
    """A rank's banded kernel at ``r`` columns (r = 1 the CG's narrow route,
    r = 256 the variance's multi-column one) on a random V against the
    plain f64 version on the same points: f64 within 1e-12 of sum_j |k_ij
    v_j| (bounded by the absolute terms' kernel), ff rounded row by row
    from the f64 product and its pair within ``ROW_BOUND`` eps of that sum,
    as the kernels phase holds them."""
    import torch

    from linpde_gp_tpu_torch.ops.banded import make_banded_matvec

    g = torch.Generator(device=banded.device).manual_seed(r)
    X0, X1 = banded.X0s[banded._inv0], banded.X1s[torch.argsort(banded._perm1)]
    V = torch.randn((X1.shape[0], r), generator=g, device=banded.device, dtype=X1.dtype)
    V = V[:, 0] if r == 1 else V
    res = banded(V)
    scale, terms = banded.spec
    oracle = make_banded_matvec(banded.spec, X0.double(), X1.double(), mode="f64").plain(V.double())
    absum = make_banded_matvec((abs(scale), abs_terms(terms)), X0.double(), X1.double(), mode="f64").plain(
        V.double().abs())
    if mode == "f64":
        e = torch.nan_to_num((res - oracle).abs() / absum, nan=0.0).max().item()
        check(e <= 1e-12, f"{tag}: banded kernel f64 at r = {r} vs plain f64: {e:.3e} of sum_j |k_ij v_j| <= 1e-12")
        return dict(r=r, row_rel_err=e)
    eps32 = torch.finfo(torch.float32).eps
    e_row, e_pair = row_excess(res[0], oracle, absum, eps32), pair_excess(res, oracle, absum, eps32)
    check(e_row <= ROW_BOUND and e_pair <= ROW_BOUND, f"{tag}: banded kernel ff at r = {r} is the f64 product "
          f"rounded, row by row: excess {e_row:.3g}, ff pair {e_pair:.3g} eps sum_j|k_ij v_j| <= {ROW_BOUND:g}")
    return dict(r=r, row_excess=e_row, pair_excess=e_pair)


def run_parallel_iterative(mesh, path, mode, n, nq, rank, *, k0=None, tol=1e-5, maxiter=512, var_q=VAR_QUERIES):
    """``DistributedIterativeGPRegressor`` on the heat benchmark problem (the
    main phase's, N = ``n``, noise 1e-3 k(0)) or the Wendland cell's, the
    launch counts set to 0 before its work (build, solve, mean at ``nq``,
    ``var`` at ``var_q``: heat in f64, Wendland in both modes) and read just
    after; then, outside that window: the true relres (f64), the
    single-card ``IterativeGPRegressor`` on the same data (its mean within
    :func:`_mean_gap_bound`, its f64 ``var`` within ``VAR_REL_BOUND`` of max
    var), and the run's own K1, K2 and banded calls against their plain
    versions (on a card).  Returns the measurements (``launches``)."""
    import torch

    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.parallel import DistributedIterativeGPRegressor

    tag = f"parallel {path}[{mode}]"
    dev = mesh.device
    on_card = dev.type == "cuda"
    if path == "heat":
        X, Y, Xq = bench_data(n, nq)
        prior, H = heat_problem(dev)
        kw = dict(L=H, noise_variance=float(1e-3 * k0["obs"]), tol=tol, maxiter=maxiter, precond_rank=rank, mode=mode)
        prior_var_max = 1.0
    else:
        X, _, Y, Xq = wendland_data(n, nq)
        prior = wendland_prior(dev)
        kw = dict(noise_variance=1e-3, tol=tol, maxiter=maxiter, precond_rank=rank, mode=mode)
        prior_var_max = 2.0
    X, Y = torch.from_numpy(X), torch.from_numpy(Y)
    xq, xv = torch.from_numpy(Xq), torch.from_numpy(np.asarray(Xq[:var_q], np.float64))
    out = dict(path=path, mode=mode, n=n, nq=nq, rank=rank, noise=kw["noise_variance"], world=mesh.size)
    spans = parallel_spans()
    _cuda.reset_launches()
    with spans:
        t0 = time.perf_counter()
        reg = DistributedIterativeGPRegressor(prior, X, Y, mesh=mesh, **kw)
        reg._preconditioner()
        sync()
        out["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        w = reg.representer_weights
        sync()
        out["solve_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mu = reg.mean(xq)
        sync()
        out["mean_s"] = time.perf_counter() - t0
        var = None
        if var_q and (path == "wendland" or mode == "f64"):
            t0 = time.perf_counter()
            var = reg.var(xv, block_size=256)
            sync()
            out["var_s"] = time.perf_counter() - t0
    out["launches"] = dict(_cuda.launches)
    out["iterations"], out["relres"] = reg.solve_info
    check(bool(torch.isfinite(w).all()) and mu.shape == (nq,) and bool(torch.isfinite(mu).all()),
          f"{tag}: weights and the mean at {nq} queries finite")
    check(out["relres"] <= 100 * tol, f"{tag}: solver relres {out['relres']:.3e} <= {100 * tol:g}")
    if path == "wendland":
        check(reg._banded is not None, f"{tag}: the rank's banded schedule runs the CG "
              f"({None if reg._banded is None else reg._banded.pair_fraction:.4g} of pairs)")
    out["true_relres"] = _true_relres(reg, w)
    check(out["true_relres"] <= 100 * tol, f"{tag}: true relres (f64) {out['true_relres']:.3e} <= {100 * tol:g}")

    single = IterativeGPRegressor(prior, X, Y, device=dev, **kw)
    single._preconditioner()
    sync()
    t0 = time.perf_counter()
    w_s = single.representer_weights
    sync()
    out["single_solve_s"] = time.perf_counter() - t0
    out["single_iterations"] = single.solve_info[0]
    mu_s = single.mean(xq)
    rho_s = _true_relres(single, w_s)
    bound = _mean_gap_bound(reg, out["true_relres"], rho_s, prior_var_max)
    gap = (mu.double() - mu_s.double()).abs().max().item()
    out.update(single_true_relres=rho_s, mean_gap=gap, mean_gap_bound=bound,
               mean_gap_rel=gap / mu_s.double().abs().max().item())
    check(gap <= bound, f"{tag}: mean at {nq} queries vs the single-card regressor: {gap:.3e} <= {bound:.3e} "
          f"(sqrt(k(q,q)) (rho + rho_1) ||Y|| / sigma, rho {out['true_relres']:.2e} and {rho_s:.2e})")
    if var is not None:
        prior_var = prior.cov(xv.to(dev))
        check(bool(torch.isfinite(var).all()) and bool((var >= 0).all()) and bool((var <= prior_var * (1 + 1e-6)).all()),
              f"{tag}: 0 <= var <= prior var at {var_q} queries; range [{var.min().item():.4e}, {var.max().item():.4e}]")
        if mode == "f64" and path == "heat":
            var_s = single.var(xv, block_size=256)
            rel = ((var - var_s).abs().max() / var_s.abs().max()).item()
            out["var_vs_single"] = rel
            check(rel <= VAR_REL_BOUND, f"{tag}: var vs the single-card var: {rel:.3e} of max var <= {VAR_REL_BOUND:g}")
    del single
    # K1 keys (spec, mode): the Nystrom blocks', and kxX's (f64) where var
    # ran; the Wendland cell's f64 kxX shares the Nystrom blocks' key.
    keys = {(reg._obs_spec[1], mode)} | ({(reg._cross_spec[1], "plain" if mode == "plain" else "f64")}
                                         if var is not None else set())
    if on_card:
        out["kernels"] = _check_grid_kernels(spans, tag, min_k1=len(keys), k1_what="the Nystrom blocks"
                                             + (", kxX" if var is not None else ""))
        if reg._banded is not None:
            out["kernels"]["banded"] = [_check_banded_call(reg._banded, mode, tag, r) for r in (1, 256)]
    log(f"{tag} " + json.dumps(out))
    return out


def _two_rank_heat(n, nq, rank, noise, tol):
    """One rank of the two-rank run on one card: the heat problem at ``n``
    points through ``DistributedIterativeGPRegressor`` (f64), its mean at
    ``nq`` queries; returns numpy results, seconds and this rank's launches."""
    import torch

    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.parallel import DistributedIterativeGPRegressor, make_mesh

    mesh = make_mesh()
    prior, H = heat_problem()
    X, Y, Xq = bench_data(n, nq)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    reg = DistributedIterativeGPRegressor(prior, torch.from_numpy(X), torch.from_numpy(Y), mesh=mesh, L=H,
                                          noise_variance=noise, tol=tol, precond_rank=rank, mode="f64")
    w = reg.representer_weights
    sync()
    solve_s = time.perf_counter() - t0
    mu = reg.mean(torch.from_numpy(Xq))
    return dict(device=str(mesh.device), world=mesh.size, solve_s=solve_s, info=reg.solve_info,
                w=w.cpu().numpy(), mean=mu.cpu().numpy(), launches=dict(_cuda.launches))


def run_two_ranks_one_card(k0, n=PAR_TWO_RANK_N, nq=1024, tol=1e-5) -> dict:
    """Two ranks on the one card over gloo with CUDA tensors (``parallel/
    launch.spawn``): the heat problem at ``n`` points in f64.  Both ranks must
    return the same weights bit for bit, and the mean must lie within
    :func:`_mean_gap_bound` of the single-card regressor's.  Returns the
    measurements, with both ranks' launches summed."""
    import torch

    from linpde_gp_tpu_torch.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu_torch.parallel.launch import spawn

    tag = f"parallel two ranks on one card (gloo, N = {n})"
    noise, rank = float(1e-3 * k0["obs"]), min(8192, n // 4)
    t0 = time.perf_counter()
    ranks = spawn(_two_rank_heat, 2, (n, nq, rank, noise, tol), timeout=600, backend="gloo", device="cuda")
    out = dict(n=n, nq=nq, rank=rank, wall_s=time.perf_counter() - t0, devices=[r["device"] for r in ranks],
               solve_s=[r["solve_s"] for r in ranks], info=ranks[0]["info"])
    check(all(np.array_equal(r["w"], ranks[0]["w"]) and np.array_equal(r["mean"], ranks[0]["mean"]) for r in ranks),
          f"{tag}: both ranks hold the same weights and mean")
    X, Y, Xq = bench_data(n, nq)
    prior, H = heat_problem()
    single = IterativeGPRegressor(prior, torch.from_numpy(X), torch.from_numpy(Y), L=H, noise_variance=noise, tol=tol,
                                  precond_rank=rank, mode="f64", device="cuda")
    single._preconditioner()
    sync()
    t0 = time.perf_counter()
    w_s = single.representer_weights
    sync()
    out.update(single_solve_s=time.perf_counter() - t0, single_info=single.solve_info)
    rho = _true_relres(single, torch.as_tensor(ranks[0]["w"]).cuda())
    bound = _mean_gap_bound(single, rho, _true_relres(single, w_s), 1.0)
    gap = float(np.max(np.abs(ranks[0]["mean"] - single.mean(torch.from_numpy(Xq)).cpu().numpy())))
    out.update(true_relres=rho, mean_gap=gap, mean_gap_bound=bound)
    check(rho <= 100 * tol and gap <= bound, f"{tag}: true relres {rho:.3e} <= {100 * tol:g}; mean vs the single-card "
          f"regressor {gap:.3e} <= {bound:.3e}")
    out["launches"] = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    log(f"{tag} " + json.dumps(out))
    return out


def run_parallel_dense(mesh, n=DENSE_N, nq=8192, var_q=256, noise_rel=1e-3, anchor_noise=1e-5, n_ic=96,
                       n_bc=48) -> dict:
    """The dense distributed cell at ``n`` points (f64): ``distributed_condition``
    on ``H k H*`` with random data (seed 0, as bench.py draws it) in layouts
    auto (cyclic on one rank), contiguous and 2d (forced on the 1 x 1 mesh),
    its weights and their mean at ``nq`` queries (K2) against the dense
    engine's on the same data (the mean in units of sum_j |k_qj w_j|, by K2
    on the absolute terms, outside the window); then ``DistributedConditioner`` on the IBVP
    (``H u = 0`` at the points, then the 192 anchors by one Schur extension)
    and ``posterior_eval`` at ``nq`` queries against the dense engine's IBVP
    posterior (mean, and std at ``var_q``).  Each run sets the launch counts
    to 0 before its work and reads them after; the dense engine's references
    run outside those windows.  Peak device memory per run < 40 GB.  The
    auto run's K1 block and the mean's K2 calls are held to their plain
    versions (:func:`_check_dense_kernels`; on a card).  Returns the
    measurements."""
    import torch

    import linpde_gp_tpu_torch as lgt
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.ops import gram as gram_module
    from linpde_gp_tpu_torch.ops.gram import kernel_term_specs
    from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel
    from linpde_gp_tpu_torch.parallel import DistributedConditioner, distributed_condition
    from linpde_gp_tpu_torch.specs import spec_diagonal

    tag = "parallel dense"
    dev = mesh.device
    on_card = dev.type == "cuda"
    prior, H = heat_problem(dev)
    k = prior.cov
    k_obs = apply_operator_to_kernel(H, apply_operator_to_kernel(H, k, argnum=1), argnum=0)
    k_Hx, cross_spec = apply_operator_to_kernel(H, k, argnum=0), kernel_term_specs(apply_operator_to_kernel(H, k, argnum=1))
    abs_spec = (abs(cross_spec[0]), abs_terms(cross_spec[1]))
    X, Xq = ibvp_data(n, nq)
    Xa, Ya = ibvp_anchors(n_ic, n_bc)
    Yr = bench_data(n, 1)[1]
    noise = noise_rel * spec_diagonal(heat_specs()["obs"])
    out = dict(n=n, nq=nq, block=PAR_BLOCK, noise=noise, world=mesh.size)
    total = {name: 0 for name in KERNELS}

    post = prior.condition_on_observations(Yr, X=X, L=H, b=lgt.Normal(np.zeros(n), noise * np.ones(n)))
    w_ref, mu_ref = post.representer_weights, post.mean(Xq)
    del post
    spans = Spans({"k1_gram_blocks": (gram_module, "gram"), "k2_calls": (gram_module, "gram_matvec")},
                  keep={"k1_gram_blocks": _k1_sample, "k2_calls": lambda args, res: (args, res)})
    Xt, Xqt = torch.from_numpy(X).to(dev).double(), torch.from_numpy(Xq).to(dev).double()

    def fresh():
        _cuda.reset_launches()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0

    for layout in ("auto", "contiguous", "2d"):
        fresh()
        with spans if layout == "auto" else contextlib.nullcontext():
            t0 = time.perf_counter()
            w, chol = distributed_condition(k_obs, X, Yr, mesh=mesh, noise_variance=noise, block_size=PAR_BLOCK,
                                            jitter=0.0, layout=layout)
            sync()
            cond_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            mu = gram_module.gram_matvec(cross_spec, Xqt, Xt, w, "f64")
            sync()
            mean_s = time.perf_counter() - t0
        launches = dict(_cuda.launches)
        peak = peak_gb()
        del chol
        w_err = ((w - w_ref).abs().max() / w_ref.abs().max()).item()
        m_err = ((mu - mu_ref).abs().max() / mu_ref.abs().max()).item()
        m_sum = ((mu - mu_ref).abs() / gram_module.gram_matvec(abs_spec, Xqt, Xt, w.abs(), "f64")).max().item()
        out[layout] = dict(condition_s=cond_s, mean_s=mean_s, peak_gb=peak, w_rel_err=w_err, mean_rel_err=m_err,
                           mean_rel_abs_sum=m_sum, launches=launches)
        for key in total:
            total[key] += launches[key]
        check(w_err <= PAR_W_BOUND, f"{tag}[{layout}]: weights vs the dense engine {w_err:.3e} of max |w| <= "
              f"{PAR_W_BOUND:g}; {cond_s:.3f} s")
        check(m_sum <= PAR_W_BOUND, f"{tag}[{layout}]: mean at {nq} queries vs the dense engine {m_sum:.3e} of "
              f"sum_j |k_qj w_j| <= {PAR_W_BOUND:g} ({m_err:.3e} of max |mean|)")
        check(peak < 40.0, f"{tag}[{layout}]: peak device memory {peak:.2f} GB < 40")
    del w, mu
    if on_card:
        torch.cuda.empty_cache()
        out["kernels"] = _check_dense_kernels(spans, tag, True)
    del spans

    fresh()
    t0 = time.perf_counter()
    cond = DistributedConditioner(mesh=mesh, block_size=PAR_BLOCK)
    cond.condition(k_obs, X, np.zeros(n), noise_variance=noise, jitter=0.0)
    sync()
    out["conditioner_condition_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cond.extend([k_Hx], k, Xa, Ya, noise_variance=anchor_noise, jitter=0.0)
    sync()
    out["conditioner_extend_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean, std = cond.posterior_eval([k_Hx, k], k, Xq, with_std=True, query_block_size=1024)
    sync()
    out["posterior_eval_s"] = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    out["conditioner"] = dict(launches=launches, peak_gb=peak_gb())
    for key in total:
        total[key] += launches[key]
    del cond
    if on_card:
        torch.cuda.empty_cache()
    cuts = (0, n_ic, n_ic + n_bc, n_ic + 2 * n_bc)
    post = condition_dense_ibvp(prior, H, X, Xa, Ya, cuts, noise, anchor_noise)
    mu_e, std_e = post.mean(Xq), post.std(Xq[:var_q])
    del post
    m_err = ((mean - mu_e).abs().max() / mu_e.abs().max()).item()
    prior_var = prior.cov(torch.from_numpy(Xq[:var_q]).to(dev).double())
    v_err = ((std[:var_q] ** 2 - std_e ** 2).abs() / prior_var).max().item()
    rmse = float(np.sqrt(np.mean((mean.cpu().numpy() - u_star(Xq)) ** 2)))
    out["conditioner"].update(mean_rel_err=m_err, var_rel_prior=v_err, rmse=rmse)
    check(bool(torch.isfinite(mean).all()) and bool(torch.isfinite(std).all()), f"{tag}: posterior_eval finite")
    check(m_err <= PAR_IBVP_MEAN_BOUND, f"{tag}: conditioner + extension, posterior_eval mean at {nq} queries vs the "
          f"dense engine {m_err:.3e} of max |mean| <= {PAR_IBVP_MEAN_BOUND:g}; RMSE vs u* {rmse:.3e}")
    check(v_err <= PAR_IBVP_VAR_BOUND, f"{tag}: posterior_eval var (std^2) at {var_q} queries vs the dense engine "
          f"{v_err:.3e} of the prior variance <= {PAR_IBVP_VAR_BOUND:g}")
    check(out["conditioner"]["peak_gb"] < 40.0, f"{tag}: conditioner peak {out['conditioner']['peak_gb']:.2f} GB < 40")
    out["launches"] = total
    log(f"{tag} " + json.dumps(out))
    return out


def phase_parallel(specs, k0, n, nq, rank) -> dict:
    """The parallel layer at world size 1 over NCCL on cuda:0 (module
    docstring, phase 12): the gram-free heat and Wendland cells, the dense
    distributed cell, two ranks on the one card over gloo, and the dry run.
    Returns the launches of the runs (their windows only)."""
    import torch.distributed as dist

    from linpde_gp_tpu_torch.parallel import make_mesh
    from linpde_gp_tpu_torch.parallel.dryrun import dryrun_multichip

    mesh = make_mesh(1)
    check(mesh.size == 1 and dist.get_backend() == "nccl" and mesh.device.type == "cuda",
          f"parallel: a world of {mesh.size} over {dist.get_backend()} on {mesh.device}")
    total = {name: 0 for name in KERNELS}
    runs = [("heat", "ff"), ("heat", "f64"), ("wendland", "ff"), ("wendland", "f64"), ("dense", "f64"),
            ("two ranks", "f64")]
    for path, mode in runs:
        try:
            if path in ("heat", "wendland"):
                res = run_parallel_iterative(mesh, path, mode, n, nq, rank if path == "heat" else WENDLAND_RANK, k0=k0)
            elif path == "dense":
                res = run_parallel_dense(mesh, DENSE_N, nq)
            else:
                res = run_two_ranks_one_card(k0)
        except Exception as exc:  # noqa: BLE001 - report, go on with the next run, fail at the end
            traceback.print_exc()
            failures.append(f"parallel[{path} {mode}]: {type(exc).__name__}: {exc}")
            continue
        for name in total:
            total[name] += res["launches"][name]
        log(f"parallel[{path} {mode}] launches {res['launches']}")
    try:
        t0 = time.perf_counter()
        errs = dryrun_multichip(1, device="cuda")
        log(f"parallel dryrun_multichip(1) {time.perf_counter() - t0:.1f} s " + json.dumps(errs))
    except Exception as exc:  # noqa: BLE001 - report and fail at the end
        traceback.print_exc()
        failures.append(f"parallel[dryrun]: {type(exc).__name__}: {exc}")
    for name in KERNELS:
        if name != "gram_matvec_sym":  # the ranks' matvecs are cross forms, slab x X
            check(total[name] > 0, f"parallel paths launched {name} {total[name]} times")
    dist.destroy_process_group()
    return total


def phase_native(n=4096) -> dict:
    """The g++ host engine (``native/``) built on this machine and held to
    the plain float64 version on the CPU at ``n x n`` (the heat observation
    spec, random points of [0, 5] x [-1, 1]): the Gram within 1e-13 of max
    |K|, the matvec within 1e-12 of max |Kv|, and ``ops/gram.gram`` on f64
    CPU tensors routed to it (the same Gram, bit for bit).  Logs both
    routes' seconds beside the host's CPU model.  Launches no card kernel."""
    import os
    import platform

    import torch

    from linpde_gp_tpu_torch import native
    from linpde_gp_tpu_torch.ops.gram import gram, gram_matvec_plain, gram_plain
    from linpde_gp_tpu_torch.specs import load_specs

    tag = "native"
    check(native.available(), f"{tag}: g++ present")
    fields = {}
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as fh:
        for line in fh:
            key, _, val = line.partition(":")
            fields.setdefault(key.strip(), val.strip())
    cpu = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model") if k in fields) or "model not reported"
    cpu += f" ({platform.machine()})"
    scale, terms = load_specs()["obs"]
    rng = np.random.default_rng(0)
    X0, X1 = (torch.from_numpy(np.stack([rng.uniform(0, 5, n), rng.uniform(-1, 1, n)], -1)) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal(n))
    t0 = time.perf_counter()
    eng = native.engine_for_spec(scale, terms)
    out = dict(n=n, cpu=cpu, cpu_count=os.cpu_count(), torch_threads=torch.get_num_threads(),
               build_s=time.perf_counter() - t0, built=list(native.engine.builds))

    def best(fn, reps=3):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = fn()
            times.append(time.perf_counter() - t0)
        return min(times), res

    out["engine_gram_s"], G = best(lambda: eng.gram(X0, X1))
    out["engine_matvec_s"], Kv = best(lambda: eng.matvec(X0, X1, v))
    out["plain_gram_s"], P = best(lambda: scale * gram_plain(terms, X0, X1, "f64"), reps=1)
    out["plain_matvec_s"], Pv = best(lambda: gram_matvec_plain((scale, terms), X0, X1, v, "f64"), reps=1)
    out["gram_rel_err"] = ((G - P).abs().max() / P.abs().max()).item()
    out["matvec_rel_err"] = ((Kv - Pv).abs().max() / Pv.abs().max()).item()
    if out["gram_rel_err"] > 1e-13:  # where, and which side: each pair again on its own, and the Gram again
        i, j = divmod(int((G - P).abs().argmax()), n)
        again = eng.gram(X0, X1)
        out["gram_worst"] = dict(i=i, j=j, engine=G[i, j].item(), plain=P[i, j].item(),
                                 engine_pair=eng.gram(X0[i:i + 1], X1[j:j + 1])[0, 0].item(),
                                 plain_pair=scale * gram_plain(terms, X0[i:i + 1], X1[j:j + 1], "f64")[0, 0].item(),
                                 engine_again_rel_err=((again - P).abs().max() / P.abs().max()).item(),
                                 bad_entries=int(((G - P).abs() > 1e-13 * P.abs().max()).sum()))
    routed = gram(terms, X0, X1, "f64")
    ref = native.engine_for_spec(1.0, terms).gram(X0, X1)
    check(out["gram_rel_err"] <= 1e-13, f"{tag}: Gram {n}x{n} vs the plain f64 version {out['gram_rel_err']:.3e} of "
          "max |K| <= 1e-13")
    check(out["matvec_rel_err"] <= 1e-12, f"{tag}: matvec vs the plain f64 version {out['matvec_rel_err']:.3e} of "
          "max |Kv| <= 1e-12")
    check(torch.equal(routed, ref), f"{tag}: ops/gram.gram on f64 CPU tensors takes the engine")
    log(f"{tag} ({cpu}, {os.cpu_count()} CPUs): engine Gram {out['engine_gram_s']:.3f} s, matvec "
        f"{out['engine_matvec_s']:.3f} s; plain torch Gram {out['plain_gram_s']:.3f} s, matvec {out['plain_matvec_s']:.3f} s")
    log(f"{tag} " + json.dumps(out))
    return out


#: The port's CPU runs of ``entry()`` and of the experiments (the surface
#: and experiments phases' references), made once by
#: :func:`cpu_reference_specs`.
CPU_RUNS: dict = {}
#: Kernel names of K1 and K2 in a profiler trace (``csrc/gram.cuh``).
K1_NAMES, K2_NAMES = ("gram_kernel",), ("gram_matvec_kernel", "gram_matmat_kernel")
#: The surface phase's bound on the card's mean (std) against the CPU's,
#: relative to max |mean| (max std).
SURFACE_BOUND = 1e-10


def cpu_reference_specs() -> dict:
    """Run the port's ``entry()`` and its nine experiment runs on the CPU
    (the references of the surface and experiments phases, kept in
    :data:`CPU_RUNS`) and return every ``(scale, terms)`` spec they hand to
    ``ops/gram.gram`` / ``gram_matvec``, so that the build phase builds
    their kernel modules in parallel rather than one at a time at first use
    on the card."""
    from linpde_gp_tpu_torch.entry import entry
    from linpde_gp_tpu_torch.experiments.run_all import run_all
    from linpde_gp_tpu_torch.ops import gram as gram_module

    seen = {}

    def record(fn, spec_of):
        def wrapper(*args, **kwargs):
            scale, terms = spec_of(args)
            seen.setdefault(repr(terms), (scale, tuple(terms)))
            return fn(*args, **kwargs)

        return wrapper

    saved = gram_module.gram, gram_module.gram_matvec
    gram_module.gram = record(saved[0], lambda a: (1.0, a[0]))
    gram_module.gram_matvec = record(saved[1], lambda a: a[0])
    try:
        t0 = time.perf_counter()
        fn, (xq,) = entry(device="cpu")
        mean, std = fn(xq)
        CPU_RUNS["entry"] = (xq, mean, std, time.perf_counter() - t0)
        CPU_RUNS["experiments"] = run_all("cpu")
    finally:
        gram_module.gram, gram_module.gram_matvec = saved
    log(f"cpu references: entry {CPU_RUNS['entry'][3]:.2f} s, experiments "
        f"{sum(r[2] for r in CPU_RUNS['experiments']):.2f} s; {len(seen)} specs")
    return {f"cpu_ref_{i}": spec for i, spec in enumerate(seen.values())}


def trace_kernels(path) -> list[tuple[str, float]]:
    """``(name, microseconds)`` of each device kernel in a ``torch.profiler``
    Chrome trace."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(e.get("name", ""), float(e.get("dur", 0.0))) for e in events if e.get("cat") == "kernel"]


def phase_surface(device="cuda") -> dict:
    """The port's ``entry()`` on the card inside ``utils.profiling.trace``
    and a ``StageTimer`` (build, forward), the launch counts set to 0 just
    before and read just after: mean and std (float64) within
    ``SURFACE_BOUND`` of max |mean| and max std of the same ``entry()`` on
    the CPU; K1 and K2 launched by the counts and in the exported trace;
    finite values of shape (256,), on the card.  Logs the stage seconds and
    the kernels of the trace."""
    import torch

    from linpde_gp_tpu_torch.entry import entry
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.utils.profiling import StageTimer, trace

    tag = "surface"
    logdir = _cuda.BUILD_DIR / "surface_trace"
    timer = StageTimer()
    _cuda.reset_launches()
    with trace(str(logdir)):
        with timer("build"):
            fn, (xq,) = entry(device=device)
        with timer("forward"):
            mean, std = fn(xq)
    launches = dict(_cuda.launches)
    xq_c, mean_c, std_c, _ = CPU_RUNS["entry"]
    kernels = trace_kernels(logdir / "trace.json")
    names = [name for name, _ in kernels]
    k1 = sum(any(k in n for k in K1_NAMES) for n in names)
    k2 = sum(any(k in n for k in K2_NAMES) for n in names)
    check(mean.is_cuda and std.is_cuda and mean.dtype == torch.float64 and tuple(mean.shape) == (256,)
          and tuple(std.shape) == (256,), f"{tag}: mean and std float64 (256,) on the card")
    check(bool(torch.isfinite(mean).all() and torch.isfinite(std).all()), f"{tag}: finite mean and std")
    check(torch.equal(xq.cpu(), xq_c), f"{tag}: the same 16 x 16 query grid")
    err_m = ((mean.cpu() - mean_c).abs().max() / mean_c.abs().max()).item()
    err_s = ((std.cpu() - std_c).abs().max() / std_c.max()).item()
    check(err_m <= SURFACE_BOUND, f"{tag}: mean vs the CPU's {err_m:.3e} of max |mean| <= {SURFACE_BOUND:g}")
    check(err_s <= SURFACE_BOUND, f"{tag}: std vs the CPU's {err_s:.3e} of max std <= {SURFACE_BOUND:g}")
    check(launches["gram"] > 0 and launches["gram_matvec"] + launches["gram_matvec_wide"] > 0,
          f"{tag}: K1 and K2 launched (counts {launches})")
    check(k1 > 0 and k2 > 0, f"{tag}: the profiler trace records K1 ({k1}) and K2 ({k2}) launches")
    # The card's busy share of the traced stages: kernel time (one stream, so
    # no overlap) over their synchronized wall time.
    busy = 1e-6 * sum(us for _, us in kernels) / sum(timer.stages.values())
    out = dict(stages_s=timer.summary(), launches=launches, trace_kernels=sorted(set(names)), mean_rel_err=err_m,
               std_rel_err=err_s, trace_k1=k1, trace_k2=k2, device_busy_share=busy)
    log(f"{tag} " + json.dumps(out))
    return launches


def phase_experiments(device="cuda") -> dict:
    """The port's nine experiment runs (``experiments/run_all.RUNS``) on the
    card, each with the launch counts set to 0 just before and read just
    after, against the port's CPU run of the same script
    (``experiments.common.metric_mismatches``: relative 1e-6, the
    round-off metrics at their floors); each script's own gates hold.
    Logs each run's seconds on the card and on the CPU and its launches;
    returns the launches summed."""
    import io

    from linpde_gp_tpu_torch.experiments.common import metric_mismatches
    from linpde_gp_tpu_torch.experiments.run_all import RUNS
    from linpde_gp_tpu_torch.ops import _cuda

    tag = "experiments"
    cpu_runs = CPU_RUNS["experiments"]
    total = {k: 0 for k in _cuda.launches}
    rows = []
    for (name, fn), (cpu_name, cpu_payload, cpu_s) in zip(RUNS, cpu_runs):
        _cuda.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            payload = fn(device=device)
        sync()
        secs = time.perf_counter() - t0
        launches = dict(_cuda.launches)
        for k, v in launches.items():
            total[k] += v
        bad = metric_mismatches(payload, cpu_payload)
        check(cpu_name == name and not bad, f"{tag}: {name} on the card vs the CPU{': ' + '; '.join(bad) if bad else ''}")
        rows.append(dict(run=name, card_s=secs, cpu_s=cpu_s, launches={k: v for k, v in launches.items() if v},
                         stages_s=payload["wall_clock_s"], metrics=payload["metrics"]))
        log(f"{tag}: {name}: card {secs:.3f} s, CPU {cpu_s:.3f} s, launches {rows[-1]['launches']}")
    check(total["gram"] > 0 and total["gram_matvec"] > 0, f"{tag}: K1 and K2 launched ({total})")
    log(f"{tag}: card {sum(r['card_s'] for r in rows):.2f} s in all")
    log(f"{tag} " + json.dumps(rows))
    return total


#: The scale experiments' parity runs, at the sizes of
#: tests/test_torch_experiments_scale_*.py: ``(module, environment)``; the
#: rest of each script's settings at the JAX script's CPU-branch defaults,
#: but the grid's CG tol: at its 1e-6 two roundings of one solve stop at
#: iterates whose means' RMSE differ by 3e-6 of it (H100 against the CPU),
#: at 1e-9 the RMSE has converged (the CPU against JAX: 1e-8 of it).
SCALE_PARITY = (
    ("large_scale", {"LS_N": "512"}),
    ("grid_mode", {"GM_NT": "24", "GM_NX": "16", "GM_TOL": "1e-9"}),
    ("variance", {"VT_N": "512"}),
    ("wendland_banded", {"WB_N": "4096"}),
    ("scaling", {}),
    ("gram_noise_floor", {"NF_N": "256", "NF_THROUGHPUT_N": "512"}),
    ("precond_spectroscopy", {}),
)
#: The parity runs of the sweep and the spectroscopy (the tests' arguments).
SCALE_SIZES_SMALL = (256, 512)
SPECTROSCOPY_SMALL = ["--n", "1024", "--ranks", "128,256"]
#: The scale phase's gates: RMSE vs u* (PERF.md section 2) and the banded
#: matvec's agreement with dense K2 in mode ff (``phase_banded_timing``).
SCALE_RMSE, SCALE_BANDED_AGREE, SCALE_PARTITION = 4e-4, 1e-8, 1e-3


@contextlib.contextmanager
def environment(env: dict):
    """``os.environ`` with ``env`` set, restored on exit."""
    import os

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def scale_run(name, device, **kw):
    """The scale experiment ``name``'s payload (its stdout swallowed): the
    sweep and the spectroscopy at the parity sizes unless ``kw`` gives
    their arguments."""
    import importlib
    import io

    module = importlib.import_module(f"linpde_gp_tpu_torch.experiments.{name}")
    with contextlib.redirect_stdout(io.StringIO()):
        if name == "scaling":
            return module.main(kw.pop("sizes", SCALE_SIZES_SMALL), reps=kw.pop("reps", 1), device=device, **kw)
        if name == "precond_spectroscopy":
            return module.main(kw.pop("argv", SPECTROSCOPY_SMALL), device=device)
        return module.main(device=device, **kw)


def check_k2_sampled_rows(n=100_000, rows=256, tag="scale") -> dict:
    """``experiments/probe_diverge_tpu.py`` (a): K2 at N x N, r = 1, in modes
    ff and f64 on the heat benchmark's float32 points, held at ``rows``
    sampled rows to the float64 product of the plain version's f64 Gram rows
    of the same points: ff's pair within ``ROW_BOUND`` of the rows' float32
    rounding scale (:func:`pair_excess`), f64 within 1e-11 of sum_j |k_ij
    v_j| (n eps64, the worst case of a sum of n terms)."""
    import torch

    from linpde_gp_tpu_torch.ops.gram import gram_matvec, gram_plain

    spec = heat_specs()["obs"]
    X, _, _ = bench_data(n, 0)
    rng = np.random.default_rng(3)
    v = torch.tensor(rng.standard_normal(n).astype(np.float32), device="cuda")
    sel = torch.as_tensor(rng.choice(n, rows, replace=False), device="cuda")
    Xd = torch.tensor(X, device="cuda")
    K = spec[0] * gram_plain(spec[1], Xd[sel].double(), Xd.double(), "f64")
    oracle, row_absum = K @ v.double(), K.abs() @ v.double().abs()
    del K
    out = {}
    for mode in ("ff", "f64"):
        dt = torch.float64 if mode == "f64" else torch.float32
        res = gram_matvec(spec, Xd.to(dt), Xd.to(dt), v.to(dt), mode)
        if mode == "ff":
            out[mode] = pair_excess((res[0][sel], res[1][sel]), oracle, row_absum, float(np.finfo(np.float32).eps))
            check(out[mode] <= ROW_BOUND, f"{tag}: K2 ff at {n}^2 on {rows} sampled rows: the f64 product within "
                  f"{out[mode]:.3g} <= {ROW_BOUND:g} eps32 sum_j |k_ij v_j|")
        else:
            out[mode] = ((res[sel] - oracle).abs() / row_absum).max().item()
            check(out[mode] <= 1e-11, f"{tag}: K2 f64 at {n}^2 on {rows} sampled rows: {out[mode]:.3g} <= 1e-11 "
                  f"of sum_j |k_ij v_j|")
        del res
    return out


def phase_scale(device="cuda") -> dict:
    """The seven scale experiments: (a) each at the parity sizes on the card
    and on the CPU (the CPU-branch settings, mode f64), held key by key by
    ``experiments.common.payload_mismatches``; (b) each at full size on the
    card (the TPU-branch settings, default mode), the launch counts set to
    0 just before each run and read just after, under the gates of the
    docstring.  Logs every payload, its seconds and launches; returns the
    full-size runs' launches summed."""
    import torch

    from linpde_gp_tpu_torch.experiments.common import CARD_ITER_RTOL, payload_mismatches
    from linpde_gp_tpu_torch.ops import _cuda

    tag = "scale"
    for name, env in SCALE_PARITY:
        with environment(env):
            t0 = time.perf_counter()
            want = scale_run(name, "cpu")
            cpu_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = scale_run(name, device, **({} if name == "precond_spectroscopy" else {"branch": "cpu"}))
            sync()
            card_s = time.perf_counter() - t0
        experiment = want["experiment"] if isinstance(want, dict) else name  # the spectroscopy's rows
        bad = payload_mismatches(experiment, got, want, iter_rtol=CARD_ITER_RTOL)
        check(not bad, f"{tag}: {name} at the parity sizes on the card vs the CPU"
              f"{': ' + '; '.join(bad) if bad else ''} (card {card_s:.2f} s, CPU {cpu_s:.2f} s)")

    total = {k: 0 for k in _cuda.launches}
    rows = {}

    def full(key, name, **kw):
        _cuda.reset_launches()
        t0 = time.perf_counter()
        payload = scale_run(name, device, **kw)
        sync()
        secs = time.perf_counter() - t0
        launches = dict(_cuda.launches)
        for k, v in launches.items():
            total[k] += v
        rows[key] = dict(seconds=secs, launches={k: v for k, v in launches.items() if v}, payload=payload)
        log(f"{tag}: {key}: {secs:.2f} s, launches {rows[key]['launches']}")
        log(f"{tag}[{key}] " + json.dumps(payload))
        torch.cuda.empty_cache()
        return payload

    p = full("large_scale", "large_scale")
    check(p["rmse_vs_analytic"] <= SCALE_RMSE and p["pcg_relres"] <= 100 * 1e-5,
          f"{tag}: large_scale[{p['mode']}] RMSE {p['rmse_vs_analytic']:.3e} <= {SCALE_RMSE:g}, relres "
          f"{p['pcg_relres']:.3e} <= 1e-3 (anchor noise {p['anchor_noise']:g})")
    p = full("grid_mode", "grid_mode")
    check(p["rmse_vs_analytic"] <= SCALE_RMSE and p["pcg_relres"] <= 100 * 1e-5,
          f"{tag}: grid_mode[{p['mode']}] RMSE {p['rmse_vs_analytic']:.3e} <= {SCALE_RMSE:g}, relres "
          f"{p['pcg_relres']:.3e} <= 1e-3")
    p = full("wendland_banded", "wendland_banded")
    check(p["banded_routed"] and p["agreement_rel_err"] <= SCALE_BANDED_AGREE,
          f"{tag}: wendland_banded[{p['mode']}] routed banded ({p['banded_routed']}), banded vs dense "
          f"{p['agreement_rel_err']:.3e} <= {SCALE_BANDED_AGREE:g} of max; band {p['band_fraction']:.4f} of the "
          f"tiles, {p['pair_fraction']:.4f} of the pairs")
    # The script raises on a negative variance or one above the prior's.
    p = full("variance", "variance")
    check(p["partition_consistency_rel"] <= SCALE_PARTITION,
          f"{tag}: variance[{p['mode']}] within the prior bounds; partitions agree to "
          f"{p['partition_consistency_rel']:.3e} <= {SCALE_PARTITION:g} of max var")
    # The sweep in its default mode (plain) one size at a time: a float32
    # Cholesky that breaks down raises, and is logged with its n.
    from linpde_gp_tpu_torch.experiments.scaling import SIZES

    for n in SIZES:
        try:
            p = full(f"scaling_{n}", "scaling", sizes=(n,), reps=3)
            check(len(p["results"]) == 1, f"{tag}: scaling[{p['mode']}] n={n}: finite weights")
        except torch.linalg.LinAlgError as exc:
            log(f"{tag}: scaling n={n}: the float32 Cholesky breaks down ({str(exc).splitlines()[0]})")
            rows[f"scaling_{n}"] = dict(breakdown=str(exc).splitlines()[0])
    p = full("scaling_f64", "scaling", sizes=SIZES, reps=3, mode="f64")
    check(len(p["results"]) == len(SIZES), f"{tag}: scaling[f64] finite weights at every size {SIZES}")
    p = full("gram_noise_floor", "gram_noise_floor")
    check(p["compensated"]["max_entry"] <= p["plain"]["max_entry"],
          f"{tag}: noise floor: ff's largest entry error {p['compensated']['max_entry']:.3e} <= plain's "
          f"{p['plain']['max_entry']:.3e} (of k0); ||E||_2 reduced {p['coherent_reduction_x']:.1f}x")
    p = full("precond_spectroscopy", "precond_spectroscopy", argv=["--spectrum"])
    iters = ", ".join(f"{r['config']} {r['iters']}" for r in p)
    check(all(r["relres"] <= 1e-5 or r["iters"] == 2000 for r in p),
          f"{tag}: spectroscopy: every config converged to tol 1e-5 or stopped at maxiter 2000 ({iters})")
    check(total["gram"] > 0 and total["gram_matvec"] > 0 and total["gram_matvec_wide"] > 0
          and total["banded_matvec"] > 0, f"{tag}: K1, K2 (r = 1 and r > 4) and the banded kernel launched ({total})")
    rows["k2_sampled_rows"] = check_k2_sampled_rows()
    log(f"{tag} " + json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "payload"} for k, v in rows.items()}))
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
    launches = {"main": {}, "dense": {}, "mean": {}, "grid": {}, "fem": {}, "integral": {}, "parallel": {},
                "surface": {}, "experiments": {}, "scale": {}}
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
            elif phase == "main":
                launches["main"] = phase_main(specs, k0, n, nq, rank)
            elif phase == "dense":
                launches["dense"] = phase_dense(DENSE_N, nq)
            elif phase == "mean":
                launches["mean"] = phase_mean(n, nq)
            elif phase == "symbolic":
                phase_symbolic()
            elif phase == "grid":
                launches["grid"] = phase_grid(timing)
            elif phase == "fem":
                launches["fem"] = phase_fem(nq)
            elif phase == "integral":
                launches["integral"] = phase_integral(DENSE_N, nq)
            elif phase == "parallel":
                launches["parallel"] = phase_parallel(specs, k0, n, nq, rank)
            elif phase == "native":
                phase_native()
            elif phase == "surface":
                launches["surface"] = phase_surface()
            elif phase == "experiments":
                launches["experiments"] = phase_experiments()
            else:
                launches["scale"] = phase_scale()
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
            modes = {m: {"x_x": row.get(key), "x_x_r4": row.get("gram_matvec_xx_r4"), "q_x": row.get("gram_matvec_qx")}
                     for m, row in timing.items()}
            ff_row = (timing.get("ff") or {}).get(key) or {}
        elif name == "gram_matvec_sym":
            key, shape = "gram_matvec_sym_xx", f"{n}x{n}, r=1, each unordered pair once"
            modes = {m: {"x_x": row.get(key)} for m, row in timing.items()}
            ff_row = (timing.get("ff") or {}).get(key) or {}
        elif name == "gram_matvec_wide":
            key, shape = "gram_matvec_xx_r256", f"{n}x{n}, r=256"
            modes = {m: {"x_x_r256": row.get(key), "x_x_r64": row.get("gram_matvec_xx_r64")}
                     for m, row in timing.items()}
            ff_row = (timing.get("ff") or {}).get(key) or {}
        elif name == "banded_matvec":
            shape = f"{n}x{n}, r=1, Wendland l=0.05"
            modes = {m: {k: v for k, v in row.items() if k != "r256"} for m, row in banded_timing.items()}
            ff_row = banded_timing.get("ff") or {}
        else:
            shape = f"{n}x{n}, r=256, Wendland l=0.05"
            modes = {m: {"r256": row.get("r256")} for m, row in banded_timing.items()}
            ff_row = (banded_timing.get("ff") or {}).get("r256") or {}
        entries.append({
            "name": name, "label": label, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches[p].get(name, 0) for p in launches),
            "launches_by_path": {p: launches[p].get(name, 0) for p in launches},
            "max_abs_err": ff_row.get("max_abs_err"),
            "ms": ff_row.get("ms"), "plain_ms": ff_row.get("plain_ms"), "bound_ms": ff_row.get("bound_ms"),
            # No single PyTorch call computes a closed-form Gram or Gram matvec of these kernels.
            "bound_by": ff_row.get("bound_by"), "library_ms": None, "mode": "ff", "shape": shape, "card": card,
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
