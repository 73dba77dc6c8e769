"""The port's ``parallel/`` on spawned gloo worlds against the JAX package's
``parallel/`` on its virtual 8-device CPU mesh.

The port runs every case (``linpde_gp_tpu_torch/parallel/dryrun.py::CASES``)
on worlds of 1, 2 and 4 ranks (``parallel/launch.spawn``: ``spawn`` start
method, a ``FileStore`` in a temporary directory, a timeout on every
world), each rank on the CPU; the JAX side runs the same inputs, made from
seeds with numpy, on ``make_mesh(4)`` / ``make_mesh(8)``.  The worlds run in
threads while the JAX references are computed.  Results are compared after
a gather, on every rank:

- factors and solves (float64, well-conditioned SPD test matrices): 1e-10
  of the largest entry;
- the conditioner and the dense posterior: 1e-9 of the largest weight, 1e-10
  of the largest mean and std (noise 1e-8 and 1e-4: ill-conditioned);
- the iterative regressor at CG tol 1e-10: the mean within 1e-6 of max
  |mean|, the weights 1e-6 of max |w| (the JAX package's own gates,
  ``tests/test_parallel.py``), and ``var`` within 1e-8 of a dense float64
  solve.

The JAX package's unrolled factorizations take seconds of XLA compile per
block-column, so its references take its masked bodies (``unroll=False``),
which give the same factor.

Two tests fail on the JAX package's behaviour: an indefinite prior makes
its Nyström build carry NaNs into the weights, where the port raises
``LinAlgError``; and its mesh CG sums K2's compensated output in float32,
which cannot reach a true relres of 10 tol at tol 3e-9, where the port's ff
CG, fed both planes of K2's pair, does (its control, fed only the hi
plane, misses).
"""

import concurrent.futures
import functools
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linpde_gp_tpu as jlgt
from linpde_gp_tpu import parallel as jpar
from linpde_gp_tpu.parallel import solve as jsolve
from linpde_gp_tpu.ops import diffops as jdiffops
from linpde_gp_tpu.ops.kernels.wendland import WendlandCovarianceFunction as JWendland
from linpde_gp_tpu.ops.pallas_gram import kernel_term_specs as jspecs
from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel as japply
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.ops.gram import gram_matrix, kernel_term_specs
from linpde_gp_tpu_torch.ops.kernels.wendland import WendlandCovarianceFunction
from linpde_gp_tpu_torch.ops.transforms import apply_operator_to_kernel
from linpde_gp_tpu_torch.parallel.dryrun import rank_cases
from linpde_gp_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)
# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")

WORLDS = (1, 2, 4)
SPAWN_TIMEOUT = 300.0
FF_TOL = 3e-9


def _f32(a):
    """``a`` rounded to float32, as mode ff stores points and vectors."""
    return np.asarray(a).astype(np.float32).astype(np.float64)


def _spd(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def _kernels(pkg, diffops, apply, wendland):
    """The test kernels and priors, built alike in either package."""
    k = 2.0**2 * pkg.kernels.Matern((), nu=2.5, lengthscales=0.7)
    d2 = diffops.Derivative(2)
    kc = 1.5 * pkg.kernels.Matern((), nu=2.5, lengthscales=0.4)
    lap = -1.0 * diffops.Laplacian(())
    heat = pkg.GaussianProcess(pkg.functions.Zero((2,)), 1.3 * pkg.kernels.TensorProduct(
        pkg.kernels.Matern((), nu=1.5, lengthscales=2.5), pkg.kernels.Matern((), nu=2.5, lengthscales=2.0)))
    return dict(
        k=k,
        kk=apply(d2, apply(d2, k, argnum=1), argnum=0),
        kc=kc,
        kc_LL=apply(d2, apply(d2, kc, argnum=1), argnum=0),
        kc_L=apply(d2, kc, argnum=0),
        eq_prior=pkg.GaussianProcess(pkg.functions.Zero(()), 2.0**2 * pkg.kernels.ExpQuad((), lengthscales=1.0)),
        lap=lap,
        tp=1.7 * pkg.kernels.TensorProduct(pkg.kernels.Matern((), nu=1.5, lengthscales=0.8),
                                           pkg.kernels.Matern((), nu=2.5, lengthscales=1.1)),
        heat=heat,
        H=diffops.HeatOperator((2,), alpha=0.1),
        wendland=pkg.GaussianProcess(pkg.functions.Zero(()), 2.0 * wendland((), k=2, lengthscales=0.15)),
        m52=pkg.GaussianProcess(pkg.functions.Zero(()), 2.0 * pkg.kernels.Matern((), nu=2.5, lengthscales=0.6)),
        negative=pkg.GaussianProcess(pkg.functions.Zero(()), -1.0 * pkg.kernels.Matern((), nu=2.5, lengthscales=0.5)),
        ff_prior=pkg.GaussianProcess(pkg.functions.Zero(()), 2.0 * pkg.kernels.Matern((), nu=2.5, lengthscales=0.3)),
    )


PK = _kernels(lgt, lgt.diffops, apply_operator_to_kernel, WendlandCovarianceFunction)
JK = _kernels(jlgt, jdiffops, japply, JWendland)


def _data():
    rng = np.random.default_rng(11)
    d = {}
    d["X0"], d["X1"] = rng.uniform(-1, 1, 64), rng.uniform(-1, 1, 32)
    d["A"], d["b"], d["B"] = _spd(rng, 128), rng.standard_normal(128), rng.standard_normal((128, 5))
    d["B1"], d["D1"] = rng.standard_normal((128, 24)), _spd(rng, 24)
    d["B2"], d["D2"] = rng.standard_normal((152, 17)), _spd(rng, 17)
    d["b2"] = rng.standard_normal(169)
    d["Xc"] = np.linspace(-1, 1, 100)
    d["Xk"] = np.linspace(0.05, 0.95, 96)
    d["Xb"], d["Yb"] = np.array([0.0, 1.0]), np.array([0.3, -0.2])
    d["xq_k"] = np.linspace(0.0, 1.0, 41)
    d["Xp"] = np.linspace(-1, 1, 128)
    d["xq_p"] = np.linspace(-1, 1, 53)
    d["Xm0"], d["Xm1"] = rng.uniform(-1, 1, (203, 2)), rng.uniform(-1, 1, (117, 2))
    d["vm"] = rng.standard_normal(117)
    d["Xh"] = np.stack([rng.uniform(0, 5, 150), rng.uniform(-1, 1, 150)], -1)
    d["Yh"] = rng.standard_normal(150)
    d["xq_h"] = np.stack([rng.uniform(0, 5, 24), rng.uniform(-1, 1, 24)], -1)
    d["Xw"] = rng.uniform(0.0, 1.0, 420)
    d["xq_w"] = np.linspace(0.0, 1.0, 21)
    d["X0p"] = np.sort(rng.uniform(-1, 1, 96))
    d["xq_0p"] = np.linspace(-1, 1, 33)
    d["Xn"] = np.sort(rng.uniform(-1, 1, 256))
    # Points and values that float32 represents: mode ff stores them so.
    d["Xf"], d["Yf"] = _f32(rng.uniform(-1, 1, 400)), _f32(rng.standard_normal(400))
    return d


D = _data()
HEAT_KW = dict(noise_variance=1e-4, tol=1e-10, maxiter=3000, precond_rank=32)
WEND_KW = dict(noise_variance=1e-6, tol=1e-10, maxiter=1200, precond_rank=64)
RANK0_KW = dict(noise_variance=1e-6, tol=1e-12, maxiter=2000, precond_rank=0)
NEG_KW = dict(noise_variance=1e-4, tol=1e-8, maxiter=200, precond_rank=128)


def _cases():
    c = [("mesh", "mesh", dict(x=D["B"][:4 * 8])),
         ("gram", "sharded_gram", dict(kernel=PK["kk"], X0=D["X0"], X1=D["X1"]))]
    for layout in ("contiguous", "cyclic", "2d"):
        c.append((f"chol_{layout}", "cholesky", dict(A=D["A"], nb=16, layout=layout, b=D["b"], B=D["B"])))
    for unroll in (True, False):
        c.append((f"unroll_{unroll}", "cholesky", dict(A=D["A"], nb=16, layout="contiguous", unroll=unroll)))
    c.append(("factor", "chol_factor", dict(A=D["A"], nb=16, exts=[(D["B1"], D["D1"]), (D["B2"], D["D2"])],
                                            b=D["b2"])))
    for layout in ("auto", "contiguous"):
        c.append((f"condition_{layout}", "condition", dict(kernel=PK["k"], X=D["Xc"], Y=np.sin(3 * D["Xc"]),
                                                           noise=1e-2, nb=16, layout=layout)))
    c.append(("conditioner", "conditioner", dict(
        k_obs=PK["kc_LL"], X=D["Xk"], Y=np.sin(6 * D["Xk"]), batches=[([PK["kc_L"]], PK["kc"], D["Xb"], D["Yb"])],
        xq=D["xq_k"], prior_kernel=PK["kc"], cross_q=[PK["kc_L"], PK["kc"]], noise=1e-8, jitter=0.0, nb=24,
        qblock=16)))
    c.append(("posterior", "posterior", dict(prior=PK["eq_prior"], X=D["Xp"], Y=np.full(128, 2.0), L=PK["lap"],
                                             noise=1e-4, xq=D["xq_p"])))
    for mode in ("f64", "ff"):
        X0, X1, v = (_f32(D[k]) if mode == "ff" else D[k] for k in ("Xm0", "Xm1", "vm"))
        c.append((f"matvec_{mode}", "gram_matvec", dict(spec=kernel_term_specs(PK["tp"]), X0=X0, X1=X1, v=v,
                                                        mode=mode)))
    c.append(("heat", "iterative", dict(prior=PK["heat"], X=D["Xh"], Y=D["Yh"], xq=D["xq_h"],
                                        kw=dict(L=PK["H"], mode="f64", **HEAT_KW), var_block=16)))
    c.append(("wendland", "iterative", dict(prior=PK["wendland"], X=D["Xw"], Y=np.sin(7 * D["Xw"]), xq=D["xq_w"],
                                            kw=dict(mode="f64", **WEND_KW), var_block=16)))
    c.append(("rank0", "iterative", dict(prior=PK["m52"], X=D["X0p"], Y=np.sin(3 * D["X0p"]), xq=D["xq_0p"],
                                         kw=dict(mode="f64", **RANK0_KW))))
    c.append(("negative", "nystrom_indefinite", dict(prior=PK["negative"], X=D["Xn"], Y=np.sin(3 * D["Xn"]),
                                                     kw=dict(mode="f64", **NEG_KW))))
    c.append(("ff_sum", "ff_sum", dict(prior=PK["ff_prior"], X=D["Xf"], Y=D["Yf"], L=None,
                                       kw=dict(noise_variance=1e-4, tol=FF_TOL, maxiter=1000, precond_rank=64))))
    c.append(("dryrun", "dryrun", dict(nb=16, blocks_per_rank=4, n_it_per_rank=64, n_wendland=1024)))
    return c


def _jax_linalg(m4, m8) -> dict:
    """Factors, solves, the factor chain and the Gram (JAX package).  Its
    unrolled factorizations take seconds of XLA compile per block-column;
    the masked bodies (``unroll=False``) give the same factor, so the
    references take those, also inside its ``DistributedConditioner`` and
    ``distributed_condition``."""
    A = jnp.asarray(D["A"])
    r = {"gram": np.asarray(jpar.sharded_gram(JK["kk"], D["X0"], D["X1"], mesh=m8))}
    r["chol_contiguous"] = np.asarray(jpar.distributed_cholesky(A, mesh=m4, block_size=32, unroll=False))
    r["chol_2d"] = np.asarray(jpar.distributed_cholesky_2d(A, mesh=m4, block_size=32, jitter=0.0, unroll=False))
    L = jnp.asarray(r["chol_contiguous"])
    r["y"] = np.asarray(jpar.distributed_tri_solve(L, jnp.asarray(D["B"]), mesh=m4, block_size=32))
    r["yT"] = np.asarray(jpar.distributed_tri_solve(L, jnp.asarray(D["B"]), mesh=m4, block_size=32, transpose=True))
    r["x"] = np.asarray(jpar.distributed_chol_solve(L, jnp.asarray(D["b"]), mesh=m4, block_size=32))
    f = jpar.DistributedCholFactor(L, mesh=m4, block_size=32)
    f.extend(jnp.asarray(D["B1"]), jnp.asarray(D["D1"]))
    f.extend(jnp.asarray(D["B2"]), jnp.asarray(D["D2"]))
    r["factor"] = (np.asarray(f.solve(jnp.asarray(D["b2"]))), float(f.logdet()))
    return r


def _jax_conditioning(m4, m8) -> dict:
    r = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("distributed_cholesky", "distributed_cholesky_2d"):
            mp.setattr(jsolve, name, functools.partial(getattr(jsolve, name), unroll=False))
        r["condition"] = np.asarray(jpar.distributed_condition(JK["k"], D["Xc"], np.sin(3 * D["Xc"]), mesh=m4,
                                                               noise_variance=1e-2, block_size=32)[0])
        cond = jpar.DistributedConditioner(mesh=m4, block_size=32)
        w0 = cond.condition(JK["kc_LL"], D["Xk"], np.sin(6 * D["Xk"]), noise_variance=1e-8, jitter=0.0)
        w1 = cond.extend([JK["kc_L"]], JK["kc"], D["Xb"], D["Yb"], noise_variance=1e-8, jitter=0.0)
        mean, std = cond.posterior_eval([JK["kc_L"], JK["kc"]], JK["kc"], D["xq_k"], query_block_size=16)
    r["conditioner"] = (np.asarray(w0), np.asarray(w1), np.asarray(mean), np.asarray(std))
    post = JK["eq_prior"].condition_on_observations(
        np.full(128, 2.0), X=D["Xp"], L=JK["lap"],
        b=jlgt.models.randvars.Normal(np.zeros(128), 1e-4 * np.eye(128)))
    r["posterior"] = tuple(np.asarray(o) for o in jpar.sharded_posterior_eval(post, D["xq_p"], mesh=m4,
                                                                              with_std=True))
    for mode, f in (("f64", lambda a: a), ("ff", _f32)):
        r[f"matvec_{mode}"] = np.asarray(jpar.distributed_gram_matvec(jspecs(JK["tp"]), f(D["Xm0"]), f(D["Xm1"]),
                                                                      jnp.asarray(f(D["vm"])), mesh=m8))
    return r


def _jax_iterative(m4, m8) -> dict:
    r = {}
    reg = jpar.DistributedIterativeGPRegressor(JK["heat"], D["Xh"], D["Yh"], mesh=m8, L=JK["H"], **HEAT_KW)
    r["heat"] = (np.asarray(reg.representer_weights), np.asarray(reg.mean(jnp.asarray(D["xq_h"]))))
    reg = jpar.DistributedIterativeGPRegressor(JK["m52"], D["X0p"], np.sin(3 * D["X0p"]), mesh=m8, **RANK0_KW)
    r["rank0"] = np.asarray(reg.mean(jnp.asarray(D["xq_0p"])))
    return r


def _jax_iterative_2(m4, m8) -> dict:
    r = {}
    prev = jlgt.config.matvec_tile
    jlgt.config.set(matvec_tile=64)  # a band narrower than the 420 points, as tests/test_parallel.py
    try:
        reg = jpar.DistributedIterativeGPRegressor(JK["wendland"], D["Xw"], np.sin(7 * D["Xw"]), mesh=m8, **WEND_KW)
        assert reg._band_info() is not None
        r["wendland"] = (np.asarray(reg.representer_weights), np.asarray(reg.mean(jnp.asarray(D["xq_w"]))))
    finally:
        jlgt.config.set(matvec_tile=prev)
    reg = jpar.DistributedIterativeGPRegressor(JK["negative"], D["Xn"], np.sin(3 * D["Xn"]), mesh=m8, **NEG_KW)
    r["negative"] = np.asarray(reg.representer_weights)
    return r


def _jax_refs() -> dict:
    """The JAX package's results on the same inputs (its virtual CPU mesh),
    four groups in threads (XLA compiles outside the interpreter lock)."""
    m4, m8 = jpar.make_mesh(4), jpar.make_mesh(8)
    groups = (_jax_linalg, _jax_conditioning, _jax_iterative, _jax_iterative_2)
    with concurrent.futures.ThreadPoolExecutor(len(groups)) as pool:
        futures = [pool.submit(g, m4, m8) for g in groups]
        refs = {}
        for fut in futures:
            refs.update(fut.result())
    return refs


@pytest.fixture(scope="module")
def runs():
    """``(jax_refs, {world size: [rank results]})``: the worlds spawn in
    threads while the JAX references are computed here."""
    cases = _cases()
    worlds, errors = {}, {}

    def run(P):
        try:
            worlds[P] = spawn(rank_cases, P, (cases, {"matvec_tile": 64}), timeout=SPAWN_TIMEOUT)
        except BaseException as exc:  # noqa: BLE001 - re-raised by the tests that read it
            errors[P] = exc

    threads = [threading.Thread(target=run, args=(P,)) for P in WORLDS]
    for t in threads:
        t.start()
    try:
        refs = _jax_refs()
    finally:
        for t in threads:
            t.join(SPAWN_TIMEOUT + 30)
    assert not any(t.is_alive() for t in threads), "a world outlived its timeout"
    return refs, worlds, errors


def _ranks(runs, P):
    refs, worlds, errors = runs
    if P in errors:
        raise errors[P]
    return refs, worlds[P]


def _close(got, ref, rel, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)
    assert err <= rel, f"{what}: {err:.3e} > {rel:.0e}"


@pytest.mark.parametrize("P", WORLDS)
def test_ranks_agree_and_hold_no_jax(runs, P):
    """Every rank returns the same replicated results, bit for bit, and no
    rank imported JAX or the JAX package."""
    _, ranks = _ranks(runs, P)
    assert [r["world"] for r in ranks] == [P] * P
    assert all(r["jax_loaded"] == [] for r in ranks), ranks[0]["jax_loaded"]
    for key in ("chol_cyclic", "heat", "wendland", "conditioner", "posterior"):
        flat0 = np.concatenate([np.ravel(x) for x in _leaves(ranks[0][key])])
        for r in ranks[1:]:
            np.testing.assert_array_equal(np.concatenate([np.ravel(x) for x in _leaves(r[key])]), flat0)


def _leaves(x):
    if isinstance(x, dict):
        return [leaf for v in x.values() for leaf in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [np.asarray(x, np.float64)]


@pytest.mark.parametrize("P", WORLDS)
def test_mesh_layout_and_shardings(runs, P):
    """The mesh is rows-major and as square as possible (``make_mesh`` of the
    JAX package: 1 x 1, 1 x 2, 2 x 2); ``row_sharding`` splits rows in rank
    order, ``replicated`` hands every rank rank 0's array."""
    _, ranks = _ranks(runs, P)
    shape = list(jpar.make_mesh(P).devices.shape)
    x = D["B"][:32]
    for rank, r in enumerate(ranks):
        out = r["mesh"]
        assert out["shape"] == shape and out["coords"] == [rank // shape[1], rank % shape[1]]
        np.testing.assert_array_equal(out["rows"], x)
        np.testing.assert_array_equal(out["replicated"], x)


@pytest.mark.parametrize("P", WORLDS)
def test_sharded_gram(runs, P):
    refs, ranks = _ranks(runs, P)
    for r in ranks:
        _close(r["gram"], refs["gram"], 1e-12, "sharded_gram")


@pytest.mark.parametrize("layout", ["contiguous", "cyclic", "2d"])
@pytest.mark.parametrize("P", WORLDS)
def test_cholesky_layouts(runs, P, layout):
    """Each layout forced on its own: the factor against the JAX package's
    (its 2-D layout for the 2-D one, else its contiguous one: every layout
    of either package returns chol(A)) and numpy's, and the solves against
    the JAX package's."""
    refs, ranks = _ranks(runs, P)
    for r in ranks:
        out = r[f"chol_{layout}"]
        _close(out["L"], refs["chol_2d" if layout == "2d" else "chol_contiguous"], 1e-10, f"{layout} factor vs JAX")
        _close(out["L"], np.linalg.cholesky(D["A"]), 1e-10, f"{layout} factor vs numpy")
        _close(out["x"], refs["x"], 1e-10, f"{layout} chol_solve")
        _close(out["y"], refs["y"], 1e-10, f"{layout} tri_solve")
        _close(out["yT"], refs["yT"], 1e-10, f"{layout} tri_solve transpose")


@pytest.mark.parametrize("P", WORLDS)
def test_cholesky_unroll_both_ways(runs, P):
    _, ranks = _ranks(runs, P)
    for r in ranks:
        np.testing.assert_array_equal(r["unroll_True"]["L"], r["unroll_False"]["L"])
        _close(r["unroll_True"]["L"], np.linalg.cholesky(D["A"]), 1e-10, "unrolled factor")


@pytest.mark.parametrize("P", WORLDS)
def test_chol_factor_extend_solve_logdet(runs, P):
    refs, ranks = _ranks(runs, P)
    x_ref, logdet_ref = refs["factor"]
    A1 = np.block([[D["A"], D["B1"]], [D["B1"].T, D["D1"]]])
    A2 = np.block([[A1, D["B2"]], [D["B2"].T, D["D2"]]])
    for r in ranks:
        _close(r["factor"]["x"], x_ref, 1e-10, "extended solve vs JAX")
        _close(r["factor"]["x"], np.linalg.solve(A2, D["b2"]), 1e-10, "extended solve vs numpy")
        assert abs(float(r["factor"]["logdet"]) - logdet_ref) <= 1e-12 * abs(logdet_ref)


@pytest.mark.parametrize("layout", ["auto", "contiguous"])
@pytest.mark.parametrize("P", WORLDS)
def test_distributed_condition_with_padding(runs, P, layout):
    """n = 100 pads to a multiple of P * 16 (the JAX mesh of 8 pads it to 128)."""
    refs, ranks = _ranks(runs, P)
    for r in ranks:
        out = r[f"condition_{layout}"]
        assert out["n_pad"] == -(-100 // (16 * P)) * 16 * P
        _close(out["w"], refs["condition"], 1e-10, "distributed_condition weights")


@pytest.mark.parametrize("P", WORLDS)
def test_conditioner_two_batches_and_posterior_eval(runs, P):
    refs, ranks = _ranks(runs, P)
    w0, w1, mean, std = refs["conditioner"]
    for r in ranks:
        out = r["conditioner"]
        _close(out["w"][0], w0, 1e-9, "first batch weights")
        _close(out["w"][1], w1, 1e-9, "extended weights")
        _close(out["mean"], mean, 1e-10, "posterior_eval mean")
        _close(out["std"], std, 1e-8, "posterior_eval std")


@pytest.mark.parametrize("P", WORLDS)
def test_sharded_posterior_eval(runs, P):
    refs, ranks = _ranks(runs, P)
    mean, std = refs["posterior"]
    for r in ranks:
        _close(r["posterior"]["mean"], mean, 1e-10, "sharded mean")
        _close(r["posterior"]["std"], std, 1e-8, "sharded std")
        np.testing.assert_array_equal(r["posterior"]["mean_only"], r["posterior"]["mean"])


@pytest.mark.parametrize("mode", ["f64", "ff"])
@pytest.mark.parametrize("P", WORLDS)
def test_distributed_gram_matvec_gather_both_ways(runs, P, mode):
    """``gather=True`` on every rank, and ``gather=False`` slabs
    concatenated in rank order, against the JAX package (ff: on points and
    a vector float32 represents, the pair's ``hi + lo`` within ff
    accuracy)."""
    refs, ranks = _ranks(runs, P)
    rel = 1e-13 if mode == "f64" else 1e-12
    local = []
    for r in ranks:
        out = r[f"matvec_{mode}"]
        g, loc = out["gathered"], out["local"]
        if mode == "ff":
            g, loc = g[0] + g[1], loc[0] + loc[1]
        _close(g, refs[f"matvec_{mode}"], rel, "gathered")
        local.append(loc)
    _close(np.concatenate(local), refs[f"matvec_{mode}"], rel, "slabs")


@pytest.mark.parametrize("P", WORLDS)
def test_iterative_dense(runs, P):
    """The heat operator's prior: weights and mean against the JAX package,
    var against a dense float64 solve."""
    refs, ranks = _ranks(runs, P)
    w, mean = refs["heat"]
    k, H = PK["heat"].cov, PK["H"]
    k_obs = apply_operator_to_kernel(H, apply_operator_to_kernel(H, k, argnum=1), argnum=0)
    X, xq = torch.from_numpy(D["Xh"]), torch.from_numpy(D["xq_h"])
    K = gram_matrix(k_obs, X, None, "f64").numpy() + HEAT_KW["noise_variance"] * np.eye(len(X))
    U = gram_matrix(apply_operator_to_kernel(H, k, argnum=1), xq, X, "f64").numpy()
    var = k(xq).numpy() - np.sum(U.T * np.linalg.solve(K, U.T), 0)
    for r in ranks:
        out = r["heat"]
        assert out["info"][1] < 1e-9
        assert not out["banded"]
        _close(out["w"], w, 1e-6, "weights")
        _close(out["mean"], mean, 1e-6, "mean")
        np.testing.assert_allclose(out["var"], var, rtol=0, atol=1e-8)


@pytest.mark.parametrize("P", WORLDS)
def test_iterative_banded_wendland(runs, P):
    """The compactly supported prior sorts its points and runs each rank's
    banded schedule; weights and mean against JAX in the caller's order,
    var against a dense float64 solve."""
    refs, ranks = _ranks(runs, P)
    w, mean = refs["wendland"]
    X, xq = D["Xw"], D["xq_w"]
    k = PK["wendland"].cov
    K = gram_matrix(k, torch.from_numpy(X), None, "f64").numpy()
    Kq = gram_matrix(k, torch.from_numpy(xq), torch.from_numpy(X), "f64").numpy()
    var = 2.0 - np.sum(Kq.T * np.linalg.solve(K + 1e-6 * np.eye(len(X)), Kq.T), 0)
    for r in ranks:
        out = r["wendland"]
        assert out["banded"]
        _close(out["w"], w, 1e-6, "weights")
        _close(out["mean"], mean, 1e-6, "mean")
        np.testing.assert_allclose(out["var"], var, rtol=0, atol=1e-8)


@pytest.mark.parametrize("P", WORLDS)
def test_iterative_no_preconditioner(runs, P):
    refs, ranks = _ranks(runs, P)
    for r in ranks:
        _close(r["rank0"]["mean"], refs["rank0"], 1e-6, "mean at precond_rank=0")


@pytest.mark.parametrize("P", WORLDS)
def test_indefinite_prior_raises_where_jax_carries_nan(runs, P):
    """A prior scaled by -1: the JAX package's Nyström build picks a NaN
    factor and returns NaN weights; the port raises ``LinAlgError``."""
    refs, ranks = _ranks(runs, P)
    assert np.isnan(refs["negative"]).any()
    for r in ranks:
        assert r["negative"]["raised"] and r["negative"]["raised"].startswith("LinAlgError")


@pytest.mark.parametrize("P", WORLDS)
def test_ff_mesh_cg_reaches_what_a_float32_sum_cannot(runs, P):
    """Mode ff's mesh CG, fed both planes of K2's pair, reaches a true
    relres (recomputed in float64) of 10 tol at tol 3e-9; the same CG fed
    only the hi plane, the float32 matvec the JAX package sums, misses it."""
    _, ranks = _ranks(runs, P)
    for r in ranks:
        out = r["ff_sum"]
        assert out["ff"]["relres"] <= 10 * FF_TOL, out
        assert out["hi_only"]["relres"] > 10 * FF_TOL, out


@pytest.mark.parametrize("P", WORLDS)
def test_dryrun_multichip(runs, P):
    """``dryrun_multichip`` on the world: every stage against its dense
    float64 oracle (the gates raise inside the ranks)."""
    _, ranks = _ranks(runs, P)
    errs = ranks[0]["dryrun"]
    assert errs["world"] == P and errs["banded_ranks"] == P
    assert errs["weights"] < 1e-10 and errs["cholesky_2d"] < 1e-10
