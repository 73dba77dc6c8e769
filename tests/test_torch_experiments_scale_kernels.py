"""The port's scale experiments against the JAX package's scripts: the
dense scaling sweep, the Gram noise floor, the Wendland banded route and
the preconditioner spectroscopy, at small sizes on the CPU (see
``test_torch_experiments_scale_solve.py`` for the method)."""

import sys

import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import torch

import linpde_gp_tpu as jlgt
import linpde_gp_tpu_torch as lgt
from linpde_gp_tpu.ops import diffops as jdiffops
from linpde_gp_tpu.ops.pallas_gram import gram_matrix as jax_gram_matrix
from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel as jax_apply
from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.experiments import gram_noise_floor, precond_spectroscopy, scaling, wendland_banded
from linpde_gp_tpu_torch.experiments.common import heat_kernels, payload_mismatches

from test_torch_experiments_poisson import jax_script
from test_torch_experiments_scale_solve import last_json, run_jax

torch.set_num_threads(1)
config.set(device="cpu")


def test_scaling_payload_matches_the_jax_script(capsys):
    """The sweep's payload is timings; its sizes and keys match."""
    capsys.readouterr()
    jax_script("scaling_tpu").main((256, 512), reps=1)
    want = last_json(capsys.readouterr().out)
    got = scaling.main((256, 512), reps=1, device="cpu")
    assert got["mode"] == "f64"
    assert [set(r) for r in got["results"]] == [set(r) for r in want["results"]]
    assert payload_mismatches("scaling_tpu", got, want) == []


def test_scaling_stages_match_jax():
    """Each stage at n = 512, f64, on the same input as the JAX package's
    public ``gram_matrix``, ``jnp.linalg.cholesky`` and ``cho_solve``:
    within 1e-10 of the largest entry."""
    n = 512
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(0, 5, n), rng.uniform(-1, 1, n)], -1)
    y = rng.standard_normal(n)
    k = 1.0 * jlgt.kernels.TensorProduct(
        jlgt.kernels.Matern((), nu=1.5, lengthscales=2.5), jlgt.kernels.Matern((), nu=2.5, lengthscales=2.0)
    )
    H = jdiffops.HeatOperator((2,), alpha=0.1)
    G_j = np.asarray(jax_gram_matrix(jax_apply(H, jax_apply(H, k, argnum=1), argnum=0), jnp.asarray(X)))
    L_j = np.asarray(jnp.linalg.cholesky(jnp.asarray(G_j) + scaling.JITTER * jnp.eye(n)))
    w_j = np.asarray(jsl.cho_solve((jnp.asarray(L_j), True), jnp.asarray(y)))

    gram, chol, solve = scaling.stages(heat_kernels(lgt)[0], "f64")
    G = gram(torch.tensor(X)).numpy()
    L = chol(torch.tensor(G_j)).numpy()
    w = solve(torch.tensor(L_j), torch.tensor(y)).numpy()
    for got, want in ((G, G_j), (L, L_j), (w, w_j)):
        assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))


def test_noise_floor_matches_the_jax_script(capsys, monkeypatch):
    want = run_jax("gram_noise_floor", capsys, monkeypatch, {"NF_N": "256", "NF_THROUGHPUT_N": "512"})
    got = gram_noise_floor.main(device="cpu")
    assert payload_mismatches("gram_noise_floor", got, want) == []
    # ff's entries are the float32 roundings of the same accurate values.
    assert got["compensated"]["max_entry"] <= got["plain"]["max_entry"]


def test_wendland_banded_matches_the_jax_script(capsys, monkeypatch):
    """At n = 4096 both packages route banded; the port's schedule (a window
    per 128 rows) visits no larger a share of the column tiles than the
    JAX package's."""
    want = run_jax("wendland_banded_tpu", capsys, monkeypatch, {"WB_N": "4096"})
    got = wendland_banded.main(device="cpu")
    assert want["banded_routed"] and got["banded_routed"]
    assert 0 < got["pair_fraction"] <= got["band_fraction"] <= want["band_fraction"] < 1
    want.pop("band_fraction")
    assert payload_mismatches("wendland_banded", got, want) == []


def test_precond_spectroscopy_matches_the_jax_script(capsys, monkeypatch):
    argv = ["--n", "1024", "--ranks", "128,256"]
    monkeypatch.setattr(sys, "argv", ["precond_spectroscopy.py", *argv])
    capsys.readouterr()
    jax_script("precond_spectroscopy").main()
    want = [last_json(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    got = precond_spectroscopy.main(argv, device="cpu")
    assert [r["config"] for r in got] == [r["config"] for r in want]
    assert payload_mismatches("precond_spectroscopy", got, want) == []
