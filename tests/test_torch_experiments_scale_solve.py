"""The port's scale experiments (``linpde_gp_tpu_torch/experiments``)
against the JAX package's scripts: the anchored heat IBVP, grid mode and
the posterior variance, at small sizes on the CPU in float64.

Each case sets the JAX script's environment variables (small sizes; the
rest at its CPU branch's defaults), runs the JAX script from
``experiments/`` and parses its JSON line, runs the port's ``main`` on the
CPU under the same variables, and compares the payloads key by key
(``experiments.common.payload_mismatches``: relative 1e-6, CG iterations
within 2, round-off metrics at their floors; times and the backend are not
compared).  The kernel-level experiments are in
``test_torch_experiments_scale_kernels.py``, so that each file stays short.
"""

import json

import pytest
import torch

from linpde_gp_tpu_torch.config import config
from linpde_gp_tpu_torch.experiments import gram_noise_floor, grid_mode, large_scale, variance, wendland_banded
from linpde_gp_tpu_torch.experiments.common import DROPPED_KNOBS, payload_mismatches

from test_torch_experiments_poisson import jax_script

torch.set_num_threads(1)
config.set(device="cpu")


def last_json(text: str):
    """The last line of ``text`` that holds a JSON object."""
    return json.loads([line for line in text.splitlines() if line.startswith("{")][-1])


def run_jax(script, capsys, monkeypatch, env, jax_env=None):
    """The payload of the JAX script ``experiments/<script>.py`` under
    ``env`` and ``jax_env``; ``jax_env`` is unset again afterwards."""
    for key, value in {**env, **(jax_env or {})}.items():
        monkeypatch.setenv(key, value)
    capsys.readouterr()
    jax_script(script).main()
    payload = last_json(capsys.readouterr().out)
    for key in jax_env or {}:
        monkeypatch.delenv(key)
    return payload


# The port has one Nystrom build, the JAX package's on-device build
# (``precond_build="device"``); the JAX scripts' CPU branches take the legacy
# build unless ``LS_BUILD`` / ``GM_BUILD`` names it (on the grid their
# preconditioners differ: 301 iterations against 279).  The port raises on
# those knobs, so they are set for the JAX run only.
CASES = [
    ("large_scale_tpu", large_scale, {"LS_N": "512"}, {"LS_BUILD": "device"}),
    ("grid_mode_tpu", grid_mode, {"GM_NT": "24", "GM_NX": "16"}, {"GM_BUILD": "device"}),
    ("variance_tpu", variance, {"VT_N": "512"}, {}),
]


@pytest.mark.parametrize("script,module,env,jax_env", CASES, ids=[c[0] for c in CASES])
def test_payload_matches_the_jax_script(script, module, env, jax_env, capsys, monkeypatch):
    want = run_jax(script, capsys, monkeypatch, env, jax_env)
    got = module.main(device="cpu")
    assert got["mode"] == "f64" and got["backend"] == "cpu"
    assert set(want) <= set(got)
    assert payload_mismatches(want["experiment"], got, want) == []
    assert last_json(capsys.readouterr().out) == json.loads(json.dumps(got))


KNOBS = {
    "LS_HOST_CG": large_scale, "LS_DEVICE_CG": large_scale, "LS_BUILD": large_scale,
    "GM_DEVICE_CG": grid_mode, "GM_BUILD": grid_mode,
    "WB_HOST_CG": wendland_banded, "WB_TILE0": wendland_banded, "WB_TILE1": wendland_banded,
    "NF_TILE": gram_noise_floor,
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_dropped_knob_raises(knob, monkeypatch):
    """A JAX knob that selects a path or tile the port does not carry
    raises, naming itself, rather than run another path."""
    assert set(KNOBS) == set(DROPPED_KNOBS)
    monkeypatch.setenv(knob, "1")
    with pytest.raises(ValueError, match=knob):
        KNOBS[knob].main(device="cpu")


def test_scripts_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without ``device=`` and without ``config.device`` a script resolves
    the card, and raises where there is none."""
    monkeypatch.setattr(config, "device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        variance.main()


def test_the_card_branch_takes_the_tpu_settings(monkeypatch):
    """``branch="card"`` reads the JAX script's TPU-branch defaults (the
    sizes asked for here stay small) and its chip mode, on any device."""
    for key, value in {"VT_N": "64", "VT_NQ": "8", "VT_BS": "4", "VT_RANK": "16"}.items():
        monkeypatch.setenv(key, value)
    got = variance.main(device="cpu", branch="card")
    assert got["mode"] == "ff" and got["rank"] == 16 and got["block_size"] == 4
    assert got["std_range"][0] > 0


def test_payload_mismatches_rules():
    """Times are not compared, iterations within 2 (or ``iter_rtol`` of the
    count), nested numbers at relative 1e-6 or their floor, strings and
    booleans exactly, and a missing key is reported."""
    want = {"experiment": "wendland_banded", "pcg_iters": 100, "speedup_x": 9.0, "banded_routed": True,
            "agreement_rel_err": 1e-15, "nested": {"a": [1.0, 2.0]}}
    close = dict(want, pcg_iters=102, speedup_x=1.0, agreement_rel_err=5e-14, nested={"a": [1.0, 2.0 + 1e-6]})
    assert payload_mismatches("wendland_banded", close, want) == []
    far = dict(want, pcg_iters=104, banded_routed=False, agreement_rel_err=1e-12, nested={"a": [1.0, 2.1]})
    assert len(payload_mismatches("wendland_banded", far, want)) == 4
    assert payload_mismatches("wendland_banded", dict(want, pcg_iters=104), want, iter_rtol=0.05) == []
    assert payload_mismatches("wendland_banded", {"experiment": "wendland_banded"}, want)[0].endswith("missing")
