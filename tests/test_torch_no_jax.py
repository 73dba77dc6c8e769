"""The PyTorch port never imports JAX.

``linpde_gp_tpu_torch`` runs on machines without JAX (the GPU machine
has none), so importing any of its modules must succeed with ``jax``
blocked, and no source file of the port or of ``chip_smoke.py`` may
hold an import of it.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "linpde_gp_tpu_torch")

_MODULES = [
    "linpde_gp_tpu_torch",
    "linpde_gp_tpu_torch.config",
    "linpde_gp_tpu_torch.specs",
    "linpde_gp_tpu_torch.ops.ff",
    "linpde_gp_tpu_torch.ops.gram",
    "linpde_gp_tpu_torch.ops._cuda",
    "linpde_gp_tpu_torch.ops.linalg.chol",
    "linpde_gp_tpu_torch.ops.linalg.pcg",
    "linpde_gp_tpu_torch.models.iterative",
]


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        + "".join(f"import {m}\n" for m in _MODULES)
        + "from linpde_gp_tpu_torch.specs import load_specs\n"
        "load_specs()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'linpde_gp_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_statement(path):
    with open(path) as fh:
        src = fh.read()
    pattern = r"^\s*(import\s+(jax|jaxlib|linpde_gp_tpu)\b|from\s+(jax|jaxlib|linpde_gp_tpu)\b)"
    assert not re.findall(pattern, src, flags=re.M)
