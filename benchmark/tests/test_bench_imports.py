"""The import check of ``run.py``, and what the reference may import."""

import ast
import subprocess
import sys

from benchmark.harness import catalog
from benchmark.harness.imports import forbidden


def test_forbidden_compares_whole_top_level_names():
    assert forbidden(["jax", "jax.numpy", "jaxlib.xla_client", "flax", "linpde_gp_tpu", "linpde_gp_tpu.ops"]) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla_client", "linpde_gp_tpu", "linpde_gp_tpu.ops"]
    assert forbidden(["linpde_gp_tpu_torch", "linpde_gp_tpu_torch.ops.gram", "jaxtyping", "torch", "numpy"]) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_reference_imports_nothing_of_the_program():
    for path in (catalog.BENCH / "reference").glob("*.py"):
        mods = list(_imports(path))
        assert not [m for m in mods if m.split(".")[0].startswith("linpde_gp_tpu") or m.startswith("..")], path


def test_no_source_of_the_benchmark_imports_jax():
    for path in catalog.BENCH.rglob("*.py"):
        assert not forbidden([m for m in _imports(path) if not m.startswith(".")]), path


def test_run_refuses_without_the_card_or_the_program(tmp_path):
    # Without a card run.py exits non-zero and prints no result line.
    out = subprocess.run([sys.executable, str(catalog.BENCH / "run.py"), "--workload", "ibvp.query", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and not out.stdout.strip().endswith("}")
