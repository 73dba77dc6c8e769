"""Everything a run is made of, found by name: the manifest
(``BENCHMARK.json``), a cell's traffic file (``workloads/<cell>.json``), a
configuration (``configs/<name>.json``), its problem
(``problems/<problem>.py``), a metric's reader (``metrics/<metric>.py``) and a
loop (``loops/<loop>.py``).  Adding a cell, a configuration, a problem or a
metric adds files; no file here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def workload(name: str, bench: Path = BENCH) -> dict:
    return _json(Path(bench) / "workloads" / f"{name}.json")


def config(name: str, bench: Path = BENCH) -> dict:
    return _json(Path(bench) / "configs" / f"{name}.json")


def _module(path: Path, prefix: str):
    spec = importlib.util.spec_from_file_location(prefix + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench: Path = BENCH):
    """The module of ``metrics/<name>.py``: ``read(record) -> float | None``.
    Its unit, direction, source, layer, the metric it moves and its cells are
    its manifest entry's."""
    return _module(Path(bench) / "metrics" / f"{name}.py", "benchmark_metric_")


def loop(name: str):
    return importlib.import_module(f"benchmark.loops.{name}")


def problem(name: str, bench: Path = BENCH):
    """The module of ``problems/<name>.py``, named by a configuration's
    ``"problem"``: ``program(lgt, cfg, device) -> (prior, L)`` (the
    program's prior and observation operator), ``reference_kernels(cfg)``
    (the reference's forms ``k``, ``k_hs``, ``hk_hs`` and ``k_diag``),
    ``noise_variance(cfg)`` and, for anchored problems, ``anchors(cfg,
    device)``: the anchor sets ``[(x, y), ...]`` in the order they are
    conditioned on."""
    return _module(Path(bench) / "problems" / f"{name}.py", "benchmark_problem_")


def cell_entry(man: dict, cell: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in BENCHMARK.json")


def cell_metrics(man: dict, cell: str, traced: bool) -> list[dict]:
    """The manifest's metrics of ``cell``: its per-layer metrics in a traced
    run, its end-to-end metrics otherwise (those without ``workloads``
    belong to every cell)."""
    entries = man["per_layer"] if traced else man["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]
