"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the result line.

The window is a closed loop of the cell's steps: every step that begins
before ``seconds`` have passed runs to its end, and the window ends with the
last step.  A rate or a time per step divides all the window's work by all
its time.  With ``trace`` the window runs under ``torch.profiler`` and the
cell's per-layer metrics are read from it; without, its end-to-end metrics.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field

from . import catalog, device as dev
from .loop import Context
from .trace import WINDOW_SPAN, Profiler, span


@dataclass
class Record:
    """What the metric readers read."""

    cell: str
    cfg: dict
    wl: dict
    mode: str
    setup_s: float
    window_s: float
    steps: list = field(default_factory=list)  # {"start", "end", **the loop's step record}
    trace: object = None  # trace.Trace in a traced run


def run_cell(cell: str, seed: int, seconds: float, traced: bool, *, t_process: float, device=None,
             control: bool = False, sizes: dict | None = None) -> dict:
    """Run ``cell`` once and return its result (the line's keys, with
    ``checks`` last).  ``device``: the card unless a rehearsal or a test
    names the CPU; ``control``: the control in the program's place
    (``calibrate.py``); ``sizes``: overrides of the cell's sizes (tests)."""
    import torch

    import linpde_gp_tpu_torch as lgt

    man = catalog.manifest()
    wl = catalog.workload(cell)
    cfg = catalog.config(wl["config"])
    device = torch.device("cuda" if device is None else device)
    ctx = Context(cell=cell, cfg=cfg, wl=wl, seed=seed, device=device, lgt=lgt, control=control,
                  sizes=dict(sizes or {}))
    loop = catalog.loop(wl["loop"]).Loop(ctx)
    loop.setup()
    dev.sync(device)

    steps = []
    with Profiler(traced) as prof:
        with span(WINDOW_SPAN):
            t0 = time.perf_counter()
            setup_s = t0 - t_process
            i = 0
            while not steps or time.perf_counter() - t0 < seconds:
                s = time.perf_counter() - t0
                info = loop.step(i)
                steps.append(dict(start=s, end=time.perf_counter() - t0, **info))
                i += 1
    window_s = steps[-1]["end"]
    peak = dev.peak_bytes(device)
    rec = Record(cell=cell, cfg=cfg, wl=wl, mode=loop.mode, setup_s=setup_s, window_s=window_s,
                 steps=steps, trace=prof.trace)

    metrics = {}
    for entry in catalog.cell_metrics(man, cell, traced):
        value = catalog.reader(entry["name"]).read(rec)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}

    checks = loop.check(len(steps))
    failed = sum(1 for v, lim in checks.values() if not (math.isfinite(v) and v <= lim))
    result = {"correct": failed == 0, "attempted": len(steps), "failed": failed, "metrics": metrics,
              "device": dict(dev.identity(device), memory_peak_bytes=peak)}
    if traced:
        tr = prof.trace
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_kernels(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def print_checks(result: dict) -> None:
    """The compared numbers beside their limits, as the last lines on stderr."""
    for k, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
