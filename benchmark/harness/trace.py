"""The device trace of a run's window: ``torch.profiler`` over the window,
read back from its Chrome trace, which is written once to a temporary file
and deleted.

What the readers take from it: the kernels by name with their device
intervals, the union of the device's busy intervals (kernels, copies, sets),
the window's bounds on the trace's clock (the ``bench.window`` span), and the
host spans and operators that were running during each idle gap.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

#: Kernels of the program (``linpde_gp_tpu_torch/csrc``): K1, K2's two routes
#: and its split sum, the banded matvec.
PROGRAM_KERNEL = re.compile(r"gram_kernel|gram_matvec_kernel|gram_matmat_kernel|matvec_reduce_kernel|banded_mat")
#: PyTorch's own element-wise, reduction, copy and indexing kernels.
TORCH_KERNEL = re.compile(r"at::native|at::cuda|c10::|\bvoid (?:at|c10)::")
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
WINDOW_SPAN = "bench.window"


@dataclass
class Trace:
    """The window's device activity, times in seconds from the window's start."""

    window_s: float
    kernels: list = field(default_factory=list)  # (name, start, dur)
    busy: list = field(default_factory=list)  # merged (start, end) of device activity
    host: list = field(default_factory=list)  # (name, start, dur, depth) host spans and operators

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def kernel_time(self, pattern: str) -> tuple[float, int]:
        """Seconds and launches of the kernels whose names match ``pattern``."""
        rx = re.compile(pattern)
        hits = [d for n, _, d in self.kernels if rx.search(n)]
        return sum(hits), len(hits)

    def dense_library_time(self) -> tuple[float, int]:
        """Seconds and launches of the kernels that are neither the
        program's nor PyTorch's own: cuBLAS and cuSOLVER (GEMM, TRSM, SYRK,
        POTRF)."""
        hits = [d for n, _, d in self.kernels if not PROGRAM_KERNEL.search(n) and not TORCH_KERNEL.search(n)]
        return sum(hits), len(hits)

    def top_kernels(self, k: int = 10) -> list:
        total: dict = {}
        for n, _, d in self.kernels:
            total[n] = total.get(n, 0.0) + d
        return sorted(([short(n), t] for n, t in total.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest idle gaps, each named by the innermost span of
        the benchmark and the innermost host operator running at its middle
        (``"python"`` where none was)."""
        edges = [0.0] + [x for iv in self.busy for x in iv] + [self.window_s]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [h[1] for h in self.host]
        out = []
        for s, e in gaps[:k]:
            mid = 0.5 * (s + e)
            inner = {True: ("", -1), False: ("python", -1)}  # the innermost bench span, operator
            for h in self.host[: bisect.bisect_right(starts, mid)]:
                own = h[0].startswith("bench.")
                if h[1] <= mid <= h[1] + h[2] and h[3] >= inner[own][1]:
                    inner[own] = (h[0], h[3])
            out.append(["/".join(x for x in (inner[True][0], inner[False][0]) if x), e - s])
        return out


def short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = re.sub(r"\(.*\)$", "", name)
    depth, out = 0, []
    for ch in name:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">" and depth > 0
    return re.sub(r"^void ", "", "".join(out)).strip()[:160]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def parse(events: list) -> Trace:
    """A :class:`Trace` from Chrome-trace events (``ts``/``dur`` in us)."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN
           and e.get("cat") in ("user_annotation", "cpu_op")]
    if not win:
        raise RuntimeError("the trace holds no window span")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    kernels, dev, host = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            lo, hi = max(s, t0), min(s + d, t1)
            if hi > lo:
                dev.append((lo - t0, hi - t0))
            if cat == "kernel" and t0 <= s <= t1:
                kernels.append((e["name"], (s - t0) * 1e-6, d * 1e-6))
        elif cat in ("user_annotation", "cpu_op", "cuda_runtime") and e["name"] != WINDOW_SPAN and t0 <= s <= t1:
            host.append((e["name"], s - t0, d))
    # Depth of a host event: how many others enclose it (innermost wins).
    host.sort(key=lambda h: (h[1], -h[2]))
    stack, nested = [], []
    for name, s, d in host:
        while stack and stack[-1] < s:
            stack.pop()
        nested.append((name, s * 1e-6, d * 1e-6, len(stack)))
        stack.append(s + d)
    busy = [(s * 1e-6, e * 1e-6) for s, e in _merge(dev)]
    return Trace(window_s=(t1 - t0) * 1e-6, kernels=kernels, busy=busy, host=nested)


class Profiler:
    """``torch.profiler`` around the window when ``on``; :attr:`trace`
    holds the parsed result after the ``with`` block."""

    def __init__(self, on: bool):
        self.on = on
        self.trace: Trace | None = None
        self._prof = None

    def __enter__(self):
        if self.on:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as fh:
                    self.trace = parse(json.load(fh)["traceEvents"])
            finally:
                os.unlink(path)
        self._prof = None
        return False


def span(name: str):
    """A host span in the trace (``record_function``); free when no
    profiler runs."""
    import torch

    return torch.profiler.record_function(name)

