"""The program's spans (``lgt.*``, ``linpde_gp_tpu_torch/utils/profiling.py``)
on a run's device trace: what each span's work cost the device, and what the
device waited for while the host was in it.

Two readers of two forms of the trace:

- :func:`host_spans` and :func:`count_inside` read the window's
  :class:`~benchmark.harness.trace.Trace`, which keeps the host's spans
  and operators but not the link from a device operation to its launch.
  They count spans, which is what a per-layer reader can take from a run.
- :func:`from_events` reads the Chrome-trace events themselves into a
  :class:`SpanTrace`: each device operation (kernel, copy, set) with the
  host time of the call that launched it, found through the operation's
  ``args.correlation``.  An operation is charged to the spans open on the
  host at its launch, never to the span that holds its device interval:
  the device runs behind the host.

The two clocks.  Host events are on the host's clock, device operations on
the device's, mapped onto the host's by the profiler.  On the H100 machine
the two drift apart, by up to ~6,000 ppm, and step back together by
milliseconds, several times in one profiler session (PERF.md), so an
operation can read as starting milliseconds before its launch.  Charging needs no common clock (it matches
by correlation).  Idle time inside a host span does: a launch that meets an
idle device starts within microseconds, so the least launch-to-start lag in
each stretch of the window is the clocks' offset there; :func:`from_events`
interpolates that envelope, across its steps too, and moves each device
operation onto the host's clock by it.

Run on a cell (the program's span table for each cell, as JSON):

    python3 -m benchmark.harness.spans --workload heat.condition --seed 7 --seconds 51
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

from .trace import DEVICE_CATS, WINDOW_SPAN, _merge

#: The program's spans: every name starts with it.
PREFIX = "lgt."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: The offset's envelope: the least lag per bucket of this many seconds of
#: launch time, a bucket kept when its least lag lies at most ``SLACK``
#: seconds above the median of its ``NEIGHBOURS`` neighbours'.
BUCKET_S, NEIGHBOURS, SLACK = 0.05, 15, 20e-6
#: A change of the offset between two points of the envelope larger than
#: this (seconds) is a step, not drift: the drift moves it at most ~0.3 ms
#: in a bucket; the profiler's re-synchronizations step it by 2-13 ms.
STEP = 1e-3


# -- the accepted trace: spans only --------------------------------------------


def host_spans(tr, name: str) -> list[tuple[float, float]]:
    """``(start, end)`` of every host span ``name`` in the window, in
    seconds from its start, in order."""
    return [(s, s + d) for n, s, d, _ in tr.host if n == name]


def count_inside(tr, inner: str, outer: str) -> tuple[int, int]:
    """``(spans inner inside an outer span, outer spans)``."""
    outers = host_spans(tr, outer)
    return len(nested(host_spans(tr, inner), outers)), len(outers)


def nested(inner: list, outer: list) -> list:
    """The intervals of ``inner`` that lie inside one of ``outer`` (both
    sorted; the outer ones do not overlap)."""
    starts = [s for s, _ in outer]
    out = []
    for s, e in inner:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= outer[i][1]:
            out.append((s, e))
    return out


# -- the Chrome-trace events: operations charged by launch ---------------------


@dataclass(frozen=True)
class Op:
    name: str
    cat: str
    start: float  # on the host's clock, drift removed; seconds from the window's start
    dur: float
    launch: float  # the launching call's host time
    stack: tuple  # the program's spans open at the launch, outermost first
    lag: float  # start - launch before the drift was removed


@dataclass
class SpanTrace:
    """A window's device operations with their launches, and the host's
    program spans; times in seconds from the window's start, on the
    host's clock."""

    window_s: float
    ops: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)  # name -> [(start, end)]
    drift_ppm: float = 0.0  # the device clock's mean rate against the host's
    drift_fit_us: float = 0.0  # the widest gap of the envelope from the line at the mean rate
    unlaunched: int = 0  # device operations of the trace whose launch it lacks
    envelope: list = field(default_factory=list)  # (launch time, offset) points of the drift

    def charged(self, prefix: str = PREFIX, *, cats=DEVICE_CATS, pattern: str | None = None) -> dict:
        """``{span: (device seconds, operations)}``: each operation of
        ``cats`` (and, with ``pattern``, whose name matches it) charged to
        the innermost span starting ``prefix`` open at its launch; those
        launched outside every such span under ``None``."""
        rx = re.compile(pattern) if pattern else None
        out: dict = {}
        for op in self.ops:
            if op.cat not in cats or (rx and not rx.search(op.name)):
                continue
            key = next((n for n in reversed(op.stack) if n.startswith(prefix)), None)
            t, k = out.get(key, (0.0, 0))
            out[key] = (t + op.dur, k + 1)
        return out

    def inside(self, name: str, *, exclude=()) -> tuple[float, int]:
        """Device seconds and operations launched inside a span ``name``
        (its children's included) but inside none of ``exclude`` within it."""
        t, k = 0.0, 0
        for op in self.ops:
            if name not in op.stack:
                continue
            if any(x in op.stack[op.stack.index(name) + 1:] for x in exclude):
                continue
            t, k = t + op.dur, k + 1
        return t, k

    def count_inside(self, inner: str, outer: str) -> int:
        """Spans ``inner`` that lie inside a span ``outer``."""
        return len(nested(self.spans.get(inner, []), self.spans.get(outer, [])))

    def busy(self) -> list:
        """The merged intervals of device activity in the window."""
        return _merge((max(o.start, 0.0), min(o.start + o.dur, self.window_s)) for o in self.ops
                      if o.start + o.dur > 0.0 and o.start < self.window_s)

    def idle_within(self, names) -> float:
        """Seconds in which the device was idle while the host was inside
        one of the spans ``names`` (their union)."""
        return self.idle_in([iv for n in names for iv in self.spans.get(n, [])])

    def idle_in(self, intervals) -> float:
        """Seconds of the host's ``intervals`` (their union) in which the
        device was idle."""
        ivs = _merge((max(s, 0.0), min(e, self.window_s)) for s, e in intervals)
        busy = self.busy()
        starts = [b[0] for b in busy]
        idle = 0.0
        for s, e in ivs:
            covered = 0.0
            for bs, be in busy[max(bisect.bisect_right(starts, s) - 1, 0):]:
                if bs >= e:
                    break
                covered += max(0.0, min(be, e) - max(bs, s))
            idle += (e - s) - covered
        return idle

    def uncharged_share(self, prefix: str = PREFIX) -> float:
        """The share of the device's time launched outside every span
        starting ``prefix``."""
        total = sum(o.dur for o in self.ops)
        loose = sum(o.dur for o in self.ops if not any(n.startswith(prefix) for n in o.stack))
        return loose / total if total else 0.0

    def earliest_start_before_launch(self) -> float:
        """The most by which an operation starts before its launch once the
        drift is removed (seconds; negative: none does)."""
        return max((o.launch - o.start for o in self.ops), default=float("-inf"))


def _envelope(lags: list[tuple[float, float]]) -> tuple[float, float, list]:
    """The clocks' offset from ``(launch time, lag)`` pairs: ``(rate, widest
    gap, points)``.  Per :data:`BUCKET_S` of launch time the least lag is a
    candidate point; a candidate more than :data:`SLACK` above the median of
    its :data:`NEIGHBOURS` neighbours, drawn along their slope, is dropped
    (no launch of its bucket met an idle device).  ``rate``: the slope of
    the straight line through the points kept; ``widest gap``: the farthest
    a kept point lies from it (the steps)."""
    least: dict = {}
    for t, lag in lags:
        b = int(t // BUCKET_S)
        if b not in least or lag < least[b][1]:
            least[b] = (t, lag)
    pts = sorted(least.values())
    if len(pts) < 2:
        return 0.0, 0.0, pts

    def line(pts):
        n = len(pts)
        mt, ml = sum(t for t, _ in pts) / n, sum(lag for _, lag in pts) / n
        var = sum((t - mt) ** 2 for t, _ in pts)
        rate = sum((t - mt) * (lag - ml) for t, lag in pts) / var if var else 0.0
        return rate, ml - rate * mt

    h = NEIGHBOURS // 2
    kept = []
    for i, (t, lag) in enumerate(pts):
        near = pts[max(i - h, 0):i + h + 1]
        # The neighbours seen from t along their own slope (the median of
        # their successive slopes, which a step or an outlier hardly moves).
        slopes = sorted((b - a) / (u - s) for (s, a), (u, b) in zip(near, near[1:]))
        slope = slopes[len(slopes) // 2] if slopes else 0.0
        seen = sorted(x - slope * (u - t) for u, x in near)
        if lag <= seen[len(seen) // 2] + SLACK:
            kept.append((t, lag))
    rate, off = line(kept)
    return rate, max(abs(lag - (off + rate * t)) for t, lag in kept), kept


def _interp(t: float, xs: list, ys: list) -> float:
    """``ys`` at ``t``: linear between the points ``xs``, and beyond the
    first and the last on the slope of the segment there."""
    if len(xs) < 2:
        return ys[0] if ys else 0.0
    i = min(max(bisect.bisect_right(xs, t), 1), len(xs) - 1)
    return ys[i - 1] + (t - xs[i - 1]) * (ys[i] - ys[i - 1]) / (xs[i] - xs[i - 1])


def _offsets(times: list, lags: list, env: list) -> list:
    """The clocks' offset at each launch (``times`` sorted, with their
    ``lags``): the envelope interpolated; but between two of its points
    more than :data:`STEP` apart the profiler re-synchronized the clocks,
    so the offset holds the first point's value up to the step and the
    second's after it, the step placed where the lags show it (forward:
    after the last launch that lags less than the new offset; back: at the
    first that lags less than the old one)."""
    xs, ys = [t for t, _ in env], [lag for _, lag in env]
    out = [_interp(t, xs, ys) for t in times]
    for (ta, a), (tb, b) in zip(env, env[1:]):
        if abs(b - a) <= STEP:
            continue
        lo, hi = bisect.bisect_right(times, ta), bisect.bisect_left(times, tb)
        if b > a:
            below = [k for k in range(lo, hi) if lags[k] < b - SLACK]
            step = below[-1] + 1 if below else lo
        else:
            below = [k for k in range(lo, hi) if lags[k] < a - SLACK]
            step = below[0] if below else hi
        for k in range(lo, hi):
            out[k] = a if k < step else b
    return out


def from_events(events: list) -> SpanTrace:
    """A :class:`SpanTrace` of the window (the ``bench.window`` span) from
    Chrome-trace events (``ts``/``dur`` in us): the device operations whose
    launch lies in the window, and the program's spans that start in it."""
    X = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in X if e.get("name") == WINDOW_SPAN and e.get("cat") in ("user_annotation", "cpu_op")]
    if not win:
        raise RuntimeError("the trace holds no window span")
    t0, t1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    launches = {}
    for e in X:
        if e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
    spans: dict = {}
    marks = []  # (start, end, name) of the program's spans, for the launch sweep
    for e in X:
        if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX) and t0 <= float(e["ts"]) <= t1:
            s, d = float(e["ts"]), float(e["dur"])
            spans.setdefault(e["name"], []).append(((s - t0) * 1e-6, (s + d - t0) * 1e-6))
            marks.append((s, s + d, e["name"]))
    for ivs in spans.values():
        ivs.sort()
    raw, unlaunched = [], 0
    for e in X:
        if e.get("cat") not in DEVICE_CATS:
            continue
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is None:
            unlaunched += 1
        elif t0 <= launch <= t1:
            raw.append((launch, float(e["ts"]), float(e["dur"]), e["name"], e["cat"]))
    raw.sort()
    # The spans open at each launch, by one sweep over both in host order
    # (a thread's spans nest).
    marks.sort(key=lambda m: (m[0], -m[1]))
    stack: list = []
    key: tuple = ()
    i = 0
    window_s = (t1 - t0) * 1e-6
    times = [(r[0] - t0) * 1e-6 for r in raw]
    lags = [(r[1] - r[0]) * 1e-6 for r in raw]
    rate, fit, env = _envelope(list(zip(times, lags)))
    offsets = _offsets(times, lags, env)
    ops = []
    for (launch, start, dur, name, cat), t_launch, lag, offset in zip(raw, times, lags, offsets):
        changed = False
        while stack and stack[-1][1] < launch:
            stack.pop()
            changed = True
        while i < len(marks) and marks[i][0] <= launch:
            while stack and stack[-1][1] < marks[i][0]:
                stack.pop()
            if marks[i][1] >= launch:
                stack.append(marks[i])
            i += 1
            changed = True
        if changed:
            key = tuple(m[2] for m in stack)
        ops.append(Op(name, cat, t_launch + lag - offset, dur * 1e-6, t_launch, key, lag))
    return SpanTrace(window_s=window_s, ops=ops, spans=spans, drift_ppm=rate * 1e6, drift_fit_us=fit * 1e6,
                     unlaunched=unlaunched, envelope=env)


def report(st: SpanTrace, steps: int) -> dict:
    """The program's spans in a window of ``steps`` steps: per span its
    count and the device's time charged to it (innermost), the quantities
    the spans were placed for (each ``None`` where its spans are absent),
    the share of the device's time launched outside every span, and the
    clocks' drift."""
    from .trace import TORCH_KERNEL

    n = {k: len(v) for k, v in st.spans.items()}

    def per(value, count, scale=1.0):
        return value * scale / count if count else None

    build_s, _ = st.inside("lgt.nystrom.build")
    apply_s, _ = st.inside("lgt.nystrom.apply")
    solve_s, _ = st.inside("lgt.gp.var.solve")
    vector_s, _ = st.inside("lgt.pcg_block", exclude=("lgt.pcg.matvec", "lgt.nystrom.apply"))
    aux = st.charged("lgt.chol", cats=("gpu_memcpy", "gpu_memset"))
    aux_k = st.charged("lgt.chol", cats=("kernel",), pattern=TORCH_KERNEL.pattern)
    chol_aux_s = sum(t for k, (t, _) in list(aux.items()) + list(aux_k.items()) if k is not None)
    has_chol = any(k.startswith("lgt.chol") for k in n)
    query = ["lgt.gp.mean", "lgt.gp.var"]
    has_query = any(k in n for k in query)
    out = {
        "steps": steps,
        "spans": {k: {"count": n[k]} for k in sorted(n)},
        "metrics": {
            "nystrom_build_s": per(build_s, n.get("lgt.nystrom.build", 0)),
            "nystrom_apply_ms": per(apply_s, n.get("lgt.nystrom.apply", 0), 1e3),
            "cg_host_reads": per(st.count_inside("lgt.host_read", "lgt.pcg"),
                                 st.count_inside("lgt.pcg.matvec", "lgt.pcg")),
            "block_cg_vector_ms": per(vector_s, st.count_inside("lgt.pcg.matvec", "lgt.pcg_block"), 1e3),
            "chol_aux_ms": per(chol_aux_s, steps, 1e3) if has_chol else None,
            "std_solve_ms": per(solve_s, n.get("lgt.gp.var.solve", 0), 1e3),
            "gp_query.idle_ms": per(st.idle_within(query), steps, 1e3) if has_query else None,
        },
        "uncharged_share": st.uncharged_share(),
        "device_s": sum(o.dur for o in st.ops),
        "ops": len(st.ops),
        "unlaunched": st.unlaunched,
        "drift_ppm": st.drift_ppm,
        "drift_fit_us": st.drift_fit_us,
        "raw_earliest_before_launch_us": max((-o.lag for o in st.ops), default=0.0) * 1e6,
        "earliest_before_launch_us": st.earliest_start_before_launch() * 1e6,
    }
    for k, (t, c) in st.charged().items():
        if k is not None:
            out["spans"][k].update(charged_s=t, charged_ops=c)
    if has_query:
        # gp_query.idle_ms split: each span's idle time less its children's.
        cross = st.spans.get("lgt.gp.crosscov", [])
        cross_in = {k: st.idle_in(nested(cross, st.spans.get(k, []))) for k in query}
        out["gp_query_idle_split_ms"] = {
            "lgt.gp.crosscov": per(st.idle_in(cross), steps, 1e3),
            "lgt.gp.var.solve": per(st.idle_within(["lgt.gp.var.solve"]), steps, 1e3),
            "lgt.gp.var": per(st.idle_within(["lgt.gp.var"]) - st.idle_within(["lgt.gp.var.solve"])
                              - cross_in["lgt.gp.var"], steps, 1e3),
            "lgt.gp.mean": per(st.idle_within(["lgt.gp.mean"]) - cross_in["lgt.gp.mean"], steps, 1e3),
        }
    return out


def run_and_read(cell: str, seed: int, seconds: float, **kw) -> tuple[dict, SpanTrace]:
    """One traced run of ``cell`` (:func:`~benchmark.harness.runner.run_cell`)
    and its window's :class:`SpanTrace`, from the events the run's
    profiler exported."""
    import time

    from . import runner, trace

    kept = {}
    parse = trace.parse

    def keep(events):
        kept["events"] = events
        return parse(events)

    trace.parse = keep
    try:
        result = runner.run_cell(cell, seed, seconds, True, t_process=time.perf_counter(), **kw)
    finally:
        trace.parse = parse
    return result, from_events(kept.pop("events"))


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    result, st = run_and_read(args.workload, args.seed, args.seconds)
    line = {"workload": args.workload, "seed": args.seed, "correct": result["correct"],
            "metrics": {k: m["value"] for k, m in result["metrics"].items()}, "device": result["device"],
            **report(st, result["attempted"])}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
