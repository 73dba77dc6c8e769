#!/usr/bin/env python3
"""Time K2's narrow route (r <= 4) per unroll of its pair loop, and count
its SASS per pair, on one GPU.

    python3 linpde_gp_tpu_torch/k2_probe.py [--unroll 1,2,4] [--modes plain,f64,ff] [--out DIR]

For each unroll ``u`` of the loop over staged columns
(``-DLGT_PAIR_UNROLL=u``, ``csrc/gram_eval.cuh::matvec_rows``) it builds
the heat specs' module and reports, per mode:

- K2's time on the heat benchmark's observation spec at N x N, r = 1, and
  on its cross spec at nq x N, r = 1 (the posterior mean): the mean of 3
  launches after a warm-up, CUDA events;
- registers and spills of the r = 1 instantiation (``ops/_cuda.ptxas_usage``);
- its SASS instructions per pair, by pipe (``cuobjdump -sass``): the pair
  loop, the largest loop with no loop inside, holds ``u`` iterations of
  ``kRows`` pairs each, so its count is divided by ``u kRows``.

It prints the card's name and power limit, a line per unroll and mode,
and one JSON line, also written to ``<out>/k2_probe.json`` beside the SASS
of the probed kernels (``--out``, default ``build/k2_probe``).  It needs a
CUDA device and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

OUT_DIR = Path(__file__).resolve().parents[1] / "build" / "k2_probe"
N, NQ = 100_000, 8192  # the heat benchmark's points and queries
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)(\S*)\s*([^;]*);")
_PIPES = {
    "fp64": ("DFMA", "DADD", "DMUL", "DSETP", "DMNMX"),
    "fp32": ("FFMA", "FADD", "FMUL", "FSETP", "FMNMX", "FSEL", "FSET", "FCHK", "FRND"),
    "mufu": ("MUFU",),
    "convert": ("F2F", "F2I", "I2F", "F2FP", "I2FP", "F2IP"),
    "memory": ("LDS", "LDG", "LD", "STS", "STG", "ST", "LDC", "ULDC", "LDSM"),
    "control": ("BRA", "BRX", "EXIT", "BAR", "BSSY", "BSYNC", "WARPSYNC", "RET", "CALL", "JMP", "NOP"),
}
_MODES = {"PlainArith<float>": "plain", "PlainArith<double>": "f64", "FFArith": "ff"}


def sass_functions(so: Path) -> dict[str, list[tuple[int, str, str]]]:
    """``{demangled name: [(address, opcode, operands), ...]}`` of a library."""
    from linpde_gp_tpu_torch.ops import _cuda

    tool = _cuda.cuda_tool("cuobjdump")
    if tool is None:
        raise RuntimeError("cuobjdump not found")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True, check=True).stdout
    funcs: dict[str, list] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(4)))
    names = _cuda.demangle(list(funcs))
    return {names[k]: v for k, v in funcs.items()}


def per_pair(insns: list[tuple[int, str, str]], pairs_per_iteration: int) -> dict:
    """Instructions per pair by pipe in the pair loop: the largest loop (a
    backward branch ``[target, branch]``) with no loop inside."""
    loops = []
    for addr, op, operands in insns:
        m = re.search(r"0x([0-9a-f]+)", operands) if op == "BRA" else None
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [l for l in loops if not any(o != l and l[0] <= o[0] and o[1] <= l[1] for o in loops)]
    lo, hi = max(inner, key=lambda l: l[1] - l[0])
    body = [op for a, op, _ in insns if lo <= a <= hi]
    out = {pipe: sum(op in ops for op in body) / pairs_per_iteration for pipe, ops in _PIPES.items()}
    out["int_other"] = len(body) / pairs_per_iteration - sum(out.values())
    out["all"] = len(body) / pairs_per_iteration
    return out


def bench_points(n: int, nq: int):
    """The heat benchmark problem's points, drawn as bench.py draws them."""
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], axis=-1).astype(np.float32)
    rng.standard_normal(n)
    Xq = np.stack([rng.uniform(0.0, 5.0, nq), rng.uniform(-1.0, 1.0, nq)], axis=-1).astype(np.float32)
    return X, Xq


def mean_ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--unroll", default="1,2,4")
    ap.add_argument("--modes", default="plain,f64,ff")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

    import torch

    if not torch.cuda.is_available():
        print("k2_probe: needs a CUDA device", file=sys.stderr)
        return 2
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.ops.gram import _collapse_terms, gram_matvec
    from linpde_gp_tpu_torch.specs import load_specs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card, flush=True)
    specs = load_specs()
    structures = {st.key: st for st in (_cuda.structure_of(_collapse_terms(tuple(specs[k][1]))) for k in ("obs", "cross"))}
    X, Xq = bench_points(N, NQ)
    v_np = np.random.default_rng(2).standard_normal(N)
    base_flags = _cuda.NVCC_FLAGS
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "n": N, "nq": NQ,
              "nvcc_flags": list(base_flags), "unroll": {}}
    sass_text = []
    for u in (int(x) for x in args.unroll.split(",")):
        _cuda.NVCC_FLAGS = base_flags + (f"-DLGT_PAIR_UNROLL={u}",)
        _cuda._modules.clear()
        builds = _cuda.build_modules(list(structures.values()))
        usage, sass = {}, {}
        for b in builds:
            usage.update(_cuda.ptxas_usage(b["log"]))
            sass.update(sass_functions(Path(b["so"])))
        rows = {}
        for mode in args.modes.split(","):
            dt = torch.float64 if mode == "f64" else torch.float32
            Xd, Qd = (torch.tensor(a, device="cuda", dtype=dt) for a in (X, Xq))
            v = torch.tensor(v_np, device="cuda", dtype=dt)
            row = {"xx_r1_ms": mean_ms(lambda: gram_matvec(specs["obs"], Xd, Xd, v, mode)),
                   "qx_r1_ms": mean_ms(lambda: gram_matvec(specs["cross"], Qd, Xd, v, mode))}
            for name, insns in sass.items():
                m = re.search(r"gram_matvec_kernel<lgt::Structure, lgt::(\w+(?:<\w+>)?), (?:\(int\))?1>", name)
                if m and _MODES[m.group(1)] == mode:
                    rows_per_thread = 4 if mode == "plain" else 2
                    row["sass_per_pair"] = per_pair(insns, u * rows_per_thread)
                    row["ptxas"] = usage.get(name)
                    sass_text.append(f"== unroll {u}: {name}\n" + "\n".join(f"{a:06x} {op} {o}" for a, op, o in insns))
            rows[mode] = row
            print(f"unroll {u} {mode:5s} K2 {N}x{N} r=1 {row['xx_r1_ms']:.3f} ms, mean {NQ}x{N} "
                  f"{row['qx_r1_ms']:.3f} ms; ptxas {row.get('ptxas')}; SASS per pair {row.get('sass_per_pair')}",
                  flush=True)
            del Xd, Qd, v
            torch.cuda.empty_cache()
        result["unroll"][u] = rows
    _cuda.NVCC_FLAGS = base_flags
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "k2_probe_sass.txt").write_text("\n".join(sass_text))
    (out_dir / "k2_probe.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({u: {m: {k: r[k] for k in ("xx_r1_ms", "qx_r1_ms")} for m, r in rows.items()}
                      for u, rows in result["unroll"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
