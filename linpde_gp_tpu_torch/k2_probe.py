#!/usr/bin/env python3
"""Time K2 and the banded kernel per build variant, and count their SASS,
on one GPU.

    python3 linpde_gp_tpu_torch/k2_probe.py [--variants unroll=1,unroll=2,unroll=4] [--modes plain,f64,ff] [--out DIR]
    python3 linpde_gp_tpu_torch/k2_probe.py --wide [--variants source,depth=16,...] [--modes ...] [--out DIR]

A variant is the source (``source``) or a copy of ``csrc/`` with constants
of ``gram_eval.cuh`` replaced (:func:`patched_headers`; ``+`` joins
several), built from ``<out>/<variant>/csrc``:

- ``unroll=u``: the narrow route's pair loop unrolled ``u`` times in
  every mode (``kUnroll``; the source: 4 in plain and f64, 1 in ff);
- ``depth=d``: depth tiles of ``d`` columns on the multi-column route
  (``kMatmatDepth``; the source: 32);
- ``warps=w``: ``w`` warps a block there at every RW (8 or 16; the
  source: 8 at RW = 64, 16 from RW = 128);
- ``skip=eval`` (G = 1, no evaluation) and ``skip=mma`` (no MMAs): a
  diagnostic whose results are wrong; with both, V's staging alone.

Without ``--wide``, for each variant it builds the heat specs' module and
reports, per mode:

- K2's time on the heat benchmark's observation spec at N x N, r = 1, and
  on its cross spec at nq x N, r = 1 (the posterior mean): the mean of 3
  launches after a warm-up, CUDA events;
- registers and spills of the r = 1 instantiation (``ops/_cuda.ptxas_usage``);
- its SASS instructions per pair, by pipe (``cuobjdump -sass``): the pair
  loop, the largest loop with no loop inside, holds ``kUnroll`` iterations
  of ``kRows`` pairs each, so its count is divided by ``kUnroll kRows``.

With ``--wide`` (default variant ``source``) it builds the heat and the
1-D Wendland modules per variant and reports, per mode:

- K2 on the heat observation spec at N x N with r = 64, 128 and 256 (the
  multi-column route at RW = 64, 128 and 256), and the banded matvec on the
  Wendland experiment's data at N x N, r = 64 and 256: mean of 2 launches after
  a warm-up, CUDA events (mode ff with an ff pair right-hand side);
- the wrapper's float64 panel of V at N x 256 (``ops/_cuda.wide_panel``):
  mean of 3 after a warm-up;
- registers and spills of every ``gram_matmat_kernel`` and
  ``banded_matmat_kernel`` instantiation;
- their SASS, per module: DMMA, DFMA, LDS and LDGSTS in the whole
  function (beside K1's, which evaluates one pair a thread and has no
  product), and by pipe in the pair loop (the largest loop with no loop
  inside: one evaluated pair and the MMA k-steps issued beside it; the
  compiler may place the evaluation's code outside it).

It prints the card's name and power limit, a line per variant and mode,
and one JSON line, also written to ``<out>/k2_probe.json``
(``<out>/<variant>/k2_probe_wide.json`` with ``--wide``) beside the SASS
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
    "tensor": ("DMMA", "HMMA"),
    "fp32": ("FFMA", "FADD", "FMUL", "FSETP", "FMNMX", "FSEL", "FSET", "FCHK", "FRND"),
    "mufu": ("MUFU",),
    "convert": ("F2F", "F2I", "I2F", "F2FP", "I2FP", "F2IP"),
    "memory": ("LDS", "LDG", "LD", "STS", "STG", "ST", "LDC", "ULDC", "LDSM", "LDGSTS", "LDGDEPBAR", "DEPBAR"),
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


def per_pair(insns: list[tuple[int, str, str]], pairs_per_iteration: int, opcodes: tuple = ()) -> dict:
    """Instructions per pair by pipe in the pair loop: the largest loop (a
    backward branch ``[target, branch]``) with no loop inside; also per
    opcode for each of ``opcodes``."""
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
    out.update({op: sum(o == op for o in body) / pairs_per_iteration for op in opcodes})
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


def card_name() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"


def _patches(variant: str) -> list[tuple[str, str]]:
    """``(old, new)`` replacements in ``gram_eval.cuh`` for a variant."""
    out = []
    for item in variant.split("+"):
        key, _, value = item.partition("=")
        if key == "unroll":
            out += [(f"kUnroll = {u};", f"kUnroll = {int(value)};") for u in (4, 1)]
        elif key == "depth":
            out.append(("kMatmatDepth = 32;", f"kMatmatDepth = {int(value)};"))
        elif key == "warps":
            out.append(("kMatmatThreads = RW >= 128 ? 512 : 256;", f"kMatmatThreads = {32 * int(value)};"))
        elif item == "skip=eval":
            out.append(("return A::prod_of(eval_pair<S, A>(s, a, b));", "return 1.0;"))
        elif item == "skip=mma":
            out.append(("dmma_16x8x4(acc[mt][nt], af[mt][0], af[mt][1], b0);", "(void)b0;"))
        else:
            raise ValueError(f"unknown variant {item!r}")
    return out


def patched_headers(variant: str, out_dir: Path) -> Path:
    """The headers a variant builds from: ``csrc/`` itself for ``source``,
    else a copy in ``out_dir/csrc`` with its replacements, each of which
    must match exactly once."""
    from linpde_gp_tpu_torch.ops import _cuda

    if variant == "source":
        return _cuda.CSRC
    csrc = out_dir / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for path in _cuda.CSRC.glob("*.cuh"):
        (csrc / path.name).write_text(path.read_text())
    target = csrc / "gram_eval.cuh"
    source = text = target.read_text()
    for old, new in _patches(variant):
        if source.count(old) != 1:
            raise RuntimeError(f"variant {variant}: {old!r} is not in gram_eval.cuh exactly once")
        text = text.replace(old, new)
    target.write_text(text)
    return csrc


def wide_main(args, card: str) -> int:
    """The multi-column route: K2 at N x N, r in {64, 128, 256}, the banded
    matvec at r in {64, 256}, per variant and mode; registers, spills and
    SASS of the pair loop."""
    variants = {}
    for name in args.variants.split(","):
        print(f"== variant {name}", flush=True)
        out_dir = Path(args.out) / name.replace("=", "").replace("+", "_")
        variants[name] = wide_variant(args, card, patched_headers(name, out_dir), out_dir)
    print(json.dumps({"card": card, "variants": {k: v["modes"] for k, v in variants.items()}}))
    return 0


def wide_variant(args, card: str, csrc: Path, out_dir: Path) -> dict:
    """One build of the multi-column route: its timings, registers and SASS
    (also written to ``out_dir``)."""
    import torch

    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.ops.banded import make_banded_matvec
    from linpde_gp_tpu_torch.ops.gram import _collapse_terms, gram_matvec, gram_matvec_plain, kernel_term_specs
    from linpde_gp_tpu_torch.ops.kernels import WendlandCovarianceFunction
    from linpde_gp_tpu_torch.specs import load_specs

    spec = load_specs()["obs"]
    wspec = kernel_term_specs(2.0 * WendlandCovarianceFunction((), k=2, lengthscales=0.05))
    structures = {"heat": _cuda.structure_of(_collapse_terms(tuple(spec[1]))),
                  "wendland": _cuda.structure_of(_collapse_terms(tuple(wspec[1])))}
    builds = {b["key"]: b for b in _cuda.build_modules(list(structures.values()), csrc)}
    X, _ = bench_points(N, 0)
    rng = np.random.default_rng(0)  # the Wendland experiment's points (chip_smoke.py::wendland_data)
    W = np.sort(rng.uniform(0.0, 1.0, N))
    V_np = np.random.default_rng(5).standard_normal((N, 256))
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "n": N,
              "nvcc_flags": list(_cuda.NVCC_FLAGS), "headers": str(csrc),
              "modes": {}, "kernels": {}}
    sass_text = []
    ops = ("DMMA", "DFMA", "LDS", "LDGSTS")
    # Every module names its structure lgt::Structure: kernels are told apart by module.
    for label, st in structures.items():
        b = builds.get(st.key)
        if b is None:
            continue
        usage = _cuda.ptxas_usage(b["log"])
        for name, insns in sass_functions(Path(b["so"])).items():
            m = re.search(r"(gram|banded)_matmat_kernel<lgt::Structure, lgt::(\w+(?:<\w+>)?), "
                          r"(?:\(int\))?(\d+)>", name)
            k1 = re.search(r"gram_kernel<lgt::Structure, lgt::(\w+(?:<\w+>)?)>", name)
            if m:
                result["kernels"][f"{label} {m.group(1)} {_MODES[m.group(2)]} RW={m.group(3)}"] = {
                    "kernel": name.split("<")[0], "ptxas": usage.get(name),
                    "sass_pair_loop": per_pair(insns, 1, ops),
                    "sass_function": {op: sum(o == op for _, o, _ in insns) for op in ops}}
                sass_text.append(f"== {label}: {name}\n" + "\n".join(f"{a:06x} {op} {o}" for a, op, o in insns))
            elif k1:  # K1 evaluates one pair a thread: the evaluation's own count, for reference
                result["kernels"][f"{label} K1 {_MODES[k1.group(1)]}"] = {
                    "sass_function": {op: sum(o == op for _, o, _ in insns) for op in ops}}
    for key in sorted(result["kernels"]):
        k = result["kernels"][key]
        print(f"{key}: ptxas {k.get('ptxas')}; SASS in the function {k['sass_function']}; "
              f"in the pair loop {k.get('sass_pair_loop')}", flush=True)
    for mode in args.modes.split(","):
        dt = torch.float64 if mode == "f64" else torch.float32
        Xd = torch.tensor(X, device="cuda", dtype=dt)
        V = torch.tensor(V_np, device="cuda", dtype=dt)
        row = {}
        # A check at a small shape (ragged r included): the largest error
        # against the plain version, relative to its largest entry.
        for r in (48, 256):
            out = gram_matvec(spec, Xd[:1500], Xd[:2000], V[:2000, :r].contiguous(), mode)
            ref = gram_matvec_plain(spec, Xd[:1500], Xd[:2000], V[:2000, :r].contiguous(), mode)
            out, ref = (out[0], ref[0]) if mode == "ff" else (out, ref)
            row[f"check_r{r}_rel_err"] = ((out.double() - ref.double()).abs().max() / ref.abs().max()).item()
        for r in (64, 128, 256):
            Vr = V[:, :r].contiguous()
            rhs = (Vr, Vr * 1e-8) if mode == "ff" else Vr
            row[f"k2_r{r}_ms"] = mean_ms(lambda: gram_matvec(spec, Xd, Xd, rhs, mode), reps=2)
        Wd = torch.tensor(W, device="cuda", dtype=dt)
        mv = make_banded_matvec(wspec, Wd, Wd, mode=mode)
        for r in (64, 256):
            Vr = V[:, :r].contiguous()
            rhs = (Vr, Vr * 1e-8) if mode == "ff" else Vr
            row[f"banded_r{r}_ms"] = mean_ms(lambda: mv(rhs), reps=2)
        row["pair_fraction"] = mv.pair_fraction
        row["panel_r256_ms"] = mean_ms(lambda: _cuda.wide_panel(*rhs) if mode == "ff" else _cuda.wide_panel(rhs))
        result["modes"][mode] = row
        print(f"{mode:5s} K2 {N}x{N} r=64 {row['k2_r64_ms']:.3f} ms, r=128 {row['k2_r128_ms']:.3f} ms, "
              f"r=256 {row['k2_r256_ms']:.3f} ms; banded r=64 {row['banded_r64_ms']:.3f} ms, r=256 "
              f"{row['banded_r256_ms']:.3f} ms ({100 * mv.pair_fraction:.2f} % of pairs); vs plain at 1500x2000, "
              f"r=48 {row['check_r48_rel_err']:.3e}, r=256 {row['check_r256_rel_err']:.3e} of max; "
              f"f64 panel {N}x256 {row['panel_r256_ms']:.3f} ms", flush=True)
        del Xd, V, Wd, mv, rhs
        torch.cuda.empty_cache()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "k2_probe_wide_sass.txt").write_text("\n".join(sass_text))
    (out_dir / "k2_probe_wide.json").write_text(json.dumps(result, indent=1))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--wide", action="store_true", help="the multi-column route (r > 4) instead")
    ap.add_argument("--variants", default=None,
                    help="','-separated builds (default: unroll=1,unroll=2,unroll=4; with --wide: source)")
    ap.add_argument("--modes", default="plain,f64,ff")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    if args.variants is None:
        args.variants = "source" if args.wide else "unroll=1,unroll=2,unroll=4"
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

    import torch

    if not torch.cuda.is_available():
        print("k2_probe: needs a CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    print(card, flush=True)
    if args.wide:
        return wide_main(args, card)
    from linpde_gp_tpu_torch.ops import _cuda
    from linpde_gp_tpu_torch.ops.gram import _collapse_terms, gram_matvec
    from linpde_gp_tpu_torch.specs import load_specs

    specs = load_specs()
    structures = {st.key: st for st in (_cuda.structure_of(_collapse_terms(tuple(specs[k][1]))) for k in ("obs", "cross"))}
    X, Xq = bench_points(N, NQ)
    v_np = np.random.default_rng(2).standard_normal(N)
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "n": N, "nq": NQ,
              "nvcc_flags": list(_cuda.NVCC_FLAGS), "variants": {}}
    sass_text = []
    for variant in args.variants.split(","):
        csrc = patched_headers(variant, Path(args.out) / variant.replace("=", "").replace("+", "_"))
        builds = _cuda.build_modules(list(structures.values()), csrc)
        unroll = re.search(r"unroll=(\d+)", variant)
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
                    u = int(unroll.group(1)) if unroll else (1 if mode == "ff" else 4)  # kUnroll
                    rows_per_thread = 4 if mode == "plain" else 2  # kRows
                    row["sass_per_pair"] = per_pair(insns, u * rows_per_thread)
                    row["ptxas"] = usage.get(name)
                    sass_text.append(f"== {variant}: {name}\n" + "\n".join(f"{a:06x} {op} {o}" for a, op, o in insns))
            rows[mode] = row
            print(f"{variant} {mode:5s} K2 {N}x{N} r=1 {row['xx_r1_ms']:.3f} ms, mean {NQ}x{N} "
                  f"{row['qx_r1_ms']:.3f} ms; ptxas {row.get('ptxas')}; SASS per pair {row.get('sass_per_pair')}",
                  flush=True)
            del Xd, Qd, v
            torch.cuda.empty_cache()
        result["variants"][variant] = rows
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "k2_probe_sass.txt").write_text("\n".join(sass_text))
    (out_dir / "k2_probe.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({v: {m: {k: r[k] for k in ("xx_r1_ms", "qx_r1_ms")} for m, r in rows.items()}
                      for v, rows in result["variants"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
