"""The readings that the limits of ``correct`` are set from, at a cell's own
size, in one process: the program on each of ``--seeds`` and the control (the
configuration's next lower precision in the program's place: the program in
mode ``plain`` for the gram-free cells, the reference in float32 for the
dense ones) on each of ``--control-seeds``.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 101,102,103 \
        [--seconds S] [--out <directory>]

Each run is the benchmark's own (``harness.runner.run_cell``) with a short
window; one JSON line per run goes to standard output and, with ``--out``, to
``<out>/<cell>.jsonl``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness.runner import run_cell

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    out = None
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        out = open(os.path.join(args.out, f"{args.workload}.jsonl"), "a")
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t = time.perf_counter()
        r = run_cell(args.workload, seed, args.seconds, False, t_process=t, control=control)
        line = json.dumps({"workload": args.workload, "seed": seed, "control": control, "attempted": r["attempted"],
                           "correct": r["correct"], "checks": r["checks"], "metrics": r["metrics"],
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
