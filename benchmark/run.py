"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for.  Prints, on earlier lines, the card's identity and limits; on standard
error, last, each compared number beside its limit; and as the last line of
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last.  Exits non-zero, and prints no result, without the cards,
or if JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every build and kernel cache inside the checkout, at fixed paths.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = os.path.join(ROOT, "build", _sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def _finite(x):
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import catalog, device as dev
    from benchmark.harness.imports import forbidden
    from benchmark.harness.runner import print_checks, run_cell

    chips = catalog.cell_entry(catalog.manifest(), args.workload)["chips"]
    import torch

    torch.set_num_threads(4)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    card = (f"card: {torch.cuda.get_device_name(0)}; devices {torch.cuda.device_count()}; "
            f"nvidia-smi name, power.limit, clocks.sm, clocks.max.sm: {dev.smi()}")
    print(card, flush=True)
    print(card, file=sys.stderr, flush=True)

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_process=T_PROCESS)
    bad = forbidden(sys.modules)
    if bad:
        print(f"error: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print_checks(result)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
