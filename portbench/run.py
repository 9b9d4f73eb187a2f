"""Run one cell of the benchmark of the PyTorch/CUDA port on this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the check lines on standard error and
the result as one JSON object, the last line of standard output.  Exits
non-zero, printing no result, without a CUDA card or with fewer cards than
the cell asks for, or when JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The program's build and kernel caches stay in the checkout, at fixed paths.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_ROOT, "build", "triton")
if sys.path[0] != _ROOT:
    sys.path.insert(0, _ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {cell.name} needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T0,
                              log=lambda s: print(s, file=sys.stderr, flush=True))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
