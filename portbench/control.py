"""The controls of the cells' checks: the reference, computed in the
precision below the one the configuration states, in the program's place,
judged as a run of the program is judged.  Not run by the benchmark's own
runs; the limits in the drivers sit below what this reads.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

prints one JSON line a seed: {"workload", "seed", "checks": {name: value}}.
"""
import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != _ROOT:
    sys.path.insert(0, _ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("the controls run on a CUDA card", file=sys.stderr)
        return 2
    drv = harness.load_driver(cell.traffic)
    for seed in args.seeds:
        checks = drv.control(cell.config, cell.traffic, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "checks": {n: v for n, v, _ in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
