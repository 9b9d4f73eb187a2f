"""Run phases of ``chip_smoke.py`` from two checkouts in turns, on one card.

    python -m dynhor_tpu_torch.tools.in_turns A_DIR B_DIR [--phases f32-refine,priors]
        [--order ABBA] [--out build/in_turns]

Each turn is a process of its own, started in that checkout's directory, so
it builds and imports that checkout's kernels and ``chip_smoke.py``; the
turns follow ``--order`` (A, B, B, A by default), so that both sides see the
card in the same states.  A turn runs the checkout's phase functions, whose
signatures both sides share:

- ``f32-refine``: ``phase_main`` on the phase-2 scene, ``attn_impl="flash"``,
  the ViT in f32, 2 steps (the f32 K5 kernels);
- ``priors``: ``phase_priors`` with ``attn_impl="flash"`` (6,000 views
  scored in two stages, gating, autodepth, a chained refine, and the
  per-chunk breakdown; K3 and K5's forward).

Each turn's output goes to ``<out>/<n>_<A|B>.log``; the lines that carry
the phases' numbers are printed, prefixed by the turn.  Exits 1 if a turn
fails.  Needs a CUDA card (the phases fail without one).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

_TURN = r"""
import sys, torch
import chip_smoke as cs
from dynhor_tpu_torch.models.dino import DinoConfig

if not torch.cuda.is_available():
    cs.fail("no CUDA device")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
smi = cs.phase_build()
flash = DinoConfig(attn_impl="flash")
for phase in sys.argv[1].split(","):
    if phase == "f32-refine":
        cs.phase_main(dev, cs.scene(dev), smi, [], flash, "float32", steps=2)
    elif phase == "priors":
        cs.phase_priors(dev, smi, [], flash)
    else:
        cs.fail(f"unknown phase {phase}")
"""

# Lines of a turn's output that carry the numbers.
_KEEP = ("refine_poses fine", "[breakdown", "[priors] scoring", "[priors-breakdown]",
         "[priors] selected", "[priors] wall time")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a_dir")
    ap.add_argument("b_dir")
    ap.add_argument("--phases", default="f32-refine,priors")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default=os.path.join("build", "in_turns"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    dirs = {"A": os.path.abspath(args.a_dir), "B": os.path.abspath(args.b_dir)}
    failed = False
    for n, side in enumerate(args.order, 1):
        log = os.path.join(args.out, f"{n}_{side}.log")
        with open(log, "w") as f:
            rc = subprocess.run(
                [sys.executable, "-c", _TURN, args.phases], cwd=dirs[side],
                stdout=f, stderr=subprocess.STDOUT, env={**os.environ, "PYTHONPATH": dirs[side]},
            ).returncode
        with open(log) as f:
            for line in f:
                if any(k in line for k in _KEEP):
                    print(f"[turn {n} {side}] {line.rstrip()}", flush=True)
        print(f"[turn {n} {side}] {dirs[side]}: exit {rc} (log {log})", flush=True)
        failed |= rc != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
