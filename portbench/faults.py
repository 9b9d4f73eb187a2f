"""Faults planted under the timed path, for showing that the checks fail
runs that are broken underneath: a step that returns its state unchanged,
half of the batch left out (the mean over the rest), an answer altered
where it is made.  ``plant(mp)`` patches the program through ``mp``, a
``pytest.MonkeyPatch`` (``undo()`` takes it out).  No cell runs across
chips, so none can leave out an exchange between them.

    python3 portbench/faults.py --fault <name> --seconds <s> --seeds <n> [<n> ...]

runs the fault's cell with the fault planted, on a CUDA card, and prints
one JSON line a seed with the checks' numbers.
"""
import argparse
import json
import os
import sys
import time

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != _ROOT:
    sys.path.insert(0, _ROOT)


def _refine_unchanged(mp):
    from dynhor_tpu_torch.tracker import refine as RF

    orig = RF._refine_launch

    def launch(mesh, targets, rot, trans, dp, dc, cfg, state=None):
        res, ov, out = orig(mesh, targets, rot, trans, dp, dc, cfg, state)
        if state is None:
            rot6d = rot[..., :2].clone()
            t = trans.reshape(out.trans.shape).clone()
        else:
            rot6d, t = state.rot6d, state.trans
        return res._replace(rot6d=rot6d, translations=t), ov, out._replace(rot6d=rot6d, trans=t)

    mp.setattr(RF, "_refine_launch", launch)


def _refine_half(mp):
    from dynhor_tpu_torch.tracker import refine as RF

    orig = RF._frame_loss

    def frame_loss(*a, **k):
        loss, iou, ov = orig(*a, **k)
        keep = torch.arange(loss.shape[0], device=loss.device) < (loss.shape[0] + 1) // 2
        mean = loss[keep].mean()
        return torch.where(keep, loss, mean.detach()), iou, ov

    mp.setattr(RF, "_frame_loss", frame_loss)


def _refine_altered(mp):
    from dynhor_tpu_torch.tracker import refine as RF

    orig = RF._frame_loss

    def frame_loss(*a, **k):
        loss, iou, ov = orig(*a, **k)
        hit = torch.nn.functional.one_hot(torch.tensor(0, device=loss.device), loss.shape[0])
        return loss + hit * 0.05, iou, ov

    mp.setattr(RF, "_frame_loss", frame_loss)


def _prior_half(mp):
    from dynhor_tpu_torch.tracker import priors as P

    orig = P.prior_scores_batched

    def batched(*a, **k):
        out = orig(*a, **k)
        scores = out[0] if isinstance(out, tuple) else out
        half = scores.shape[1] // 2
        scores[:, half:] = scores[:, :half].mean(1, keepdim=True)
        return out

    mp.setattr(P, "prior_scores_batched", batched)


def _prior_altered(mp):
    from dynhor_tpu_torch.tracker import priors as P

    orig = P.prior_scores_two_stage

    def two_stage(*a, **k):
        out = orig(*a, **k)
        out[0, out[0].argmax()] += 0.05
        return out

    mp.setattr(P, "prior_scores_two_stage", two_stage)


def _neus_unchanged(mp):
    from dynhor_tpu_torch.neus import trainer as NT

    def apply_update(state, tcfg):
        state.step += 1

    mp.setattr(NT, "apply_update", apply_update)


def _neus_half(mp):
    from dynhor_tpu_torch.neus import trainer as NT

    orig = NT.sample_ray_batch

    def sample(key, data, n):
        out = orig(key, data, n)
        half = n // 2
        return tuple(None if x is None else torch.cat([x[:half], x[:n - half]]) for x in out)

    mp.setattr(NT, "sample_ray_batch", sample)


def _neus_altered(mp):
    from dynhor_tpu_torch.neus import trainer as NT

    orig = NT.make_train_step

    def make(rcfg, tcfg, ray_sharding=None):
        step = orig(rcfg, tcfg, ray_sharding)

        def altered(*a, **k):
            logs = step(*a, **k)
            return {**logs, "loss": logs["loss"] * 1.01}

        return altered

    mp.setattr(NT, "make_train_step", make)


FAULTS = {
    "refine-state-unchanged": ("track.refine16", _refine_unchanged),
    "refine-half-batch": ("track.refine16", _refine_half),
    "refine-answer-altered": ("track.refine16", _refine_altered),
    "prior-half-batch": ("track.prior6000", _prior_half),
    "prior-answer-altered": ("track.prior6000", _prior_altered),
    "neus-state-unchanged": ("neus.rays8192", _neus_unchanged),
    "neus-half-batch": ("neus.rays8192", _neus_half),
    "neus-answer-altered": ("neus.rays8192", _neus_altered),
}


def main(argv=None) -> int:
    import pytest

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the faults are read on a CUDA card", file=sys.stderr)
        return 2
    workload, plant = FAULTS[args.fault]
    cell = harness.find_cell(workload)
    for seed in args.seeds:
        mp = pytest.MonkeyPatch()
        plant(mp)
        try:
            r = harness.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                                 time.perf_counter(), log=lambda s: None)
        finally:
            mp.undo()
        print(json.dumps({"fault": args.fault, "seed": seed, "correct": r["correct"],
                          "checks": {k: v["value"] for k, v in r["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
