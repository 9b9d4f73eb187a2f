"""One rank of a gloo process group on the CPU, for tests/test_torch_parallel.py
and tests/test_torch_multihost.py: it runs the port's sharded paths on the
cases of a pickled input file and pickles what it computed, one file a rank.
The test process compares the files with one process and with the JAX
package; this process imports no JAX (``sys.modules["jax"] = None``).

    python tests/torch_dist_worker.py --rank R --world N --rendezvous file:///dir/rdv \\
        --inputs in.pkl --out out_R.pkl --cases mesh,refine,...
"""
from __future__ import annotations

import argparse
import hashlib
import os
import pickle
import sys
import time
import traceback
import warnings

sys.modules["jax"] = None  # any import of JAX raises
sys.modules["dynhor_tpu"] = None
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from dynhor_tpu_torch.parallel import mesh as PM  # noqa: E402
from dynhor_tpu_torch.parallel import multihost as MH  # noqa: E402


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _digest(tree) -> str:
    h = hashlib.sha256()

    def add(x):
        h.update(_np(x).tobytes())
        return x

    PM._leaves_map(add, tree)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Cases: each takes the inputs and returns a dict of arrays (or strings)
# ---------------------------------------------------------------------------

def case_mesh(inp):
    rank, n = PM.world()
    mesh = PM.make_mesh(axis_name="frames")
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loc = PM.shard_leading({"a": x, "b": torch.ones(()), "c": torch.ones((5, 2)),
                                "d": np.arange(8)}, mesh)
    out = {"a": _np(loc["a"]), "b": _np(loc["b"]), "c": _np(loc["c"]), "d": loc["d"],
           "warnings": np.array([str(w.message) for w in caught])}
    # Uneven slices, bool and int leaves through the sum-of-zeros gather.
    rows = torch.arange(rank * 10, rank * 10 + 3 - rank, dtype=torch.float32)[:, None]
    g = PM.gather_leading({"f": rows, "b": rows > 10, "i": rows.long()}, mesh)
    out.update(gather_f=_np(g["f"]), gather_b=_np(g["b"]), gather_i=_np(g["i"]),
               gather_whole=_np(PM.gather_leading(loc["a"], mesh)))
    rep = PM.replicate({"t": torch.full((3,), float(rank + 1)), "n": torch.full((2,), rank + 1),
                        "b": torch.full((2,), rank == 0)}, mesh)
    out.update(rep_t=_np(rep["t"]), rep_n=_np(rep["n"]), rep_b=_np(rep["b"]),
               max=_np(PM.all_reduce(torch.tensor(rank + 1), mesh, op="max")),
               sum=_np(PM.all_reduce(torch.tensor(rank + 1.0), mesh)))
    padded, size = PM.pad_to_multiple(torch.arange(5), 4)
    out.update(pad=_np(padded), pad_size=np.array(size))
    # halo_prev: the previous rank's last row forward; its gradient back.
    xg = x.clone().requires_grad_(True)
    local = PM.shard_leading(xg, mesh)
    h = PM.halo_prev(local, mesh)
    (h * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    out.update(halo=_np(h), halo_grad=_np(xg.grad))
    return out


def _refine_inputs(inp):
    from dynhor_tpu_torch.models import dino as TD
    from dynhor_tpu_torch.tracker import refine as TR

    mesh = TR.MeshArrays(*(torch.as_tensor(x) for x in inp["mesh"]))
    targets = TR.FrameTargets(*(torch.as_tensor(x) for x in inp["targets"]))
    params = TD.map_params(inp["dparams"], torch.as_tensor)
    return mesh, targets, params, TD.DinoConfig(**inp["dcfg"])


def case_refine(inp):
    from dynhor_tpu_torch.tracker import refine as TR

    d = inp["refine"]
    mesh, targets, params, dcfg = _refine_inputs(d)
    cfg = TR.RefineConfig(**d["cfg"])
    rot, trans = torch.as_tensor(d["rot"]), torch.as_tensor(d["trans"])
    single = TR.refine_poses(mesh, targets, rot, trans, params, dcfg, cfg, device="cpu")
    fm = PM.make_mesh(axis_name="frames")
    local = TR.refine_poses(
        PM.replicate(mesh, fm), TR.FrameTargets(*PM.shard_leading(tuple(targets), fm)),
        PM.shard_leading(rot, fm), PM.shard_leading(trans, fm), PM.replicate(params, fm),
        dcfg, cfg, device="cpu", frame_mesh=fm,
    )
    out = {f"single_{k}": _np(v) for k, v in zip(TR.RefineResult._fields[:4], single)}
    out.update({f"sharded_{k}": _np(PM.gather_leading(v, fm))
                for k, v in zip(TR.RefineResult._fields[:4], local)})
    out.update(local_frames=np.array(local.rot6d.shape[0]),
               single_overflow=np.array(single.max_overflow),
               sharded_overflow=np.array(local.max_overflow))
    return out


def case_joint(inp):
    from dynhor_tpu_torch.tracker import jointopt as TJ

    d = inp["joint"]
    cfg = TJ.JointConfig(**d["cfg"])
    verts, faces = torch.as_tensor(d["verts"]), torch.as_tensor(d["faces"])
    args = [torch.as_tensor(d[k]) for k in ("rot", "trans", "K", "masks")]
    single = TJ.joint_optimize(verts, faces, *args, cfg, device="cpu")
    fm = PM.make_mesh(axis_name="frames")
    local = TJ.joint_optimize(*PM.replicate((verts, faces), fm), *PM.shard_leading(args, fm),
                              cfg, device="cpu", frame_mesh=fm)
    out = {"single_rot6d": _np(single.rot6d), "single_trans": _np(single.translations),
           "sharded_rot6d": _np(PM.gather_leading(local.rot6d, fm)),
           "sharded_trans": _np(PM.gather_leading(local.translations, fm)),
           "sharded_scale": _np(local.scale), "single_scale": _np(single.scale)}
    out.update({f"single_h_{k}": _np(v) for k, v in single.history.items()})
    out.update({f"sharded_h_{k}": _np(v) for k, v in local.history.items()})
    return out


def case_priors(inp):
    from dynhor_tpu_torch.tracker import priors as TP

    d = inp["priors"]
    mesh, targets, params, dcfg = _refine_inputs(d)
    cfg = TP.PriorConfig(**d["cfg"])
    verts = torch.as_tensor(mesh.verts)
    radius, _ = TP.mesh_radius_center(verts)
    window = TP.compute_window(cfg, float(TP.mesh_norm_radius(verts)),
                               float(cfg.distance_scale * radius))
    crops, masks = torch.as_tensor(d["crops"]), torch.as_tensor(d["masks"])
    gt, cm = TP.frame_gt_features(params, dcfg, crops, masks, "float32", device="cpu")
    common = (params, dcfg, *mesh, torch.as_tensor(d["rots"]), crops, masks, gt, cm, cfg, window)
    kw = dict(prescreen_edge=d["prescreen_edge"], prescreen_scale=2, topk=d["topk"],
              device="cpu", with_sil=True)
    single, single_sil = TP.prior_scores_two_stage(*common, **kw)
    vm = PM.make_mesh(axis_name="views")
    sharded, sharded_sil = TP.prior_scores_two_stage(*common, **kw, view_mesh=vm)
    return {"single": _np(single), "single_sil": _np(single_sil), "sharded": _np(sharded),
            "sharded_sil": _np(sharded_sil)}


def _neus(inp):
    from dynhor_tpu_torch.neus import fields as TF
    from dynhor_tpu_torch.neus import rendering as TRN

    d = inp["neus"]
    cfg = TF.SDFConfig(**d["sdf_cfg"])
    field = TF.NeuSField(cfg, None)
    field.load_state_dict(TF.params_from_jax(d["params"]))
    return d, cfg, field, TRN


def case_neus_render(inp):
    d, cfg, field, TRN = _neus(inp)
    rays = TRN.Rays(*(torch.as_tensor(x) for x in d["rays"]))
    rcfg = TRN.RenderConfig(**d["rcfg"])
    whole = TRN.render_rays(field, rcfg, rays)
    rm = PM.make_mesh(axis_name="rays")
    local = TRN.render_rays(field, rcfg, TRN.Rays(*PM.shard_leading(tuple(rays), rm, "rays")))
    out = {"whole_rgb": _np(whole.rgb), "whole_acc": _np(whole.acc),
           "sharded_rgb": _np(PM.gather_leading(local.rgb, rm, "rays")),
           "sharded_acc": _np(PM.gather_leading(local.acc, rm, "rays"))}
    # The shade selection is per ray: a slice of the rays selects the
    # slice of the whole batch's selection.
    w = torch.rand((64, 20), generator=torch.Generator().manual_seed(0))
    w[:, 5:9] = 0.25  # ties
    sel = TRN.shade_selection(w, 6)
    lo, hi = PM.axis_index(rm, "rays") * 32, (PM.axis_index(rm, "rays") + 1) * 32
    out["shade_slice_equal"] = np.array(torch.equal(TRN.shade_selection(w[lo:hi], 6), sel[lo:hi]))
    return out


def case_neus_train(inp):
    from dynhor_tpu_torch.neus import data as TDA
    from dynhor_tpu_torch.neus import draws as TDR
    from dynhor_tpu_torch.neus import trainer as TT

    d, cfg, _, TRN = _neus(inp)
    data = TDA.ReconData(*(None if x is None else torch.as_tensor(x) for x in d["data"]))
    corr = TDA.CorrData(*(torch.as_tensor(x) for x in d["corr"]))
    rcfg = TRN.RenderConfig(**d["train_rcfg"])
    tcfg = TT.TrainConfig(**d["tcfg"])
    rm = PM.make_mesh(axis_name="rays")
    out = {}
    for name, sharding in (("whole", None), ("sharded", rm)):
        key = TDR.Key(0)
        state = TT.init_train_state(key, cfg, tcfg)  # the same key on every rank
        out[f"{name}_init_digest"] = np.array(_digest(state.field.state_dict()))
        step = TT.make_train_step(rcfg, tcfg, ray_sharding=sharding)
        logs = []
        for i in range(d["steps"]):
            lg = step(state, key.fold_in(i), data, corr, None)
            logs.append({k: float(v) for k, v in sorted(lg.items())})
        out[f"{name}_logs"] = np.array([[v for _, v in sorted(lg.items())] for lg in logs])
        out["log_keys"] = np.array(sorted(logs[0]))
        for pname, p in state.field.named_parameters():
            st = state.opt.state[p]
            out[f"{name}_param_{pname}"] = _np(p)
            out[f"{name}_m_{pname}"] = _np(st["exp_avg"])
            out[f"{name}_v_{pname}"] = _np(st["exp_avg_sq"])
        out[f"{name}_bg"] = _np(state.bg)
        out[f"{name}_digest"] = np.array(_digest(state.field.state_dict()))
        out[f"{name}_lrs"] = np.array([sum(TT.warmup_cosine(c, tcfg.warmup, max(
            tcfg.num_steps, tcfg.warmup + 1)) for c in range(d["steps"])) * tcfg.lr])
    return out


def case_replicate(inp):
    """``replicate`` makes every rank's copy of the ViT's weights and of a
    NeuS field bitwise equal to rank 0's, whatever each rank held."""
    from dynhor_tpu_torch.models import dino as TD

    rank = PM.world()[0]
    mesh = PM.make_mesh(axis_name="frames")
    params = TD.map_params(inp["refine"]["dparams"], lambda a: torch.as_tensor(a) + rank)
    d, cfg, field, _ = _neus(inp)
    with torch.no_grad():
        for p in field.parameters():
            p.add_(rank)
    before = _digest([params, field.state_dict()])
    rep = PM.replicate([params, field.state_dict()], mesh)
    return {"before": np.array(before), "after": np.array(_digest(rep))}


def case_pipeline(inp):
    import yaml

    from dynhor_tpu_torch.io import config as TCFG
    from dynhor_tpu_torch.tracker import pipeline as TPL

    d = inp["pipeline"]
    calls = {"save_pose_npzs": 0, "copy_config": 0, "Board": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    for name in calls:
        setattr(TPL, name, counted(name, getattr(TPL, name)))
    out = {}
    for devices, root in ((1, d["exps_one"]), (2, d["exps_two"])):
        cfg = yaml.safe_load(open(d["cfg_path"]))
        cfg["system"]["devices"] = devices
        path = os.path.join(d["work"], f"cfg_{devices}_{PM.world()[0]}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        res = TPL.run_from_config(TCFG.load_config(path), exps_root=root, device="cpu")
        out[f"rot_{devices}"] = res.rotations_row
        out[f"sel_{devices}"] = res.selected_idx
        out[f"view_devices_{devices}"] = np.array(TPL.view_devices(cfg["system"]))
        dist.barrier()
    out.update({f"calls_{k}": np.array(v) for k, v in calls.items()})
    return out


def case_run_multi(inp):
    """``python -m dynhor_tpu_torch.run_multi``'s main on two sequences with
    ``system.devices`` 1 and 2: the views and the pooled frames sharded over
    the ranks in the second."""
    import yaml

    from dynhor_tpu_torch import run_multi as RM

    d = inp["pipeline"]
    out = {}
    for devices, root in ((1, d["multi_one"]), (2, d["multi_two"])):
        paths = []
        for name in ("boxa", "boxb"):
            cfg = yaml.safe_load(open(d["cfg_path"]))
            cfg["seq_name"], cfg["system"]["devices"] = name, devices
            paths.append(os.path.join(d["work"], f"multi_{name}_{devices}_{PM.world()[0]}.yaml"))
            with open(paths[-1], "w") as f:
                yaml.safe_dump(cfg, f)
        res = RM.main(["--config_paths", *paths, "--exps_root", root, "--device", "cpu"])
        out[f"rot_{devices}"] = np.concatenate([sq["rotations_row"] for sq in res.sequences])
        dist.barrier()
    return out


def case_multiseq(inp):
    from dynhor_tpu_torch.parallel import multiseq as TMS
    from dynhor_tpu_torch.tracker import refine as TR
    from dynhor_tpu_torch.utils.objio import MeshData

    d = inp["multiseq"]
    meshes = [MeshData(**m) for m in d["meshes"]]
    targets = [TR.FrameTargets(*(torch.as_tensor(x) for x in t)) for t in d["targets"]]
    batch = TMS.build_batch(meshes, targets, device="cpu")
    m2 = PM.make_seq_frame_mesh(d["num_sequences"])
    ax = ("seq", "frames")
    local = TMS.refine_poses_multi(
        TMS.shard_batch(batch, m2, ax),
        *PM.shard_leading((torch.as_tensor(d["rot"]), torch.as_tensor(d["trans"])), m2, ax),
        None, None, TR.RefineConfig(**d["cfg"]), device="cpu", frame_mesh=m2, axis_name=ax,
    )
    return {"rot6d": _np(PM.gather_leading(local.rot6d, m2, ax)),
            "local_frames": np.array(local.rot6d.shape[0]),
            "coords": np.array([m2.coords["seq"], m2.coords["frames"]]),
            "shape": np.array([m2.shape["seq"], m2.shape["frames"]])}


def case_multihost(inp):
    """The port's multihost demo (``tools/multihost_input_demo.demo``): each
    process loads only its slice of the frame files; the global sum
    crosses the process boundary."""
    from dynhor_tpu_torch.tools.multihost_input_demo import demo

    out = demo(inp["multihost"]["data"])
    MH.init_distributed("localhost:1", 2, 0)  # a second call does nothing
    return out


CASES = {k[5:]: v for k, v in globals().items() if k.startswith("case_")}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rendezvous", required=True, help="init URL of the group")
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    with open(args.inputs, "rb") as f:
        inp = pickle.load(f)
    MH.init_distributed(args.rendezvous, args.world, args.rank, backend="gloo",
                        timeout_s=120)
    results, seconds = {}, {}
    for case in args.cases.split(","):
        t0 = time.perf_counter()
        try:
            results[case] = CASES[case](inp)
        except Exception:  # recorded for the test process to report
            results[case] = {"error": traceback.format_exc()}
        seconds[case] = time.perf_counter() - t0
    results["seconds"] = seconds
    results["jax_imported"] = any(
        k == "jax" or k.startswith(("jax.", "dynhor_tpu.")) for k, v in sys.modules.items()
        if v is not None)
    with open(args.out, "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
