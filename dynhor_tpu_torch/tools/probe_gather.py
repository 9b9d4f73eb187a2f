"""Probe of the gather forms of ``tools/probe_pallas_gather.py`` on the card.

    python -m dynhor_tpu_torch.tools.probe_gather

The JAX tool asks which gather forms Mosaic lowers on the TPU; on the card
every form is a launch of the hand-written kernels of K6
(csrc/gather_probe.cu): ``take_along_axis`` for the gathers A-G and
``scatter_add_axis0`` for the scatter-add H.  Each form runs at the JAX
tool's shapes on data made from a numpy seed and is held against its plain
version: gathers exactly, the scatter-add within rtol 1e-5 and atol 1e-5
(the plain version on the card sums with atomics, in an order that changes
from run to run); on the card form H is also held against the CPU's plain
version bit for bit (its "columns" path sums each entry in row order, as
the CPU does).  It prints ``[OK]`` or ``[FAIL]`` per form as the JAX tool
does, then the timed shapes: the per-lane gather (2048 x 128 from 8192 x
128, the JAX tool's timed Pallas kernel), form H's scatter-add ((512, 128)
+= (256, 128)), and the row gather and scatter-add at the hash backward's
shape (262,144 rows of width 2 against an (8192, 2) table), where the JAX
tool times only XLA baselines.  Each is timed against its PyTorch library
call in turns (``tools/_timing.split_in_turns``): device time by a CUDA
graph, host time to enqueue, wall time per call; beside them the plain
version's wall time and the byte bound.  A form that fails makes the run
fail; nothing is caught.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import kernels
from ..ops import gather as OG
from ..ops.gather import scatter_add_axis0, take_along_axis
from ..utils.device import resolve_device
from ._timing import split_in_turns, timeit

T, F, N = 8192, 8, 1024  # the JAX tool's table rows, row width, indices
HASH_ROWS = 2048 * 128  # lookups of the timed forms
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 at 700 W (NVIDIA data sheet)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _ints(rng, hi, shape):
    return rng.integers(0, hi, shape).astype(np.int32)


def make_forms(device) -> list[dict]:
    """Forms A-H at the JAX tool's shapes, from numpy seeds: each a dict
    with its key, the JAX tool's label, "take" (src, idx, axis) or
    "scatter" (g, idx, rows) arguments and the plain arrays it came from."""
    rng = np.random.default_rng(0)
    table = _normal(rng, (T, F))
    idx = _ints(rng, T, (N,))
    out = [
        dict(key="A", name="A row-gather (N,F) = take((T,F}), idx, axis=0)", op="take",
             src=table, idx=idx, view=lambda i: i[:, None].expand(N, F), axis=0),
        dict(key="B", name="B 1-D lane gather (1,N) from (1,T)", op="take",
             src=_normal(rng, (1, T)), idx=idx.reshape(1, N), view=None, axis=1),
        dict(key="C", name="C take_along_axis (8,128) from (8,T) lanes", op="take",
             src=_normal(rng, (8, T)), idx=_ints(rng, T, (8, 128)), view=None, axis=1),
        dict(key="D", name="D serial dynamic-row slice x8", op="take",
             src=table, idx=idx[:8], view=lambda i: i[:, None].expand(8, F), axis=0),
    ]
    for t_rows in (512, 8192):
        out.append(dict(
            key=f"E{t_rows}", name=f"E per-lane row gather (256,128) from ({t_rows},128) axis=0",
            op="take", src=_normal(rng, (t_rows, 128)), idx=_ints(rng, t_rows, (256, 128)),
            view=None, axis=0,
        ))
    out += [
        dict(key="F", name="F per-lane row gather (8,128) from (512,128) axis=0", op="take",
             src=_normal(rng, (512, 128)), idx=_ints(rng, 512, (8, 128)), view=None, axis=0),
        dict(key="G", name="G lane shuffle (8,128) take_along_axis axis=1", op="take",
             src=_normal(rng, (8, 128)), idx=_ints(rng, 128, (8, 128)), view=None, axis=1),
        dict(key="H", name="H per-lane scatter-add (512,128) += (256,128)", op="scatter",
             g=_normal(rng, (256, 128)), idx=_ints(rng, 512, (256, 128)), view=None, rows=512),
    ]
    for form in out:
        form["args"] = _place(form, device)
    return out


def _place(form: dict, device):
    idx = torch.as_tensor(form["idx"], device=device)
    if form["view"] is not None:
        idx = form["view"](idx)
    if form["op"] == "take":
        return torch.as_tensor(form["src"], device=device), idx, form["axis"]
    return torch.as_tensor(form["g"], device=device), idx, form["rows"]


def apply(form: dict, plain: bool = False) -> torch.Tensor:
    """The form through the dispatcher (the kernel for CUDA tensors) or,
    with ``plain``, through its plain version."""
    if form["op"] == "take":
        fn = OG.take_along_axis_plain if plain else take_along_axis
    else:
        fn = OG.scatter_add_axis0_plain if plain else scatter_add_axis0
    return fn(*form["args"])


def agrees(form: dict, got: torch.Tensor, want: torch.Tensor) -> bool:
    """Gathers exactly; the scatter-add within rtol 1e-5, atol 1e-5."""
    if form["op"] == "take":
        return torch.equal(got, want)
    return torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def _timed_inputs(device):
    rng = np.random.default_rng(1)
    tab = torch.as_tensor(_normal(rng, (T, 128)), device=device)
    idx = torch.as_tensor(_ints(rng, T, (2048, 128)), device=device)
    flat = torch.as_tensor(_ints(rng, T, (HASH_ROWS,)), device=device)
    g = torch.as_tensor(_normal(rng, (HASH_ROWS, 2)), device=device)
    return tab, idx, flat, g


def run(device, reps: int = 20, out=print) -> dict:
    """Run every form and the timed shapes on ``device``.  Returns
    {"forms": {key: ok}, "max_abs_err": {"take": x, "scatter": x},
    "timed": {row: {"device_ms", "host_us", "wall_ms", "library_device_ms",
    "library_host_us", "library_wall_ms", "plain_ms", "bound_ms",
    "bytes"}}}; the caller fails the run on any form that is not ok."""
    device = torch.device(device)
    forms, errs = {}, {"take": 0.0, "scatter": 0.0}
    all_forms = make_forms(device)
    for form in all_forms:
        got, want = apply(form), apply(form, plain=True)
        ok = agrees(form, got, want)
        forms[form["key"]] = ok
        errs[form["op"]] = max(errs[form["op"]], float((got - want).abs().max()))
        if ok:
            out(f"[OK]   {form['name']}: out {tuple(got.shape)} {str(got.dtype).replace('torch.', '')}")
        else:
            out(f"[FAIL] {form['name']}: max abs err {float((got - want).abs().max()):.3g}")

    tab, idx, flat, g = _timed_inputs(device)
    flat2 = flat[:, None].expand(-1, 2)
    h_g, h_idx, h_rows = next(f["args"] for f in all_forms if f["key"] == "H")
    if device.type == "cuda":
        h_cpu = OG.scatter_add_axis0_plain(h_g.cpu(), h_idx.cpu(), h_rows)
        forms["H exact vs the CPU"] = torch.equal(scatter_add_axis0(h_g, h_idx, h_rows).cpu(), h_cpu)
    e = take_along_axis(tab, idx, 0)
    forms["E timed"] = torch.equal(e, torch.gather(tab, 0, idx.long()))
    rg = take_along_axis(tab[:, :2], flat2, 0)
    forms["row gather"] = torch.equal(rg, tab[:, :2].index_select(0, flat.long()))
    sc = scatter_add_axis0(g, flat2, T)
    sc_lib = torch.zeros((T, 2), device=device).index_add_(0, flat.long(), g)
    forms["scatter timed"] = torch.allclose(sc, sc_lib, rtol=1e-5, atol=1e-5)
    errs["scatter"] = max(errs["scatter"], float((sc - sc_lib).abs().max()))
    n = HASH_ROWS
    # The library calls get their indices in int64 already, so each is
    # timed as the one launch (two with the zeroed table) it takes.
    idx64, flat64, h_idx64 = idx.long(), flat.long(), h_idx.long()
    timed = {
        # per-lane gather: indices, the gathered values once, the output once
        "E per-lane gather 2048x128 of 8192x128": dict(
            fn=lambda: take_along_axis(tab, idx, 0),
            plain=lambda: OG.take_along_axis_plain(tab, idx, 0),
            library=lambda: torch.gather(tab, 0, idx64), nbytes=n * 4 * 3),
        "row gather (262k rows of (T,2))": dict(
            fn=lambda: take_along_axis(tab[:, :2], flat2, 0),
            plain=lambda: OG.take_along_axis_plain(tab[:, :2], flat2, 0),
            library=lambda: tab[:, :2].index_select(0, flat64), nbytes=n * 4 + 2 * n * 2 * 4),
        # scatter-add: indices, g, the table written once
        "H scatter-add (512,128) += (256,128)": dict(
            fn=lambda: scatter_add_axis0(h_g, h_idx, h_rows),
            plain=lambda: OG.scatter_add_axis0_plain(h_g, h_idx, h_rows),
            library=lambda: torch.zeros((h_rows, 128), device=device).scatter_add_(0, h_idx64, h_g),
            nbytes=h_idx.numel() * 8 + h_rows * 128 * 4, lookups=h_idx.numel()),
        "scatter-add (262k rows into (T,2))": dict(
            fn=lambda: scatter_add_axis0(g, flat2, T),
            plain=lambda: OG.scatter_add_axis0_plain(g, flat2, T),
            library=lambda: torch.zeros((T, 2), device=device).index_add_(0, flat64, g),
            nbytes=n * 4 + n * 2 * 4 + T * 2 * 4),
    }
    rows = {}
    for name, t in timed.items():
        turns = split_in_turns(t["fn"], t["library"], device, rounds=2, n=reps)
        k, lib = turns["kernel"], turns["library"]
        bound_ms = t["nbytes"] / PEAK_BYTES * 1e3
        rows[name] = dict(
            device_ms=k["device_us"] / 1e3, host_us=k["host_us"], wall_ms=k["wall_ms"],
            library_device_ms=lib["device_us"] / 1e3, library_host_us=lib["host_us"],
            library_wall_ms=lib["wall_ms"], plain_ms=timeit(t["plain"], device, reps, warmup=1),
            bound_ms=bound_ms, bytes=t["nbytes"],
        )
        r = rows[name]
        lookups = t.get("lookups", n)
        out(
            f"[TIME] {name}, kernel vs library in turns (medians of 4): device "
            f"{k['device_us']:.3f} vs {lib['device_us']:.3f} us/call, enqueue {k['host_us']:.2f} "
            f"vs {lib['host_us']:.2f} us, wall {k['wall_ms']:.5f} vs {lib['wall_ms']:.5f} ms/call; "
            f"{lookups / k['device_us']:.0f}M lookups/s by device time, "
            f"{bound_ms / r['device_ms'] * 100:.2f} % of the byte bound {bound_ms:.6f} ms "
            f"({t['nbytes']} bytes at {PEAK_BYTES:.3g} B/s); plain {r['plain_ms']:.5f} ms wall"
        )
    for key in ("E timed", "row gather", "scatter timed"):
        out(f"[{'OK' if forms[key] else 'FAIL'}]   {key} at the timed shape")
    if "H exact vs the CPU" in forms:
        out(f"[{'OK' if forms['H exact vs the CPU'] else 'FAIL'}]   H equals the CPU's plain "
            "version bit for bit")
    return {"forms": forms, "max_abs_err": errs, "timed": rows}


def main() -> None:
    device = resolve_device(None)
    print(torch.cuda.get_device_name(device), flush=True)
    before = (kernels.take_along_axis.launches, kernels.scatter_add_axis0.launches)
    res = run(device)
    print(f"launches: take_along_axis {kernels.take_along_axis.launches - before[0]}, "
          f"scatter_add_axis0 {kernels.scatter_add_axis0.launches - before[1]}")
    failed = [k for k, ok in res["forms"].items() if not ok]
    if failed:
        print(f"FAILED forms: {failed}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
