"""CUDA-event timing shared by the port's tools."""
from __future__ import annotations

import time

import numpy as np
import torch


def timeit(fn, device, n: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of fn() over n calls after warm-up, by CUDA events
    on ``device``'s stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / n


def host_us(fn, device, n: int = 100) -> float:
    """Host microseconds per call of fn() to enqueue its work: a host clock
    around n calls with no synchronization inside, after one warm-up."""
    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize(device)
    return us


def device_us(fn, device, n: int = 20, replays: int = 10) -> float:
    """Device microseconds per call of fn(): n calls captured in one CUDA
    graph, the graph replayed ``replays`` times between two CUDA events.
    The host's enqueue drops out; the gaps between the graph's kernels stay
    in (about a microsecond each)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    us = start.elapsed_time(end) * 1e3 / (replays * n)
    del graph
    return us


def split(fn, device, n: int = 20) -> dict:
    """One sample of fn()'s device us, host us to enqueue and wall ms per
    call (``timeit``: events around n back-to-back calls)."""
    return dict(device_us=device_us(fn, device, n), host_us=host_us(fn, device),
                wall_ms=timeit(fn, device, n, warmup=1))


def split_in_turns(kernel, library, device, rounds: int = 2, n: int = 20) -> dict:
    """``split`` of a kernel and a library call in turns (kernel, library,
    library, kernel), ``rounds`` times; returns {"kernel": medians,
    "library": medians}, each a dict of the three numbers."""
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(split(kernel, device, n))
        ls.append(split(library, device, n))
        ls.append(split(library, device, n))
        ks.append(split(kernel, device, n))

    def medians(samples):
        return {k: float(np.median([s[k] for s in samples])) for k in samples[0]}

    return {"kernel": medians(ks), "library": medians(ls)}


def wall_s(fn, device):
    """(fn()'s result, seconds of wall clock) between two synchronizations
    of ``device`` (a CUDA device; the first synchronization fails on the
    CPU)."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def first_and_mean_ms(fn, device, n: int = 10) -> tuple[float, float]:
    """(ms of the first call, the kernels' build included; mean ms per call
    of the next ``n`` calls by CUDA events)."""
    _, first = wall_s(fn, device)
    return first * 1e3, timeit(fn, device, n, warmup=0)
