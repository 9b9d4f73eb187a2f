"""CUDA-event timing (a frozen copy of the port's ``tools/_timing.timeit``)."""
from __future__ import annotations

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
