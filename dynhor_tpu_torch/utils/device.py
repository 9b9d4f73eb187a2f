"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means CUDA and raises when no card is present; the CPU runs only when the
caller passes ``device="cpu"`` (as the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); else ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
