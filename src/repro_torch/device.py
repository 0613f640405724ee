"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  There is
no quiet fallback: asking for nothing on a machine without CUDA raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card (``cuda``); ``"cpu"`` runs the plain PyTorch
    versions of every kernel.  Raises if CUDA is asked for (explicitly or by
    default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or --device cpu) to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
