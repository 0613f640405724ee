"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  There is
no quiet fallback: asking for nothing on a machine without CUDA raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card (``cuda``); ``"cpu"`` runs the plain PyTorch
    versions of every kernel; ``"meta"``, asked for by name, builds shapes
    without storage (the dry-run's host-side device: nothing on it is
    computed).  Raises if CUDA is asked for (explicitly or by default) and
    no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or --device cpu) to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu' "
                         f"(or 'meta' for shapes only)")
    return dev


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device`` without a host wait: on the card it goes
    through pinned memory with a non-blocking copy (a copy from pageable
    memory waits for the card to drain its queue first)."""
    if device.type != "cuda":
        return t.to(device)
    return t.contiguous().pin_memory().to(device, non_blocking=True)
