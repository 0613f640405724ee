"""Launch counts of the Hopper kernels, one per wrapper.

Each wrapper adds one to its count where it launches its kernel on the
card, and nowhere else (the plain versions that CPU tensors take do not
count).  A run shows that the main path went through the kernels by
resetting the counts, driving the path, and reading them back.
"""

from __future__ import annotations

KERNELS = ("broyden_step", "qn_apply_multi", "flash_attention",
           "decode_attention", "rmsnorm")

_COUNTS = {name: 0 for name in KERNELS}


def bump(name: str) -> None:
    _COUNTS[name] += 1


def reset() -> None:
    for name in _COUNTS:
        _COUNTS[name] = 0


def counts() -> dict[str, int]:
    return dict(_COUNTS)
