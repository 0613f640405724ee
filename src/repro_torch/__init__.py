"""PyTorch + CUDA port of the SHINE reproduction (``repro``), for one
NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs``, ``kernels``, ``core``, ``obs``, ``implicit``, ``models``,
``runtime``, ``launch``) and imports nothing of it.  Plain tensor code is
PyTorch; every Pallas TPU kernel on the ported path is a hand-written
Hopper kernel (CUDA C++ under ``csrc/``, Triton for rmsnorm) with a plain
PyTorch version beside it that CPU tensors take.

Ported so far: DEQ serving of the dense LM family (``launch/serve.py`` ->
``runtime/serving.ServeLoop`` sync pipeline -> ``models/lm.prefill`` /
``decode_step`` -> ``implicit`` -> ``core.solvers.broyden_solve`` ->
``core.lowrank.LowRank`` -> ``kernels.ops``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
