"""PyTorch + CUDA port of the SHINE reproduction (``repro``), for one
NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs``, ``kernels``, ``core``, ``obs``, ``implicit``, ``models``,
``runtime``, ``launch``) and imports nothing of it.  Plain tensor code is
PyTorch; every Pallas TPU kernel on the ported path is a hand-written
Hopper kernel (CUDA C++ under ``csrc/``) with a plain
PyTorch version beside it that CPU tensors take.

Ported so far, for the dense LM family: DEQ serving (``launch/serve.py``
-> ``runtime/serving.ServeLoop`` sync pipeline -> ``models/lm.prefill`` /
``decode_step``) and DEQ training with the SHINE backward
(``launch/train.py`` -> ``runtime/trainer.Trainer`` ->
``launch/steps.build_train_step`` -> ``models/lm.loss_fn``), both through
``implicit`` -> ``core.solvers.broyden_solve`` -> ``core.lowrank.LowRank``
-> ``kernels.ops``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
