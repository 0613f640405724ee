"""Faults planted underneath the timed path, to show that ``correct``
catches them: a step that returns its state unchanged, and half of the
batch left out with the mean taken over the rest.  Each is a context
manager that patches the program's module for the block and restores it.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def unchanged_state():
    """AdamW returns the parameters and moments it was given, untouched;
    only the step counter moves."""
    from repro_torch.launch import steps
    from repro_torch.optim.optimizers import OptState

    orig = steps.adamw_update

    def frozen(grads, state, params, lr, **kw):
        return params, OptState(state.step + 1, state.mu, state.nu)

    steps.adamw_update = frozen
    try:
        yield
    finally:
        steps.adamw_update = orig


@contextlib.contextmanager
def half_batch():
    """The loss sees the first half of the rows: the targets of the rest
    are ignored (-1), so the mean runs over half of the batch."""
    from repro_torch.models import lm

    orig = lm.loss_fn

    def half(params, batch, cfg, **kw):
        t = batch["targets"].clone()
        t[t.shape[0] // 2:] = -1
        return orig(params, dict(batch, targets=t), cfg, **kw)

    lm.loss_fn = half
    try:
        yield
    finally:
        lm.loss_fn = orig


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch}
