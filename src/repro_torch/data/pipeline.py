"""Deterministic synthetic token batches, and the audio and vlm stub
frontends' random batches (``stub_batch``).

The port of ``repro/data/pipeline.py``: the same counter-mode recipe in
numpy, so both packages draw the same batches, placed on the given device.
Batch ``i`` depends only on ``(seed, i)``, so a restarted run resumes its
stream by starting at the restored step.  A batch is one small numpy draw
on the host, so there is no prefetch thread (and no ``close``); it goes
to the card through pinned memory, without a host wait.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, to_device


class SyntheticTokenDataset:
    """Counter-mode hashed tokens with mild n-gram structure (so small models
    can actually reduce loss on it)."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        self.seed = seed

    def batch(self, index: int, batch: int, seq: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, index))
        base = rng.integers(0, self.vocab, size=(batch, seq), dtype=np.int64)
        # inject learnable structure: token t depends on t-1 half the time
        shifted = (np.roll(base, 1, axis=1) * 31 + 7) % self.vocab
        use = rng.random((batch, seq)) < 0.5
        out = np.where(use, shifted, base)
        return out.astype(np.int32)


class _Batches:
    """Iterator of ``{"tokens", "targets"}`` int32 tensors on a device."""

    def __init__(self, ds: SyntheticTokenDataset, batch: int, seq: int,
                 start_step: int, device: torch.device):
        self.ds, self.batch, self.seq = ds, batch, seq
        self.i, self.device = start_step, device

    def __iter__(self) -> "_Batches":
        return self

    def __next__(self) -> dict:
        toks = torch.from_numpy(self.ds.batch(self.i, self.batch,
                                              self.seq + 1))
        self.i += 1
        return {"tokens": to_device(toks[:, :-1], self.device),
                "targets": to_device(toks[:, 1:], self.device)}


def make_lm_batch_iterator(cfg: ModelConfig, batch: int, seq: int, *,
                           seed: int = 0, start_step: int = 0,
                           device=None) -> Iterator[dict]:
    """Yields ``{tokens, targets}`` batches of ``(batch, seq)`` next-token
    pairs, from step ``start_step`` on, on ``device`` (default the card)."""
    return _Batches(SyntheticTokenDataset(cfg.vocab_size, seed), batch, seq,
                    start_step, resolve_device(device))


def stub_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
               device=None) -> dict:
    """A random batch of ``seq`` positions for ``cfg``'s frontend (the
    batches of the JAX package's ``tests/test_archs.py``), drawn with
    numpy from ``seed``: audio ``{embeds (B, S, d) f32, targets (B, S)}``
    (the stub's frame embeddings, standard normal); vlm ``{tokens (B, S -
    N), image_embeds (B, N, d) f32, targets (B, S - N)}`` with ``N =
    cfg.num_image_tokens`` (the stub's patch embeddings); any other family
    ``{tokens, targets}`` of ``(B, S)``.  Tokens and targets are uniform
    over ``[0, vocab_size)``, int32, on ``device`` (default the card)."""
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)

    def ints(*shape):
        return to_device(torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=shape).astype(np.int32)), dev)

    def normal(*shape):
        return to_device(torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)), dev)

    if cfg.family == "audio":
        return {"embeds": normal(batch, seq, cfg.d_model),
                "targets": ints(batch, seq)}
    if cfg.family == "vlm":
        n = cfg.num_image_tokens
        return {"tokens": ints(batch, seq - n),
                "image_embeds": normal(batch, n, cfg.d_model),
                "targets": ints(batch, seq - n)}
    return {"tokens": ints(batch, seq), "targets": ints(batch, seq)}
