"""Limited-memory low-rank representation of quasi-Newton inverse matrices.

The port of ``repro/core/lowrank.py``:

    H = alpha * I + sum_i u_i v_i^T            (rank <= m)

built as a by-product of the forward Broyden solve and applied in O(m d).
The rank-one chain is stored as two stacked ``(m, B, *F)`` ring buffers
with a per-sample valid ``count``; the feature axes are never flattened at
this level (``kernels/ops`` flattens them for the kernels).  All
coefficient math runs in f32 even when the ring is stored bf16.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops as kernel_ops


def _expand(mask: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Broadcast a (B,) mask against (B, *F)."""
    return mask.reshape(mask.shape + (1,) * (ref.ndim - 1))


@dataclasses.dataclass
class LowRank:
    """``H = alpha * I + sum_i u[i] v[i]^T`` with per-sample ring memory.

    Shapes: ``u, v: (m, B, *F)``, ``alpha``: 0-d f32 tensor, ``count:
    (B,)`` int32.  Entries with ring index >= count are invalid.
    """

    alpha: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    count: torch.Tensor

    @property
    def memory(self) -> int:
        return self.u.shape[0]

    @staticmethod
    def identity(batch: int, feat: tuple[int, ...] | int, memory: int,
                 alpha: float = 1.0, dtype=torch.float32,
                 device: torch.device | str = "cpu") -> "LowRank":
        feat = (feat,) if isinstance(feat, int) else tuple(feat)
        return LowRank(
            alpha=torch.tensor(alpha, dtype=torch.float32, device=device),
            u=torch.zeros((memory, batch) + feat, dtype=dtype, device=device),
            v=torch.zeros((memory, batch) + feat, dtype=dtype, device=device),
            count=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    def _valid_mask(self) -> torch.Tensor:
        # (m, B) mask of live ring slots
        m = self.memory
        idx = torch.arange(m, dtype=torch.int32, device=self.u.device)[:, None]
        live = torch.clamp(self.count, max=m)[None, :]
        return (idx < live).float()

    def matvec_multi(self, xs, transpose=None) -> tuple[torch.Tensor, ...]:
        """Apply ``H`` and/or ``H^T`` to K right-hand sides ``(B, *F)`` in
        one streaming pass over the ring."""
        transpose = tuple(transpose) if transpose is not None \
            else (False,) * len(xs)
        out = kernel_ops.qn_apply_multi(
            self.u, self.v, torch.stack(list(xs)), self.alpha,
            self._valid_mask(), transpose)
        return tuple(out[k] for k in range(len(xs)))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``H @ x`` batched over B."""
        return self.matvec_multi((x,), (False,))[0]

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """``H^T @ x`` batched over B."""
        return self.matvec_multi((x,), (True,))[0]

    def broyden_step(self, g_new, s, hg_old, active, eps: float):
        """One Broyden iteration's memory work in one fused U/V pass
        (``kernels/ops.broyden_step``).  Returns ``(H_new, hg_new, b, den,
        upd, ev_u, ev_v)``.  On the card the ring is updated in place: this
        ``LowRank`` is consumed."""
        m = self.memory
        slot = (self.count % m).int()
        new_u, new_v, hg_new, b, den, ev_u, ev_v = kernel_ops.broyden_step(
            self.u, self.v, g_new, s, hg_old, self.alpha, self._valid_mask(),
            slot, active, eps)
        upd = active & (den.abs() > eps)
        H = LowRank(alpha=self.alpha, u=new_u, v=new_v,
                    count=self.count + upd.int())
        return H, hg_new, b, den, upd, ev_u, ev_v

    def dense(self) -> torch.Tensor:
        """Materialize H as (B, D, D) -- tests/small problems only."""
        m, bsz, dim = self.u.shape
        eye = torch.eye(dim, dtype=torch.float32, device=self.u.device)[None]
        terms = torch.einsum("mb,mbi,mbj->bij", self._valid_mask(),
                             self.u.float(), self.v.float())
        return self.alpha * eye + terms


def bdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample dot product in f32 over all feature dims: -> (B,)."""
    prod = x.float() * y.float()
    return prod.reshape(prod.shape[0], -1).sum(-1)


def bnorm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(bdot(x, x), min=0.0))
