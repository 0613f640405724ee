"""Decorator-based registries for forward solvers and backward estimators.

The port's copy of ``repro/implicit/registry.py``: a flat name -> entry
mapping resolved at call time, as a small reusable class, because the
implicit package needs two of them:

  * ``SOLVERS``     — forward fixed-point solvers.  Entries have signature
                      ``solver(f, z0, cfg, *, outer_grad=None) -> SolveResult``
                      where ``f(z) -> z`` is the fixed-point map over a flat
                      ``(B, *F)`` state and ``cfg`` is a
                      ``core.solvers.SolverConfig``.
  * ``ESTIMATORS``  — backward cotangent estimators (paper §2 modes); the
                      port registers them with the training slice.

Third parties extend either family with the decorators:

    from repro_torch.implicit.registry import register_solver

    @register_solver("my_picard")
    def my_picard(f, z0, cfg, *, outer_grad=None): ...

Unknown names raise ``ValueError`` listing every registered option.
"""

from __future__ import annotations

from typing import Callable, Iterator


class Registry:
    """Name -> callable mapping with decorator registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, Callable] = {}

    def register(self, name: str, *aliases: str) -> Callable[[Callable], Callable]:
        def deco(fn: Callable) -> Callable:
            for n in (name,) + aliases:
                if n in self._entries:
                    raise ValueError(
                        f"{self.kind} {n!r} is already registered"
                    )
                self._entries[n] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable:
        try:
            return self._entries[name]
        except KeyError:
            raise ValueError(
                f"unknown {self.kind} {name!r}; registered {self.kind}s: "
                f"{', '.join(self.names())}"
            ) from None

    def names(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())


SOLVERS = Registry("solver")
ESTIMATORS = Registry("estimator")

register_solver = SOLVERS.register
register_estimator = ESTIMATORS.register
