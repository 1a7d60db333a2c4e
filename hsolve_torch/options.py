"""Solver options (jax-free copy of ``hsolve/options.py``).

The nine reference fields (``swlevel, swsize, atol, rtol, c_tol, leafsize, kest,
stepsize, verbose``) keep their names, defaults and validation semantics, and
``pad`` is the planner's padding granularity, so a port plan equals the JAX
planner's plan for the same options.

Not carried over: the compressed path's fields (``rank_cap``, ``rank_pad``,
``level_caps``, ``seed``, ``hss``, ``adaptive``) come with the low-rank slice;
``dtype`` is the ``dtype=`` argument of ``factor``; ``matmul_precision`` and
``structured_precision`` picked the TPU's bf16 matmul passes, while the port
runs every float64 product at full precision and keeps TF32 off (see
:mod:`hsolve_torch.factor`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SolverOptions:
    # --- reference-parity fields (defaults: HierarchicalSolvers.jl:43-59) ---
    swlevel: int = 5          # switching level at which to start compression
    swsize: int = 1           # minimum boundary size for compression
    atol: float = 1e-6        # absolute compression tolerance
    rtol: float = 1e-6        # relative compression tolerance
    c_tol: float = 0.5        # low-rank tol relative to HSS tol (ref declares but hard-codes 0.5)
    leafsize: int = 32        # HSS leaf size
    kest: int = -1            # initial rank estimate for randomized HSS sampling
    stepsize: int = 10        # rank-growth step for adaptive sampling
    verbose: bool = False

    # --- static-shape planning ---
    pad: int = 8              # pad front dims (ni, nb) up to multiples of this
    explicit_inverse: Optional[bool] = None  # additionally store D^{-1} (and the root
                              # inverse) so every solve sweep is a GEMM instead of a
                              # pair of triangular solves; trades 2x pivot-block
                              # memory and backward stability (forward error
                              # ~cond(D)*eps per level).  None = auto, which is off
                              # on every device: the backward-stable triangular
                              # solves.  Guard: Factorization.cond_report().
    fast_inverse: Optional[bool] = None  # compute D^{-1} by recursive block-Schur
                              # inversion (pivoting confined to base diagonal
                              # blocks) instead of pivoted LU + triangular solves.
                              # Only takes effect with explicit_inverse; opt-in.

    def replace(self, **kwargs) -> "SolverOptions":
        """Kwarg-override copy (parity with ``copy(opts; args...)``,
        HierarchicalSolvers.jl:62-71)."""
        return dataclasses.replace(self, **kwargs)

    def validate(self) -> None:
        """Parity with ``chkopts!`` (HierarchicalSolvers.jl:73-79)."""
        if self.swsize < 1:
            raise ValueError("swsize must be >= 1")
        if self.atol < 0.0:
            raise ValueError("atol must be >= 0")
        if self.rtol < 0.0:
            raise ValueError("rtol must be >= 0")
        if not (0.0 < self.c_tol <= 1.0):
            raise ValueError("c_tol must be in (0, 1]")
        if self.leafsize < 1:
            raise ValueError("leafsize must be >= 1")
        if self.pad < 1:
            raise ValueError("pad must be >= 1")

    def resolve_explicit_inverse(self) -> bool:
        """None = auto = off: the backward-stable triangular-solve sweeps."""
        if self.explicit_inverse is None:
            return False
        return self.explicit_inverse

    def resolve_fast_inverse(self) -> bool:
        """None = off.  Explicit opt-in, and only together with
        ``explicit_inverse``."""
        if not self.explicit_inverse:
            return False
        return bool(self.fast_inverse)

    def resolve_swlevel(self, tree_depth: int) -> int:
        """Negative swlevel counts from the bottom: ``max(depth + swlevel, 0)``
        (parity with factorization.jl:8)."""
        if self.swlevel < 0:
            return max(tree_depth + self.swlevel, 0)
        return self.swlevel
