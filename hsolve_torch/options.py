"""Solver options (jax-free copy of ``hsolve/options.py``).

The nine reference fields (``swlevel, swsize, atol, rtol, c_tol, leafsize, kest,
stepsize, verbose``) keep their names, defaults and validation semantics;
``pad``, ``rank_cap``, ``rank_pad`` and ``level_caps`` are the planner's static
shapes, so a port plan equals the JAX planner's plan for the same options.
``seed``, ``hss`` and ``adaptive`` keep the JAX meanings.  ``hss=True`` (the
default, as in JAX) plans the structured (HSS) Schur complements, which the
port does not have yet: compressing with it raises, and ``hss=False`` runs the
low-rank compressed path with dense Schur complements.

Not carried over: ``dtype`` is the ``dtype=`` argument of ``factor``;
``matmul_precision`` and ``structured_precision`` picked the TPU's bf16 matmul
passes, while the port runs every float64 product at full precision and keeps
TF32 off (see :mod:`hsolve_torch.factor`).
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
    rank_cap: int = 0         # static max rank for low-rank blocks (0 = planner
                              # decides: from kest when kest > 0 - the reference's
                              # user-provided rank estimate (factorization.jl:102-104)
                              # - else boundary/4)
    rank_pad: int = 8         # pad ranks up to multiples of this
    # Per-tree-level rank caps, indexed by reference recursion level (root = 1,
    # level_caps[0] caps the root level; the LAST entry extends to all deeper
    # levels).  Overrides rank_cap/kest where set.
    level_caps: Optional[tuple] = None
    seed: int = 123           # seed of the randomized compression's sketches
    hss: bool = True          # emit HSS Schur complements on compressed levels
                              # (False = low-rank Gauss transforms only, dense S)
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
    adaptive: bool = False    # after a compressed factorization, check the computed
                              # ranks against the planned caps and re-factor with
                              # doubled caps on saturation (host-loop parity with
                              # randcompress_adaptive, factorization.jl:110).  Costs
                              # one small device->host fetch per factorization.

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
