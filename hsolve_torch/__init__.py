"""hsolve_torch: the PyTorch/CUDA port of hsolve, a hierarchical sparse direct
solver and GMRES preconditioner (nested-dissection multifrontal factorization).

This slice is the exact (``swlevel=0``) real path, end to end on one device:
plan -> numeric factor -> hierarchical solve -> restarted GMRES.  The package
imports torch, numpy and scipy only; it never imports jax or ``hsolve`` (the JAX
package, kept as the reference), so it runs where JAX is absent.  Module names
mirror ``hsolve/``.  Its four hand-written CUDA kernels live in ``csrc/`` and
are built and bound by :mod:`hsolve_torch.kernels`.
"""

from hsolve_torch.options import SolverOptions
from hsolve_torch.models.problems import helmholtz2d, poisson2d
from hsolve_torch.models.dissect import nested_dissection
from hsolve_torch.planner import Plan, plan_factorization
from hsolve_torch.factor import Factorization, factor, factor_with_plan
from hsolve_torch.krylov import gmres, gmres_compiled
from hsolve_torch.ops.sparse import (dia_matvec, ell_matvec, spmv_format, to_dia,
                                     to_ell)

__all__ = [
    "SolverOptions", "helmholtz2d", "poisson2d", "nested_dissection",
    "plan_factorization", "Plan", "factor", "factor_with_plan", "Factorization",
    "gmres", "gmres_compiled", "to_dia", "dia_matvec", "to_ell", "ell_matvec",
    "spmv_format",
]
