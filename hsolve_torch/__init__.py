"""hsolve_torch: the PyTorch/CUDA port of hsolve, a hierarchical sparse direct
solver and GMRES preconditioner (nested-dissection multifrontal factorization).

The exact (``swlevel=0``), low-rank compressed and structured (HSS) real paths
run end to end on one device: plan -> numeric factor -> hierarchical solve ->
restarted GMRES, in float64, and the exact path also as the JAX bench's device
configuration (a float32 factor inside mixed-precision GMRES with escalation),
on the 2D and 3D problem families; ``python -m hsolve_torch.bench`` prints the
JAX bench's JSON line.
The entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.  The package imports torch, numpy and scipy only; it never
imports jax or ``hsolve`` (the JAX package, kept as the reference), so it runs
where JAX is absent.  Module names mirror ``hsolve/``.  Its thirteen
hand-written CUDA kernels live in ``csrc/`` and are built and bound by
:mod:`hsolve_torch.kernels`.
"""

from hsolve_torch.options import SolverOptions
from hsolve_torch.utils.trees import (NDTree, contiguous, parse_elimtree, permuted,
                                      postorder, serialize_elimtree, symfact)
from hsolve_torch.models.problems import (helmholtz2d, helmholtz3d, p1_fem_2d,
                                          poisson2d, poisson3d)
from hsolve_torch.models.dissect import nested_dissection
from hsolve_torch.models.matio import read_problem, write_problem
from hsolve_torch.planner import Plan, plan_factorization
from hsolve_torch.factor import Factorization, factor, factor_with_plan
from hsolve_torch.krylov import gmres, gmres_compiled
from hsolve_torch.ops.sparse import (dia_matvec, ell_matvec, spmv_format, to_dia,
                                     to_ell)

__all__ = [
    "SolverOptions", "NDTree", "parse_elimtree", "serialize_elimtree", "symfact",
    "postorder", "permuted", "contiguous", "poisson2d", "helmholtz2d", "poisson3d",
    "helmholtz3d", "p1_fem_2d", "nested_dissection", "read_problem", "write_problem",
    "plan_factorization", "Plan", "factor", "factor_with_plan", "Factorization",
    "gmres", "gmres_compiled", "to_dia", "dia_matvec", "to_ell", "ell_matvec",
    "spmv_format",
]
