"""Schur update of a compressed level: kernel F with its plain version.

On a compressed level the right Gauss transform is the low-rank pair
``R ~= RU RV^T``, and ``hsolve/factor.py:378-379`` forms the permuted Schur
complement as ``permute_sym(Abb - (Abi @ RU) @ RV^T, sperm)``.  With
``W = Abi @ RU`` left to ``torch.matmul`` (a plain product that JAX leaves to
XLA), :func:`lowrank_schur_update` (``csrc/lowrank_schur_update.cu``) computes

    S[b, i, j] = Abb[b, sperm_i, sperm_j] - sum_k W[b, sperm_i, k] RV[b, sperm_j, k]

reading ``Abb`` in place from the front buffer and storing ``S`` already
permuted.
"""

from __future__ import annotations

import torch

from hsolve_torch import kernels
from hsolve_torch.ops.dense import permute_sym


def lowrank_schur_update_plain(front: torch.Tensor, ni_pad: int, W: torch.Tensor,
                               V: torch.Tensor, sperm: torch.Tensor
                               ) -> torch.Tensor:
    """``permute_sym(Abb - W @ V^T, sperm)`` with ``Abb = front[:, ni_pad:,
    ni_pad:]``; returns a new [B, nb_pad, nb_pad] tensor."""
    Abb = front[:, ni_pad:, ni_pad:]
    return permute_sym(Abb - W @ V.transpose(-1, -2), sperm)


def lowrank_schur_update(front: torch.Tensor, ni_pad: int, W: torch.Tensor,
                         V: torch.Tensor, sperm: torch.Tensor) -> torch.Tensor:
    """Kernel F wrapper (see the plain version).  ``front`` is [B, m_pad,
    m_pad], ``W`` and ``V`` are [B, nb_pad, k_cap], ``sperm`` [B, nb_pad]
    int64."""
    if kernels.on_cpu(front, W, V, sperm):
        return lowrank_schur_update_plain(front, ni_pad, W, V, sperm)
    B, m_pad, _ = front.shape
    nb = m_pad - ni_pad
    kc = W.shape[-1]
    kernels.require(front, "front", torch.float64, (B, m_pad, m_pad))
    kernels.require(W, "W", torch.float64, (B, nb, kc))
    kernels.require(V, "V", torch.float64, (B, nb, kc))
    kernels.require(sperm, "sperm", torch.int64, (B, nb))
    S = torch.empty((B, nb, nb), dtype=front.dtype, device=front.device)
    if B and nb:
        kernels.launch("hs_lowrank_schur_update", front.device, front.data_ptr(),
                       W.data_ptr(), V.data_ptr(), sperm.data_ptr(),
                       S.data_ptr(), B, m_pad, ni_pad, kc)
        lowrank_schur_update.launches += 1
    return S


lowrank_schur_update.launches = 0
