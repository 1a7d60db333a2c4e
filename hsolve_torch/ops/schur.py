"""Schur update of a compressed level: kernel F with its plain version.

On a compressed level the right Gauss transform is the low-rank pair
``R ~= RU RV^T``, and ``hsolve/factor.py:378-379`` forms the permuted Schur
complement as ``permute_sym(Abb - (Abi @ RU) @ RV^T, sperm)``.
:func:`lowrank_schur_update` (``csrc/lowrank_schur_update.cu``) computes all
of it in one kernel,

    W = Abi RU,   S[b, i, j] = Abb[b, sperm_i, sperm_j] - sum_k W[b, sperm_i, k] RV[b, sperm_j, k],

reading ``Abi`` and ``Abb`` in place from the front buffer, keeping ``W`` in
shared memory and storing ``S`` already permuted.  :func:`schur_geometry`
picks its launch from the plan's shapes.  Where neither whole rows nor one
thread block cluster a row band fit (rank caps of several hundred, the 3D
top levels) or a launch has many fronts of wide rows, its float64 form
takes ``W = Abi @ RU`` from one batched GEMM before the launch (as the JAX
package computes it outside any kernel) and the kernel computes only the
second product over gathered rows (the W form, :func:`schur_geometry_w`):
no band's ``W`` is computed twice.  Float64 runs on the FP64 tensor
cores; complex128 (the damped Helmholtz system's low-rank levels), float32
and complex64 (the JAX bench's device configurations; no TF32) take a
kernel of their own on the CUDA cores, one complex multiply-add as four
real FMAs, a float32 one as one (:func:`schur_geometry_cc`).
"""

from __future__ import annotations

import torch

from hsolve_torch import kernels
from hsolve_torch.ops.dense import permute_sym

F_MAX_KD = 64          # the deepest staged chunk of Abi and RU
F_MAX_CLUSTER = 8      # CTAs of a row band's cluster (the portable limit)
F_WHOLE_MAX = 128      # fronts up to this many boundary rows: whole rows
F_CTAS_PER_SM = 2      # the kernel's launch bounds
SMEM_MAX = 232448      # shared memory a CTA can take on Hopper, bytes
H100_SMS = 132


def _up(n: int, m: int = 8) -> int:
    return -(-n // m) * m


def schur_smem(bm: int, bn: int, cs: int, kd: int, kc: int, whole: bool,
               nb: int) -> int:
    """Bytes of shared memory one of kernel F's CTAs takes: W (twice in a
    cluster: its partial and the band's sum), RV's rows, Abb's tile, a
    depth chunk of kd of Abi and RU, the permutation's rows and columns."""
    ldw = _up(kc, 16) + 4
    aw = _up(nb) if whole else bn
    lds = aw + (8 if aw % 16 == 0 else 0)
    values = (bm * ldw * (2 if cs > 1 else 1) + bn * ldw + bm * lds
              + bm * (kd + 4) + kd * ldw)
    return 8 * values + 4 * (bm + bn)


def _fits(bm: int, bn: int) -> bool:
    """A CTA's eight warps tile bm rows and bn columns: bm/16 row blocks of
    16 (the products' m16n8k16 shape), the warps of a row block at most 4
    column blocks of 8 each."""
    return 16 <= bm <= 64 and bm % 16 == 0 and bn % 8 == 0 and \
        bn <= 32 * (8 // (bm // 16))


def schur_geometry(B: int, ni_pad: int, nb: int, kc: int,
                   sms: int = H100_SMS, itemsize: int = 8,
                   is_complex: bool = False) -> dict:
    """Kernel F's launch for ``B`` fronts with ``nb`` boundary rows, depth
    ``ni_pad`` and rank cap ``kc`` on a card of ``sms`` SMs: ``{"bm", "bn",
    "cs", "nct", "kd", "whole", "smem", "w"}``; values other than float64
    (``itemsize`` 16, complex128; 4, float32; 8 with ``is_complex``,
    complex64) take the CUDA-core form's, :func:`schur_geometry_cc`.

    Every float64 form computes each row band's ``W`` once.  Fronts of at
    most ``F_WHOLE_MAX`` boundary rows (the many-front levels) take whole
    rows: a CTA covers a band of ``bm`` rows and every column (``bn`` = nb
    rounded up to 8), one CTA a front where nb <= 64, bands of 32 rows
    above.  Where the launch's row bands of wider fronts do not fill the
    card's SMs twice over (the top levels' few fronts), a band's ``nct``
    column tiles form one thread block cluster of ``cs = nct`` CTAs (at most
    ``F_MAX_CLUSTER``) that split the depth of ``Abi RU`` between them
    (bands of 16 rows where bands of 32 would take at most two waves of the
    card's CTA slots).  ``kd``: the depth of a staged chunk, a multiple of
    16 up to ``F_MAX_KD``; where a rank cap makes the CTA's shared memory
    too large, the chunk and then the tiles shrink.  Every other launch
    (many fronts of wide rows; rank caps whose W a cluster cannot keep
    twice) takes the W form, :func:`schur_geometry_w` (``"w"`` True)."""
    if itemsize != 8 or is_complex:
        return schur_geometry_cc(B, ni_pad, nb, kc, sms, itemsize)
    nbp = _up(nb)
    cands = []
    if nbp <= F_WHOLE_MAX:
        bm = _up(nbp, 16) if nbp <= 64 else 32
        for b_ in (bm, 32, 16):
            if b_ <= bm:
                cands.append((b_, nbp, 1, 1, True))
    elif B * -(-nbp // 32) <= F_CTAS_PER_SM * sms:
        # a cluster launch within two waves of the card's CTA slots at bands
        # of 32 rows (the top levels' 1-4 fronts): bands of 16, which read
        # faster there (tools/f_breakdown.py)
        first = 16 if B * -(-nbp // 32) * min(
            F_MAX_CLUSTER, -(-nbp // 32)) <= 2 * F_CTAS_PER_SM * sms else 32
        for bm in (first, 32, 16):
            for bn_max in (128, 64, 32, 16, 8):
                nct = max(min(F_MAX_CLUSTER, -(-nbp // 32)),
                          -(-nbp // bn_max))
                bn = _up(-(-nbp // nct))
                nct = -(-nbp // bn)
                if nct <= F_MAX_CLUSTER:     # one cluster a band
                    cands.append((bm, bn, nct, nct, False))
    for bm, bn, cs, nct, whole in cands:
        top = min(F_MAX_KD, _up(max(1, -(-ni_pad // cs)), 16))
        for kd in sorted({top, min(top, 32), 16}, reverse=True):
            smem = schur_smem(bm, bn, cs, kd, kc, whole, nb)
            if _fits(bm, bn) and smem <= SMEM_MAX:
                return {"bm": bm, "bn": bn, "cs": cs, "nct": nct, "kd": kd,
                        "whole": whole, "smem": smem, "w": False}
    return schur_geometry_w(nb)


F_W_KD = 32            # the W form: depth of a staged chunk of W and RV


def schur_smem_w(bm: int) -> int:
    """Bytes of shared memory one CTA of the W form takes: two stages of a
    depth chunk of W's ``bm`` rows and RV's ``bm`` (rows of 36 doubles, 4
    mod 16: conflict-free fragments), the permutation's rows and columns."""
    return 8 * 2 * (2 * bm) * (F_W_KD + 4) + 4 * (2 * bm)


def schur_geometry_w(nb: int) -> dict:
    """The W form's launch (``hs_lowrank_schur_update_w``): tiles of ``bm``
    x ``bm`` over depth chunks of 32, ``bm`` = 128 (a warp 32 x 64) unless
    tiles of 64 pad the rows by an eighth less (narrow fronts, e.g. nb
    272: 384 rows against 320)."""
    rows = lambda bm: -(-nb // bm) * bm
    bm = 128 if rows(128) <= 1.125 * rows(64) else 64
    return {"bm": bm, "bn": bm, "cs": 1, "nct": -(-nb // bm),
            "kd": F_W_KD, "whole": False, "smem": schur_smem_w(bm),
            "w": True}


F_C_BM = 32            # the CUDA-core form: rows of a band
F_C_KD = 16            # the CUDA-core form: depth of a staged chunk of Abi and RU


def schur_smem_cc(bn: int, kd: int, kc: int, itemsize: int = 16) -> int:
    """Bytes of shared memory one CTA of kernel F's CUDA-core form takes,
    values of ``itemsize`` bytes (16 complex128, 8 complex64, 4 float32):
    the band's W
    and a column tile's RV rows (rows of ``kc | 1`` values: an odd stride
    keeps a quarter warp's 16-byte reads, a warp's 4-byte ones, on distinct
    banks), a depth chunk of Abi and RU, the permutation's rows and
    columns."""
    ld = kc | 1
    return itemsize * (F_C_BM * ld + bn * ld + F_C_BM * kd + kd * kc) \
        + 4 * (F_C_BM + bn)


def schur_geometry_cc(B: int, ni_pad: int, nb: int, kc: int,
                      sms: int = H100_SMS, itemsize: int = 16) -> dict:
    """Kernel F's launch in its CUDA-core form (complex128, ``itemsize``
    16; complex64, 8; float32, 4): ``{"bm", "bn", "cs", "nct", "kd",
    "whole", "smem", "walk"}``.  A CTA computes ``W = Abi RU`` for a band
    of ``bm`` = 32 rows once, then walks ``walk`` column tiles of ``bn``
    columns (tiles ``x, x + nct, ...``), ``nct`` CTAs a band: as many as
    bring the launch to two CTAs an SM, at most one a tile.  ``bn`` is the
    widest of min(64, nb rounded up to 8), 32, 16 and 8 whose shared memory
    lets two CTAs share an SM, else one; where no tile fits at a depth
    chunk of ``F_C_KD``, the narrowest at half that depth (complex64 at
    the 3D caps of 560).  Raises where no tile fits."""
    top = min(64, _up(nb))
    for kd in (F_C_KD, F_C_KD // 2):
        for limit in ((SMEM_MAX // 2, SMEM_MAX) if kd == F_C_KD
                      else (SMEM_MAX,)):
            for bn in sorted({top, 32, 16, 8}, reverse=True):
                if bn > top:
                    continue
                smem = schur_smem_cc(bn, kd, kc, itemsize)
                if smem <= limit:
                    tiles = -(-nb // bn)
                    bands = B * -(-nb // F_C_BM)
                    nct = max(1, min(tiles,
                                     -(-F_CTAS_PER_SM * sms // bands)))
                    return {"bm": F_C_BM, "bn": bn, "cs": 1, "nct": nct,
                            "kd": kd, "whole": False, "smem": smem,
                            "walk": -(-tiles // nct)}
    raise ValueError(f"kernel F (CUDA-core form, {itemsize}-byte values): no "
                     f"launch fits nb={nb}, kc={kc}")


def lowrank_schur_update_plain(front: torch.Tensor, ni_pad: int,
                               RU: torch.Tensor, RV: torch.Tensor,
                               sperm: torch.Tensor) -> torch.Tensor:
    """``permute_sym(Abb - (Abi @ RU) @ RV^T, sperm)`` with ``Abi =
    front[:, ni_pad:, :ni_pad]`` and ``Abb = front[:, ni_pad:, ni_pad:]``;
    returns a new [B, nb_pad, nb_pad] tensor."""
    Abi = front[:, ni_pad:, :ni_pad]
    Abb = front[:, ni_pad:, ni_pad:]
    return permute_sym(Abb - (Abi @ RU) @ RV.transpose(-1, -2), sperm)


def lowrank_schur_update(front: torch.Tensor, ni_pad: int, RU: torch.Tensor,
                         RV: torch.Tensor, sperm: torch.Tensor) -> torch.Tensor:
    """Kernel F wrapper (see the plain version).  ``front`` is [B, m_pad,
    m_pad], ``RU`` [B, ni_pad, k_cap], ``RV`` [B, nb_pad, k_cap] (float64,
    float32, complex64 or complex128, one type), ``sperm`` [B, nb_pad]
    int64; the launch is
    :func:`schur_geometry`'s for these shapes and this type."""
    if kernels.on_cpu(front, RU, RV, sperm):
        return lowrank_schur_update_plain(front, ni_pad, RU, RV, sperm)
    B, m_pad, _ = front.shape
    nb = m_pad - ni_pad
    kc = RU.shape[-1]
    dt = kernels.lowrank_type(front, RU, RV)
    kernels.require(front, "front", dt, (B, m_pad, m_pad))
    kernels.require(RU, "RU", dt, (B, ni_pad, kc))
    kernels.require(RV, "RV", dt, (B, nb, kc))
    kernels.require(sperm, "sperm", torch.int64, (B, nb))
    S = torch.empty((B, nb, nb), dtype=front.dtype, device=front.device)
    if B and nb:
        g = schur_geometry(B, ni_pad, nb, kc, kernels.sm_count(front.device),
                           front.element_size(), dt.is_complex)
        if g.get("w"):
            # W = Abi RU once, into a scratch the launch reads by rows
            W = torch.bmm(front[:, ni_pad:, :ni_pad], RU)
            kernels.launch("hs_lowrank_schur_update_w", front.device,
                           front.data_ptr(), W.data_ptr(), RV.data_ptr(),
                           sperm.data_ptr(), S.data_ptr(), B, m_pad, ni_pad,
                           kc, g["bm"])
            kernels.count_launch(lowrank_schur_update, dt)
            return S
        kernels.launch(kernels.symbol("hs_lowrank_schur_update", dt),
                       front.device, front.data_ptr(), RU.data_ptr(),
                       RV.data_ptr(), sperm.data_ptr(), S.data_ptr(), B,
                       m_pad, ni_pad, kc, g["bm"], g["bn"], g["cs"],
                       g["nct"], g["kd"], int(g["whole"]))
        kernels.count_launch(lowrank_schur_update, dt)
    return S


lowrank_schur_update.launches = 0
lowrank_schur_update.launches_by_type = {}
