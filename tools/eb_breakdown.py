#!/usr/bin/env python3
"""Kernels E (``lowrank_sweep_update``) and B (``extend_add``) in several
launch geometries, on one NVIDIA GPU.

E: at launch shapes of the n=512 plans (random U, V and Y of each shape,
sentinel ids), both forms, k = 1, in the geometry the wrapper picks
(``lowrank_sweep_geometry``), that geometry with the other choice of sums
(double-double or plain), and every cluster size from 1 to 16 at 256
threads a CTA and one CTA of 1024 threads a front.  B: at every launch
of the n=512 exact factor (its own Schur stacks), float64 and float32, with
the CTAs per group the wrapper picks (``extend_add_geometry``: 4 CTAs per
SM) and with 1, 2 and 8 per SM.  Every variant is checked against the plain
version (E: 1e-13 relative; B: bitwise).  Times are the device's alone:
the launches queue behind a sleep kernel between two CUDA events
(``utils/profiling.py``'s reading, whose floor, a queued one-element launch,
is printed first).  Run from the repository root:

    python3 tools/eb_breakdown.py [--reps 20] [--no-b | --accuracy]

``--accuracy`` instead holds E and its plain version against a long-double
host reference at every launch shape of the n=512 low-rank and structured
factors, with the update's cancellation (the largest sum of |U t| terms of
a row over the largest |C|).
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hsolve_torch import kernels  # noqa: E402
from hsolve_torch.ops import assembly as AS  # noqa: E402
from hsolve_torch.ops import sweep as SW  # noqa: E402
from hsolve_torch.utils.profiling import _queue_floor, _queued_ms  # noqa: E402

# (B, R, Cc, kc): launches of kernel E on the n=512 low-rank and structured
# plans (forward shapes; the backward ones swap R and Cc)
E_SHAPES = [(1023, 64, 32, 32), (512, 96, 32, 32), (511, 92, 92, 80),
            (256, 128, 64, 48), (255, 124, 124, 112), (128, 192, 64, 48),
            (127, 192, 192, 112), (127, 192, 192, 80), (64, 256, 128, 48),
            (63, 256, 256, 112), (31, 384, 384, 144), (15, 512, 512, 208),
            (7, 768, 768, 272), (3, 768, 768, 400), (1, 512, 512, 48),
            (1, 512, 512, 400), (1, 62, 62, 80), (1, 32, 32, 32)]


def e_operands(dev, B, R, Cc, kc, seed=0):
    rng = np.random.default_rng(seed)
    N = B * (R + Cc) + 5
    perm = rng.permutation(N)
    ids_out = perm[:B * R].reshape(B, R).astype(np.int32)
    ids_in = perm[B * R:B * (R + Cc)].reshape(B, Cc).astype(np.int32)
    ids_out[:, -1] = N
    ids_in[:, -1] = N
    t = lambda a: torch.as_tensor(a, device=dev)
    C = t(rng.standard_normal((N + 1, 1)))
    C[N] = 0.0
    return (N, C, t(ids_out), t(rng.standard_normal((B, R, kc))),
            t(rng.standard_normal((B, Cc, kc))),
            {"X": t(rng.standard_normal((B, Cc, 1)))},
            {"ids_in": t(ids_in)})


def e_variants(B, R, Cc, kc, sms):
    geo = SW.lowrank_sweep_geometry(B, R, Cc, kc, 1, sms)
    vec = geo[4]
    out = [("wrapper", geo),
           (f"wrapper dd={1 - geo[6]}", geo[:6] + (1 - geo[6], geo[7]))]
    for threads in SW.E_THREADS:
        for cs in ((1,) if threads == 1024 else (1, 2, 4, 8, 16)):
            g = (cs, threads, -(-R // cs), -(-Cc // cs), vec, 1, geo[6],
                 SW.lowrank_sweep_smem(threads, vec, 1, kc))
            if g != geo:
                out.append((f"cs={cs} threads={threads}", g))
    return out


def run_e(dev, reps, sms):
    for B, R0, C0_, kc in E_SHAPES:
        for form in ("fwd", "bwd"):
            R, Cc = (R0, C0_) if form == "fwd" else (C0_, R0)
            N, C, ids_out, U, V, fwd, bwd = e_operands(dev, B, R, Cc, kc)
            kw = fwd if form == "fwd" else bwd
            ref = SW.lowrank_sweep_update_plain(C.clone(), ids_out, U, V, N,
                                                **kw)
            line = []
            for name, geo in e_variants(B, R, Cc, kc, sms):
                X, ids_in = kw.get("X"), kw.get("ids_in")
                out = C.clone()
                SW.lowrank_sweep_launch(out, ids_out, U, V, N, X, ids_in, geo)
                err = float((out - ref).abs().max() / ref.abs().max())
                if not err <= 1e-13:
                    print(f"E {form} B={B} R={R} Cc={Cc} kc={kc} {name}: "
                          f"MISMATCH {err:.3e}", flush=True)
                    return 1
                scratch = C.clone()
                ms = _queued_ms(lambda: SW.lowrank_sweep_launch(
                    scratch, ids_out, U, V, N, X, ids_in, geo), reps)
                line.append((ms, name))
            best = min(line)
            print(f"E {form} B={B} R={R} Cc={Cc} kc={kc}: "
                  + "; ".join(f"{n} {m:.5f}" for m, n in line)
                  + f"  | best {best[1]} {best[0]:.5f}", flush=True)
    return 0


def run_b(dev, reps, sms):
    import hsolve_torch as ht
    from hsolve_torch.factor import _factor_levels
    from hsolve_torch.interop import plan_to_torch

    A, _, shape = ht.helmholtz2d(512, k=40.0)
    opts = ht.SolverOptions(swlevel=0)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 opts)
    tp = plan_to_torch(plan, dev)
    for dt in (torch.float64, torch.float32):
        _, _, stacks = _factor_levels(plan, tp, opts, dt)
        adata = tp.adata.to(dt)
        for bidx, (bp, tb) in enumerate(zip(plan.batches, tp.batches)):
            for side, groups, counts, imap in (
                    ("l", tb.groups_l, tb.rows_l, tb.map_l),
                    ("r", tb.groups_r, tb.rows_r, tb.map_r)):
                for (src, sr, dr), rows in zip(groups, counts):
                    S = stacks[src]
                    base = AS.front_assemble_plain(bp.B, bp.m_pad, tb.pos,
                                                   tb.src, adata)
                    ref = AS.extend_add_plain(base.clone(), S, sr, dr, imap)
                    G = sr.numel()
                    line = []
                    for per_sm in (AS.B_CTAS, 1, 2, 8):
                        tiles = -(-rows // min(max(
                            1, rows * G // (per_sm * sms)), rows))
                        trows = -(-rows // tiles)
                        out = base.clone()
                        AS.extend_add_launch(out, S, sr, dr, imap, tiles,
                                             trows)
                        if not torch.equal(out, ref):
                            print(f"B {dt} batch {bidx} {side}: MISMATCH at "
                                  f"{per_sm} CTAs per SM", flush=True)
                            return 1
                        scratch = base.clone()
                        ms = _queued_ms(lambda: AS.extend_add_launch(
                            scratch, S, sr, dr, imap, tiles, trows), reps)
                        line.append(f"{per_sm}/SM (tiles={tiles} "
                                    f"trows={trows}) {ms:.5f}")
                    print(f"B {str(dt)[6:]} batch {bidx} {side} G={G} "
                          f"m={bp.m_pad} rows={rows}: " + "; ".join(line),
                          flush=True)
    return 0


def run_accuracy(dev):
    """E against a long-double host reference at every launch shape of the
    n=512 low-rank and structured factors (k = 1): the kernel's and the
    plain version's largest error over max |ref|, and the cancellation
    max_r sum_i |U_ri t_i| / max |ref| of the update."""
    import hsolve_torch as ht

    A, _, shape = ht.helmholtz2d(512, k=40.0)
    tree = ht.nested_dissection(shape, leafmax=100)
    comp = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3)
    for label, kw in (("low-rank", dict(comp, kest=32, hss=False)),
                      ("structured kest=32", dict(comp, kest=32)),
                      ("structured default caps", comp)):
        opts = ht.SolverOptions(**kw)
        plan = ht.plan_factorization(A, tree, opts)
        F = ht.factor_with_plan(plan, opts, device=dev)
        N = plan.N
        g = torch.Generator(device=dev).manual_seed(1)
        C0 = torch.randn(N + 1, 1, dtype=torch.float64, device=dev,
                         generator=g)
        C0[N] = 0.0
        seen = set()
        for bidx, lev in enumerate(F.levels):
            if getattr(lev, "LU_", None) is None:
                continue
            for form, U, V, ids_out, kw_ in (
                    ("fwd", lev.LU_, lev.LV_, lev.bnd_ids,
                     {"X": C0[lev.int_ids]}),
                    ("bwd", lev.RU_, lev.RV_, lev.int_ids,
                     {"ids_in": lev.bnd_ids})):
                key = (form, *U.shape, V.shape[1])
                if key in seen:
                    continue
                seen.add(key)
                ker = SW.lowrank_sweep_update(C0.clone(), ids_out, U, V, N,
                                              **kw_)
                ref_t = SW.lowrank_sweep_update_plain(C0.clone(), ids_out, U,
                                                      V, N, **kw_)
                Y = kw_["X"] if "X" in kw_ else torch.where(
                    (kw_["ids_in"] < N)[..., None],
                    C0[kw_["ids_in"].clamp(max=N).long()], 0.0)
                Ul = U.cpu().numpy().astype(np.longdouble)
                t = np.einsum("bck,bcr->bkr", V.cpu().numpy().astype(
                    np.longdouble), Y.cpu().numpy().astype(np.longdouble))
                upd = np.einsum("brk,bkr->br", Ul, t)
                mag = np.einsum("brk,bk->br", np.abs(Ul), np.abs(t[..., 0]))
                C = C0.cpu().numpy().astype(np.longdouble)
                out = ids_out.cpu().numpy()
                keep = out < N
                np.subtract.at(C[:, 0], out[keep], upd[keep])
                scale = float(np.abs(C).max())
                e_k = float(np.abs(ker.cpu().numpy() - C).max()) / scale
                e_p = float(np.abs(ref_t.cpu().numpy() - C).max()) / scale
                e_kp = float((ker - ref_t).abs().max()) / scale
                print(f"accuracy {label} batch {bidx} {form} "
                      f"U={list(U.shape)} Cc={V.shape[1]}: kernel "
                      f"{e_k:.2e}, plain {e_p:.2e}, kernel-plain {e_kp:.2e} "
                      f"(of max|C|); cancellation "
                      f"{float(mag.max()) / scale:.2e}", flush=True)
        del F
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-b", action="store_true", help="kernel E only")
    ap.add_argument("--accuracy", action="store_true",
                    help="E and its plain version against a long-double "
                         "reference at every launch shape, instead")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernels.build()
    if args.accuracy:
        return run_accuracy(dev)
    sms = kernels.sm_count(dev)
    print(f"a queued one-element launch: {_queue_floor(dev, args.reps):.5f} "
          "ms on the device", flush=True)
    rc = run_e(dev, args.reps, sms)
    if rc == 0 and not args.no_b:
        rc = run_b(dev, args.reps, sms)
    return rc


if __name__ == "__main__":
    sys.exit(main())
