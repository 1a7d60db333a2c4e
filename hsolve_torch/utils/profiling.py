"""Device-time breakdown of the PyTorch/CUDA port's main path on one GPU.

Usage, from the repository root on a machine with one CUDA card:

    python3 -m hsolve_torch.utils.profiling [--sizes 128 512] [--reps 5]
                                            [--compressed | --hss | --mixed
                                             | --spmv | --hss-kernels
                                             | --sweep-kernels
                                             | --arnoldi-kernels
                                             | --schur-kernels]
                                            [--plain-forward]
                                            [--out build/profile]

For each size n it plans helmholtz2d(n, k=40) with leafmax=100 and swlevel=0
(with ``--compressed``: the low-rank compressed configuration swlevel=-2,
swsize=16, atol=rtol=1e-3, kest=32, hss=False; with ``--hss``: the same with
hss=True, the structured HSS path; with ``--mixed``: swlevel=0 with a
float32 factor inside mixed-precision GMRES, float32 Arnoldi cycles over a
float32 DIA operator with m_eps=1e-6), then times two warm phases,
the numeric factorization and the GMRES solve (reltol 1e-9, the factor as
right preconditioner, the DIA matvec):

- wall time per phase without the profiler (CUDA events around ``reps`` runs),
- device busy time per phase under ``torch.profiler`` (sum of kernel self
  time), and the device idle share 1 - busy / wall,
- the kernels that take the most device time, by name.

``--spmv`` instead times the matvec alone on the device: kernel D
(``dia_spmv``) and cuSPARSE's CSR ``torch.mv`` on the same x, in float32 and
float64, as the sum of their kernels' device time under the profiler over
``--reps`` back-to-back calls (at least 100), so no host time is in the
reading.

``--hss-kernels`` times kernels J (``hss_matvec``) and I
(``hss_entries_prepared``) and their plain versions alone, device time only,
at the first shapes ``chip_smoke.py`` checks them at (the kest=32 n=512
plan's first structured batch: 511 matrices of 2 leaves of 23 rows, rank 32;
J at k = 46, the sketch width, and k = 1; I on the leaf blocks and on one
level-1 coupling block a matrix), on random generators of those shapes.

``--sweep-kernels`` times kernels E (``lowrank_sweep_update``) and B
(``extend_add``) and their plain versions alone, device time only, at every
launch shape the n-plans give them: E in both forms (forward, ``X`` given;
backward, ``ids_in``) at k = 1 on the levels of a low-rank factor and of the
two structured factors (kest=32 and the default rank caps), B at every
launch of the exact factor in float64 and float32, on the factors' own
operands.  A kernel is read with its launches queued behind a sleep kernel
between two CUDA events (the device runs them back to back; the reading
holds the launches' gaps on the device, printed first as the time of a
queued one-element launch, and no host time); a plain version (which waits
for the device inside) as its kernels' time under the profiler, one
session per plan and type.  Each shape's numbers, with its bound (bytes
over 3.35 TB/s against operations over the data sheet's peak), go to
``<out>/sweep_kernels.json``, and a summary per plan and kernel is
printed.

``--arnoldi-kernels`` reads one Arnoldi step on the device at j = 0, 14
and 29, with the loop going on (cont) and ending (done), in float64 and
float32, on the states of a 30-step cycle on the n-operator: as three
launches (kernel L alone, kernel M alone, the division into ``V[j+1]``) and,
where the tree has ``arnoldi_step``, as its one launch; each queued as
``--sweep-kernels`` queues, and the host ms per step of the wrappers over
200 calls (a host clock).  Under the profiler it counts the kernels one
step launches in each form.  ``--schur-kernels`` reads kernel F at every
launch shape of the n-plans' compressed factors (low-rank, structured
kest=32, structured default caps), on the factor's own inputs: where the
tree's F takes ``W`` (the earlier design), the bmm that forms it and F;
else F alone (``tools/f_breakdown.py`` reads the launches its geometry
passes over).  Both run unchanged in a checkout of an earlier tree (copy
this file in), so the two designs can be read in one call: a JSON report
each, ``<out>/arnoldi_kernels.json`` and ``<out>/schur_kernels.json``.

``--plain-forward`` runs each dense level's forward step as its plain torch
version (the gather, GEMM, index_put and triangular solves that kernel C's
``level_forward`` replaces), to compare the two on the same factor.

Chrome traces go to ``--out``; the last line of output is one JSON object with
every number printed above.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _events_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _profile(fn, reps, trace):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    rows = []
    for e in prof.key_averages():
        t = e.self_device_time_total
        if t > 0 and e.device_type.name == "CUDA":   # kernels, not the host ops
            rows.append({"name": e.key, "ms": t / 1e3 / reps,
                         "calls": e.count / reps})
    rows.sort(key=lambda r: -r["ms"])
    return rows


def _spmv(args, card, dev) -> int:
    """``--spmv``: device ms per call of kernel D and of the CSR ``mv``."""
    import numpy as np
    import torch

    import hsolve_torch as ht
    from hsolve_torch.ops.sparse import dia_spmv

    reps = max(args.reps, 100)
    report = {"card": card, "path": "spmv", "reps": reps, "sizes": []}
    for n in args.sizes:
        A, _, _ = ht.helmholtz2d(n, k=40.0)
        Ac = A.tocsr()
        entry = {"n": n, "N": int(A.shape[0]), "nnz": int(Ac.nnz)}
        for dname in ("float32", "float64"):
            dt = getattr(torch, dname)
            op, _ = ht.spmv_format(A, dtype=np.dtype(dname), device=dev)
            csr = torch.sparse_csr_tensor(
                torch.as_tensor(Ac.indptr.astype(np.int64)),
                torch.as_tensor(Ac.indices.astype(np.int64)),
                torch.as_tensor(Ac.data), size=Ac.shape).to(device=dev, dtype=dt)
            x = torch.randn(A.shape[0], 1, dtype=dt, device=dev)
            for name, fn in (("dia_spmv", lambda: dia_spmv(op, x)),
                             ("csr_mv", lambda: torch.mv(csr, x[:, 0]))):
                fn()
                rows = _profile(fn, reps, os.path.join(
                    args.out, f"spmv_n{n}_{name}_{dname}.json"))
                ms = sum(r["ms"] for r in rows)
                entry[f"{name}:{dname}"] = {"device_ms": ms, "kernels": rows}
                print(f"spmv n={n} {name} {dname}: {ms:.5f} ms device per call "
                      f"({', '.join(r['name'][:40] for r in rows)})", flush=True)
        report["sizes"].append(entry)
    print(json.dumps(report), flush=True)
    return 0


def _hss_kernels(args, card, dev) -> int:
    """``--hss-kernels``: device ms per call of J and I and of their plain
    versions at chip_smoke's first shapes."""
    import torch

    from hsolve_torch.ops import hss as H

    reps = max(args.reps, 100)
    B, depth, ls, r = 511, 1, 23, 32
    nl = 1 << depth
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn((B,) + s, dtype=torch.float64, device=dev,
                                 generator=g)
    h = H.Hss(D=rnd(nl, ls, ls), U=rnd(nl, ls, r), V=rnd(nl, ls, r),
              Rs=[rnd(2, r, r)], Ws=[rnd(2, r, r)], B12s=[rnd(1, r, r)],
              B21s=[rnd(1, r, r)],
              plan=H.ClusterPlan(ls=ls, depth=depth, n1=ls, n2=ls))
    ef = H.hss_entry_factors(h)
    n = nl * ls
    leaf = torch.arange(n, device=dev).reshape(1, nl, ls).expand(B, -1, -1) \
        .contiguous()
    rows = torch.randint(0, ls, (B, 1, r), device=dev, generator=g)
    cols = ls + torch.randint(0, ls, (B, 1, r), device=dev, generator=g)
    cases = []
    for k in (46, 1):
        x = torch.randn(B, n, k, dtype=torch.float64, device=dev, generator=g)
        cases += [(f"hss_matvec k={k}", lambda x=x: H.hss_matvec(h, x)),
                  (f"hss_matvec_plain k={k}",
                   lambda x=x: H.hss_matvec_plain(h, x))]
    for what, rr, cc in (("leaf D", leaf, leaf), ("B12", rows, cols)):
        cases += [(f"hss_entries_prepared {what}",
                   lambda rr=rr, cc=cc: H.hss_entries_prepared(ef, rr, cc)),
                  (f"hss_entries_prepared_plain {what}",
                   lambda rr=rr, cc=cc: H.hss_entries_prepared_plain(ef, rr, cc))]
    report = {"card": card, "path": "hss-kernels", "reps": reps,
              "shape": {"B": B, "nleaves": nl, "ls": ls, "r": r}, "calls": {}}
    for name, fn in cases:
        fn()
        rows_ = _profile(fn, reps, os.path.join(
            args.out, f"hss_kernels_{name.replace(' ', '_')}.json"))
        ms = sum(r_["ms"] for r_ in rows_)
        report["calls"][name] = {"device_ms": ms, "wall_ms": _events_ms(fn, reps),
                                 "kernels": rows_}
        print(f"{name}: {ms:.5f} ms device per call, "
              f"{report['calls'][name]['wall_ms']:.5f} ms back to back "
              f"({len(rows_)} kernels)", flush=True)
    print(json.dumps(report), flush=True)
    return 0


HBM_BPS = 3.35e12          # H100 SXM device memory (the data sheet)
PEAK_F64_TC = 67e12        # float64 on the tensor cores (the data sheet)


def _bound_ms(nbytes, flops, peak=PEAK_F64_TC):
    """The larger of bytes over the memory rate and operations over the
    peak, in ms, and which of the two it is."""
    tb, tf = nbytes / HBM_BPS, flops / peak
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def _labelled_ms(cases, reps):
    """Device ms per call of each plain version in ``cases`` (``[(label,
    fn)]``): one profiler session over all of them, each case's ``reps``
    calls inside a ``record_function`` range of its label, the kernels
    launched under the range summed (None where none was recorded).  One
    session, not one per case: on the H100 the profiler recorded no kernel
    after a few dozen sessions in one process."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for _, fn in cases:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, fn in cases:
            with record_function(label):
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
    total = {}
    for e in prof.events():
        if e.device_type.name == "CPU":
            total[e.name] = total.get(e.name, 0.0) + e.device_time_total
    return {label: total[label] / 1e3 / reps if total.get(label) else None
            for label, _ in cases}


def _queued_ms(fn, reps):
    """Device ms per call of ``fn`` (a kernel wrapper that never waits for
    the device): ``reps`` calls between two CUDA events, queued behind a
    sleep kernel that outlasts the host's launches, so the device runs them
    back to back and no host time is in the reading (the launches' own gaps
    on the device are; :func:`_queue_floor` reads them)."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 2_000_000
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()     # the device was still asleep: no gaps
        end.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("the host's launches did not get ahead of the device")


def _plain_into(rows, plains, reps):
    """Each row's ``plain_ms``: its plain version's device time, all of
    them read in one profiler session (:func:`_labelled_ms`)."""
    got = _labelled_ms(plains, reps)
    for r, (label, _) in zip(rows, plains, strict=True):
        r["plain_ms"] = got[label]


def _ms(x):
    return "not read" if x is None else f"{x:.5f}"


def _queue_floor(dev, reps):
    """ms per launch of a one-element kernel queued as :func:`_queued_ms`
    queues: the least a queued launch takes on the device."""
    import torch

    x = torch.zeros(1, device=dev)
    return _queued_ms(x.zero_, reps)


def _sweep_kernels(args, card, dev) -> int:
    """``--sweep-kernels``: device ms of kernels E and B and of their plain
    versions at every launch shape of the n-plans."""
    import torch

    import hsolve_torch as ht
    from hsolve_torch.factor import _factor_levels
    from hsolve_torch.interop import plan_to_torch
    from hsolve_torch.ops.assembly import (extend_add, extend_add_plain,
                                           front_assemble_plain)
    from hsolve_torch.ops.sweep import (lowrank_sweep_update,
                                        lowrank_sweep_update_plain)

    reps = max(args.reps, 20)
    floor = _queue_floor(dev, reps)
    print(f"a queued one-element launch: {floor:.5f} ms on the device",
          flush=True)
    comp = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3)
    configs = (("low-rank", dict(comp, kest=32, hss=False)),
               ("structured kest=32", dict(comp, kest=32)),
               ("structured default caps", comp))
    report = {"card": card, "path": "sweep-kernels", "reps": reps,
              "queue_floor_ms": floor, "sizes": []}
    summary = []
    for n in args.sizes:
        A, _, shape = ht.helmholtz2d(n, k=40.0)
        tree = ht.nested_dissection(shape, leafmax=100)
        entry = {"n": n, "E": [], "B": []}
        g = torch.Generator(device=dev).manual_seed(0)
        for label, kw in configs:
            opts = ht.SolverOptions(**kw)
            plan = ht.plan_factorization(A, tree, opts)
            F = ht.factor_with_plan(plan, opts, device=dev)
            N = plan.N
            C0 = torch.randn(N + 1, 1, dtype=torch.float64, device=dev,
                             generator=g)
            C0[N] = 0.0
            seen, plains = set(), []
            for bidx, lev in enumerate(F.levels):
                if getattr(lev, "LU_", None) is None:
                    continue
                x = C0[lev.int_ids]
                for form, U, V, ids_out, kwe in (
                        ("fwd", lev.LU_, lev.LV_, lev.bnd_ids, {"X": x}),
                        ("bwd", lev.RU_, lev.RV_, lev.int_ids,
                         {"ids_in": lev.bnd_ids})):
                    B, R, kc = U.shape
                    Cc = V.shape[1]
                    key = (form, B, R, Cc, kc)
                    if key in seen:
                        continue
                    seen.add(key)
                    C = C0.clone()
                    ms = _queued_ms(lambda: lowrank_sweep_update(
                        C, ids_out, U, V, N, **kwe), reps)
                    plains.append((f"E plain {len(plains)}",
                                   lambda C=C, o=ids_out, U=U, V=V, kwe=kwe:
                                   lowrank_sweep_update_plain(C, o, U, V, N,
                                                              **kwe)))
                    nbytes = sum(t.numel() * t.element_size() for t in
                                 (U, V, ids_out, *kwe.values())) \
                        + 2 * B * R * 8 + (B * Cc * 8 if "ids_in" in kwe else 0)
                    bms, by = _bound_ms(nbytes, 2 * B * kc * (R + Cc))
                    entry["E"].append({"plan": label, "batch": bidx,
                                       "form": form, "B": B, "R": R, "Cc": Cc,
                                       "kc": kc, "ms": ms, "bound_ms": bms,
                                       "bound_by": by})
            _plain_into(entry["E"][-len(plains):], plains, reps)
            for r in entry["E"][-len(plains):]:
                print(f"E {label} batch {r['batch']} {r['form']} B={r['B']} "
                      f"R={r['R']} Cc={r['Cc']} kc={r['kc']}: {r['ms']:.5f} ms "
                      f"device (plain {_ms(r['plain_ms'])}, bound "
                      f"{r['bound_ms']:.5f} {r['bound_by']})", flush=True)
            del F
        opts = ht.SolverOptions(swlevel=0)
        plan = ht.plan_factorization(A, tree, opts)
        tp = plan_to_torch(plan, dev)
        for dname in ("float64", "float32"):
            dt = getattr(torch, dname)
            e = torch.empty(0, dtype=dt).element_size()
            _, _, stacks = _factor_levels(plan, tp, opts, dt)
            adata = tp.adata.to(dt)
            plains = []
            for bidx, (bp, tb) in enumerate(zip(plan.batches, tp.batches)):
                front = None
                for side, groups, counts, imap in (
                        ("l", tb.groups_l, tb.rows_l, tb.map_l),
                        ("r", tb.groups_r, tb.rows_r, tb.map_r)):
                    for (src, sr, dr), cnt_plan in zip(groups, counts):
                        if front is None:
                            front = front_assemble_plain(bp.B, bp.m_pad, tb.pos,
                                                         tb.src, adata)
                        S = stacks[src]
                        rows = imap[dr.long()]
                        cnt = ((rows >= 0) & (rows < S.shape[-1])).sum(1)
                        c2 = float((cnt.double() ** 2).sum())
                        ms = _queued_ms(lambda: extend_add(
                            front, S, sr, dr, imap, cnt_plan), reps)
                        plains.append((f"B plain {len(plains)}",
                                       lambda f=front, S=S, sr=sr, dr=dr,
                                       mp=imap: extend_add_plain(f, S, sr, dr,
                                                                 mp)))
                        bms, by = _bound_ms(
                            3 * c2 * e + 4 * (rows.numel() + 2 * sr.numel()),
                            c2, 67e12 if dname == "float32" else 34e12)
                        entry["B"].append({
                            "dtype": dname, "batch": bidx, "side": side,
                            "groups": int(sr.numel()), "m": bp.m_pad,
                            "w": int(S.shape[-1]),
                            "valid_rows": [int(cnt.min()), int(cnt.max())],
                            "ms": ms, "bound_ms": bms, "bound_by": by})
            _plain_into(entry["B"][-len(plains):], plains, reps)
            for r in entry["B"][-len(plains):]:
                print(f"B {dname} batch {r['batch']} {r['side']} "
                      f"G={r['groups']} m={r['m']} w={r['w']} valid rows "
                      f"{r['valid_rows'][0]}-{r['valid_rows'][1]}: "
                      f"{r['ms']:.5f} ms device (plain {_ms(r['plain_ms'])}, "
                      f"bound {r['bound_ms']:.5f} {r['bound_by']})",
                      flush=True)
            del stacks
        for kname, key, groups in (
                ("E", "plan", [c[0] for c in configs]),
                ("B", "dtype", ["float64", "float32"])):
            for grp in groups:
                rows_ = [r for r in entry[kname] if r[key] == grp]
                if not rows_:
                    continue
                tot = {f: sum(r[f] for r in rows_ if r[f] is not None)
                       for f in ("ms", "plain_ms", "bound_ms")}
                lost = sum(r["plain_ms"] is None for r in rows_)
                half = sum(r["ms"] <= 2 * r["bound_ms"] for r in rows_)
                line = (f"{kname} n={n} {grp}: {len(rows_)} shapes, ms "
                        f"{min(r['ms'] for r in rows_):.5f}-"
                        f"{max(r['ms'] for r in rows_):.5f}, sum "
                        f"{tot['ms']:.5f} against plain {tot['plain_ms']:.5f} "
                        f"and bound {tot['bound_ms']:.5f}; within 2x of the "
                        f"bound at {half}; slower than plain at "
                        f"{sum(r['ms'] > (r['plain_ms'] or 1e9) for r in rows_)}"
                        + (f"; plain not read at {lost}" if lost else ""))
                summary.append(line)
                print(line, flush=True)
        report["sizes"].append(entry)
    path = os.path.join(args.out, "sweep_kernels.json")
    with open(path, "w") as f:
        json.dump(report, f)
    print(json.dumps({"card": card, "path": "sweep-kernels", "report": path,
                      "summary": summary}), flush=True)
    return 0


def _host_ms(fn, calls=200):
    """Host ms per call of ``fn`` (a wrapper that never waits for the
    device): a host clock over ``calls`` calls, the device drained before
    and after."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def _arnoldi_kernels(args, card, dev) -> int:
    """``--arnoldi-kernels``: device ms of one Arnoldi step at j = 0, 14 and
    29, cont and done, float64 and float32, on states of a 30-step cycle on
    the n-operator: as three launches (kernel L, kernel M, the division) and,
    where the tree has it, as one (``arnoldi_step``); the kernels a step
    launches, counted under the profiler; the host ms per step of the
    wrappers."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import hsolve_torch as ht
    from hsolve_torch.ops import arnoldi as AR

    reps = max(args.reps, 20)
    floor = _queue_floor(dev, reps)
    print(f"a queued one-element launch: {floor:.5f} ms on the device",
          flush=True)
    fused = hasattr(AR, "arnoldi_step")
    clone = lambda s: dataclasses.replace(s, **{
        f.name: getattr(s, f.name).clone() for f in dataclasses.fields(s)})
    report = {"card": card, "path": "arnoldi-kernels", "reps": reps,
              "queue_floor_ms": floor, "fused": fused, "rows": []}
    steps, m = (0, 14, 29), 30
    for n in args.sizes:
        A, b, _ = ht.helmholtz2d(n, k=40.0)
        for dname in ("float64", "float32"):
            dt = getattr(torch, dname)
            op, mv_fn = ht.spmv_format(A, dtype=np.dtype(dname), device=dev)
            mv = lambda v: mv_fn(op, v)
            bt = torch.as_tensor(np.asarray(b), device=dev).to(dt)
            N = bt.shape[0]
            s = AR.arnoldi_state(m, N, dt, dev)
            beta = float(torch.linalg.vector_norm(bt))
            s.V[0] = bt / beta
            s.g[0] = beta
            states = {}
            for j in range(max(steps) + 1):
                w = mv(s.V[j]).contiguous()
                if j in steps:
                    states[j] = (clone(s), w.clone())
                AR.arnoldi_cgs2_plain(s, w, j)
                AR.arnoldi_givens_plain(s, j, 0.0, True)
                torch.div(w, s.st[1], out=s.V[j + 1])
            if n == args.sizes[0] and dname == "float64":
                # the kernels one step launches, under the profiler
                s0, w0 = states[0]
                ss, sw = clone(s0), w0.clone()
                forms = [("three", lambda: (
                    AR.arnoldi_cgs2(ss, sw, 0), AR.arnoldi_givens(ss, 0, 0.0,
                                                                  True),
                    torch.div(sw, ss.st[1], out=ss.V[1])))]
                if fused:
                    forms.append(("one", lambda: AR.arnoldi_step(
                        ss, sw, 0, 0.0, True)))
                for label, fn in forms:
                    fn()
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(10):
                            fn()
                        torch.cuda.synchronize()
                    names = {}
                    for e in prof.events():
                        if e.device_type.name == "CUDA" and \
                                e.device_time_total > 0:
                            names[e.name] = names.get(e.name, 0) + 1
                    per = sum(names.values()) / 10
                    report[f"kernels_per_step_{label}"] = per
                    print(f"step as {label}: {per:g} kernels a step "
                          f"({sorted(names)})", flush=True)
            for j in steps:
                s0, w0 = states[j]
                for cont in (True, False):
                    # a floor of -1 keeps a repeated step going (cont),
                    # however far its residual estimate falls
                    row = {"n": n, "dtype": dname, "j": j, "cont": cont,
                           "done": int(not cont)}
                    ss, sw = clone(s0), w0.clone()

                    def three():
                        AR.arnoldi_cgs2(ss, sw, j)
                        AR.arnoldi_givens(ss, j, -1.0, cont)
                        torch.div(sw, ss.st[1], out=ss.V[j + 1])

                    row["three_ms"] = _queued_ms(three, reps)
                    row["three_host_ms"] = _host_ms(three)
                    if fused:
                        step = lambda: AR.arnoldi_step(ss, sw, j, -1.0, cont)
                        row["one_ms"] = _queued_ms(step, reps)
                        row["one_host_ms"] = _host_ms(step)
                    if int(ss.done[0]) != row["done"]:
                        raise RuntimeError(f"step j={j} cont={cont}: done flag "
                                           f"{int(ss.done[0])}")
                    report["rows"].append(row)
                    print(f"n={n} {dname} j={j} cont={int(cont)} done="
                          f"{row['done']}: L + M + division "
                          f"{row['three_ms']:.5f} ms device, "
                          f"{row['three_host_ms']:.5f} ms host"
                          + (f"; one launch {row['one_ms']:.5f} ms device, "
                             f"{row['one_host_ms']:.5f} ms host"
                             if fused else ""), flush=True)
            del s, states
    path = os.path.join(args.out, "arnoldi_kernels.json")
    with open(path, "w") as f:
        json.dump(report, f)
    print(json.dumps({"card": card, "path": "arnoldi-kernels",
                      "report": path}), flush=True)
    return 0


def _schur_kernels(args, card, dev) -> int:
    """``--schur-kernels``: device ms of kernel F at every launch shape of
    the n-plans' compressed factors (low-rank, structured kest=32,
    structured default caps), on the inputs the factor gives it: where the
    tree's F takes ``W`` (the earlier design), the bmm ``W = Abi RU`` and F;
    where it takes ``RU``, F alone in the launch its wrapper picks."""
    import importlib
    import inspect

    import torch

    import hsolve_torch as ht
    from hsolve_torch.ops import schur

    reps = max(args.reps, 20)
    floor = _queue_floor(dev, reps)
    print(f"a queued one-element launch: {floor:.5f} ms on the device",
          flush=True)
    takes_w = "W" in inspect.signature(schur.lowrank_schur_update).parameters
    fm = importlib.import_module("hsolve_torch.factor")
    comp = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3)
    configs = (("low-rank", dict(comp, kest=32, hss=False)),
               ("structured kest=32", dict(comp, kest=32)),
               ("structured default caps", comp))
    report = {"card": card, "path": "schur-kernels", "reps": reps,
              "queue_floor_ms": floor,
              "design": "bmm + F" if takes_w else "F", "rows": []}
    for n in args.sizes:
        A, _, shape = ht.helmholtz2d(n, k=40.0)
        tree = ht.nested_dissection(shape, leafmax=100)
        for label, kw in configs:
            opts = ht.SolverOptions(**kw)
            plan = ht.plan_factorization(A, tree, opts)
            calls = {}
            orig = fm._factor_front_compressed

            def rec(front, sperm, ni_pad, *rest):
                out = orig(front, sperm, ni_pad, *rest)
                key = (front.shape[0], front.shape[1], ni_pad,
                       out[4].shape[-1])
                if key not in calls:
                    calls[key] = (front.clone(), ni_pad, out[4], out[5], sperm)
                return out

            fm._factor_front_compressed = rec
            try:
                ht.factor_with_plan(plan, opts, device=dev)
            finally:
                fm._factor_front_compressed = orig
            torch.cuda.synchronize()
            for (B, m_pad, ni_pad, kc), (front, _, RU, RV, sperm) in sorted(
                    calls.items(), key=lambda kv: -kv[0][0]):
                nb = m_pad - ni_pad
                Abi = front[:, ni_pad:, :ni_pad]
                if takes_w:
                    fn = lambda: schur.lowrank_schur_update(
                        front, ni_pad, (Abi @ RU).contiguous(), RV, sperm)
                else:
                    fn = lambda: schur.lowrank_schur_update(front, ni_pad, RU,
                                                            RV, sperm)
                nbytes = 8 * B * (2 * nb * nb + nb * ni_pad + ni_pad * kc
                                  + nb * kc + nb)
                bms, by = _bound_ms(nbytes, 2 * B * kc * nb * (ni_pad + nb))
                row = {"plan": label, "n": n, "B": B, "nb": nb,
                       "ni_pad": ni_pad, "kc": kc, "ms": _queued_ms(fn, reps),
                       "bound_ms": bms, "bound_by": by}
                if not takes_w:
                    row["geometry"] = schur.schur_geometry(B, ni_pad, nb, kc)
                report["rows"].append(row)
                print(f"F {label} [{B},{nb},{nb}] ni={ni_pad} k={kc}: "
                      f"{report['design']} {row['ms']:.5f} ms device, "
                      f"bound {bms:.5f} {by}", flush=True)
            del calls
    path = os.path.join(args.out, "schur_kernels.json")
    with open(path, "w") as f:
        json.dump(report, f)
    print(json.dumps({"card": card, "path": "schur-kernels", "report": path}),
          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[128, 512])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--compressed", action="store_true",
                      help="profile the low-rank compressed configuration")
    mode.add_argument("--hss", action="store_true",
                      help="profile the structured (HSS) compressed "
                           "configuration")
    mode.add_argument("--mixed", action="store_true",
                      help="profile the float32 exact factor with "
                           "mixed-precision GMRES")
    mode.add_argument("--spmv", action="store_true",
                      help="device time of kernel D and of the CSR matvec")
    mode.add_argument("--hss-kernels", action="store_true",
                      help="device time of kernels J and I and their plain "
                           "versions")
    mode.add_argument("--sweep-kernels", action="store_true",
                      help="device time of kernels E and B and their plain "
                           "versions at every launch shape")
    mode.add_argument("--arnoldi-kernels", action="store_true",
                      help="device time of the Arnoldi step: L + M + the "
                           "division, and the one launch")
    mode.add_argument("--schur-kernels", action="store_true",
                      help="device time of kernel F at every launch shape")
    ap.add_argument("--plain-forward", action="store_true",
                    help="dense levels' forward step as its plain version")
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profiling: no CUDA device", file=sys.stderr)
        return 2
    import importlib

    import hsolve_torch as ht
    from hsolve_torch import kernels
    from hsolve_torch.factor import solve_with_data
    from hsolve_torch.ops.sweep import level_forward_plain

    if args.plain_forward:      # hsolve_torch.factor is the function's name
        importlib.import_module("hsolve_torch.factor").level_forward = \
            level_forward_plain

    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    kernels.build()
    if args.spmv:
        return _spmv(args, card, dev)
    if args.hss_kernels:
        return _hss_kernels(args, card, dev)
    if args.sweep_kernels:
        return _sweep_kernels(args, card, dev)
    if args.arnoldi_kernels:
        return _arnoldi_kernels(args, card, dev)
    if args.schur_kernels:
        return _schur_kernels(args, card, dev)
    path = "hss" if args.hss else "compressed" if args.compressed else \
        "exact-f32-mixed" if args.mixed else "exact"
    report = {"card": card, "path": path,
              "forward": "plain" if args.plain_forward else "kernel",
              "sizes": []}
    for n in args.sizes:
        A, b, shape = ht.helmholtz2d(n, k=40.0)
        opts = ht.SolverOptions(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3,
                                kest=32, hss=args.hss) \
            if path in ("compressed", "hss") else ht.SolverOptions(swlevel=0)
        plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                     opts)
        fdt = torch.float32 if args.mixed else torch.float64
        holder = {"F": ht.factor_with_plan(plan, opts, dtype=fdt, device=dev)}
        op, mv = ht.spmv_format(A, device=dev)
        bt = torch.as_tensor(np.asarray(b), device=dev)
        prec, inner = solve_with_data, {}
        if args.mixed:
            prec = lambda data, v: solve_with_data(
                data, v.to(torch.float32)).to(v.dtype)
            inner = dict(inner_dtype="float32", m_eps=1e-6, mv_data_inner=(
                ht.spmv_format(A, dtype=np.float32, device=dev)[0]))

        def factor():
            holder["F"] = ht.factor_with_plan(plan, opts, dtype=fdt, device=dev)

        def solve():
            holder["x"], holder["info"] = ht.gmres_compiled(
                mv, prec, bt, reltol=1e-9, restart=30, maxiter=60,
                mv_data=op, M_data=holder["F"].solve_data, **inner)

        entry = {"n": n, "N": int(A.shape[0]), "phases": {}}
        for name, fn in (("factor", factor), ("solve", solve)):
            wall = _events_ms(fn, args.reps)
            rows = _profile(fn, args.reps,
                            os.path.join(args.out, f"{path}_n{n}_{name}.json"))
            busy = sum(r["ms"] for r in rows)
            entry["phases"][name] = {
                "wall_ms": wall, "device_busy_ms": busy,
                "idle_share": 1.0 - busy / wall if wall > 0 else None,
                "top": rows[:args.top]}
            print(f"{path} n={n} {name}: wall {wall:.3f} ms, device busy "
                  f"{busy:.3f} ms, "
                  f"idle share {1.0 - busy / wall:.3f}", flush=True)
            for r in rows[:args.top]:
                print(f"    {r['ms']:9.4f} ms  {r['calls']:7.1f} calls  "
                      f"{r['name'][:110]}", flush=True)
        entry["iters"] = holder["info"]["iters"]
        print(f"{path} n={n}: {entry['iters']} GMRES iterations "
              f"({report['forward']} forward step)", flush=True)
        report["sizes"].append(entry)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
