"""The port's driver entry points (``__graft_entry__.py``):
``hsolve_torch.parallel.dryrun.entry`` and ``dryrun_multichip`` on gloo
ranks of the CPU."""

import json

import numpy as np
import torch

from hsolve_torch.parallel.dryrun import dryrun_multichip, entry

torch.set_num_threads(1)


def test_entry_is_one_preconditioned_step():
    fn, (v,) = entry(device="cpu")
    w = fn(v)
    assert w.shape == v.shape and w.dtype == torch.float32
    assert torch.isfinite(w).all()
    # A (F^{-1} v) = v for the exact factor, up to float32
    assert np.linalg.norm((w - v).numpy()) / np.linalg.norm(v.numpy()) < 1e-3


def test_dryrun_multichip_prints_both_lines(capsys):
    out = dryrun_multichip(2, device="cpu", timeout=120)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == out["line1"] and lines[-1] == out["line2"]
    assert lines[-2].startswith(
        "dryrun_multichip(2): mesh={'tree': 1, 'front': 2} exact(relres=")
    assert lines[-2].endswith(") ok")
    # gloo ranks solve with the host-driven program (NCCL ones: the graph)
    assert lines[-2].endswith(" (gmres_host_driven) ok")
    assert out["first"]["solver"] == "gmres_host_driven"
    scaling = json.loads(lines[-1].removeprefix("scaling "))
    assert set(scaling["nnz_per_s_by_mesh"]) == {"1", "2"}
    assert scaling["throughput_vs_1dev"]["1"] == 1.0
    assert scaling["solver_by_mesh"] == {"1": "gmres_host_driven",
                                         "2": "gmres_host_driven"}
    assert 0.0 < scaling["predicted_nvlink_efficiency_h256"]["2"] <= 1.0
    (rel_e, it_e, _, _) = out["first"]["exact"]
    assert rel_e < 1e-4 and it_e < 24
