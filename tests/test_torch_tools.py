"""The sweep profiler's trace arithmetic, on a hand-made chrome trace."""

import json

import pytest

from mcmcdate_tpu_torch.tools.profile_sweep import _union, trace_summary


@pytest.mark.parametrize("intervals, total", [
    ([], 0.0),
    ([(0, 2), (1, 3)], 3.0),  # overlapping rows count once
    ([(5, 6), (0, 1), (5.5, 5.7)], 2.0),  # nested and unsorted
    ([(0, 1), (1, 2)], 2.0),  # touching
])
def test_union(intervals, total):
    assert _union(intervals) == pytest.approx(total)


def test_trace_summary(tmp_path):
    ev = [
        dict(ph="X", cat="user_annotation", name="sweep", ts=100, dur=100),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=101, dur=1),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=103, dur=1),
        dict(ph="X", cat="cuda_driver", name="cuLaunchKernel", ts=105, dur=1),
        dict(ph="X", cat="cuda_runtime", name="cudaMemcpyAsync", ts=106, dur=1),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=250, dur=1),  # outside
        dict(ph="X", cat="kernel", name="(anonymous namespace)::prior_terms_kernel(PriorArgs)",
             ts=110, dur=10),
        dict(ph="X", cat="kernel", name="void elementwise_kernel<...>", ts=115, dur=10),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoD", ts=190, dur=20),  # clipped at 200
        dict(ph="X", cat="kernel", name="accept_select_kernel", ts=300, dur=5),  # outside
        dict(ph="i", cat="kernel", name="marker", ts=120),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = trace_summary(str(path))
    assert s["launches"] == 3
    assert s["device_events"] == 3
    assert s["sweep_host_s"] == pytest.approx(100e-6)
    assert s["device_sum_s"] == pytest.approx(40e-6)
    assert s["device_busy_s"] == pytest.approx(25e-6)
    assert s["busy_share"] == pytest.approx(0.25)
    assert s["port_kernels"]["prior_terms_kernel"] == dict(calls=1, device_s=pytest.approx(1e-5),
                                                           us_per_call=10.0)
    assert s["port_kernels"]["accept_select_kernel"]["calls"] == 0


def test_trace_summary_phases(tmp_path):
    """Device time goes to the phase whose host span holds its launch."""
    ev = [
        dict(ph="X", cat="user_annotation", name="sweep", ts=0, dur=100),
        dict(ph="X", cat="user_annotation", name="glob", ts=10, dur=20),
        dict(ph="X", cat="user_annotation", name="range", ts=40, dur=30),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=12, dur=1,
             args=dict(correlation=1)),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=45, dur=1,
             args=dict(correlation=2)),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=80, dur=1,
             args=dict(correlation=3)),
        # launched in glob, runs during range: still glob's
        dict(ph="X", cat="kernel", name="a", ts=50, dur=7, args=dict(correlation=1)),
        dict(ph="X", cat="kernel", name="b", ts=60, dur=5, args=dict(correlation=2)),
        dict(ph="X", cat="kernel", name="c", ts=85, dur=2, args=dict(correlation=3)),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    ph = trace_summary(str(path))["phases"]
    assert ph["glob"] == dict(host_s=pytest.approx(20e-6), launches=1,
                              device_s=pytest.approx(7e-6), launches_by_kernel={"a": 1})
    assert ph["range"] == dict(host_s=pytest.approx(30e-6), launches=1,
                               device_s=pytest.approx(5e-6), launches_by_kernel={"b": 1})


def test_fast_sweep_carry_check_on_cpu():
    """The per-phase carry check of the batched sweep, on a small float64
    model on the CPU: every carried quantity equals its direct value."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch import synthetic
    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.engine.chains import ChainRunner, RunSettings
    from mcmcdate_tpu_torch.tools.profile_sweep import check_carry_fast

    model, batch = synthetic.build(10, 1, dtype=torch.float64, device="cpu")
    table = P.build_proposal_table(model.topo, model.braces, False)
    runner = ChainRunner(model, table, RunSettings("t", n_chains=8, seed=1, dtype="float64",
                                                   device="cpu"), log=lambda *a: None)
    b, tuning = runner.init_chains(batch)
    out = check_carry_fast(runner, b, tuning, 3)
    assert set(out["max_abs_err"]) == {"seq", "glob", "point", "range"}
    for phase, errs in out["max_abs_err"].items():
        err = {k: v for k, v in errs.items() if not k.endswith("_scale")}
        assert all(np.isfinite(v) and v < 1e-9 * max(1.0, errs[k + "_scale"])
                   for k, v in err.items()), (phase, errs)
    assert out["lp_carried_vs_f64"] < 1e-8 * max(1.0, out["lp_scale"])
