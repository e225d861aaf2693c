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


def test_sequential_carry_check_on_cpu():
    """The sequential sweep's carry check (after every run of tickets or
    ticket alone), on a small float64 model with node priors and the
    calibrated table (all 17 proposal kinds) on the CPU: the terms a
    ticket evaluates are all it changes, so the carried terms, d and y
    equal their direct values."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch import synthetic
    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.engine.chains import ChainRunner, RunSettings
    from mcmcdate_tpu_torch.ops.node_priors import BraceSet, CalibrationSet, ConstraintSet
    from mcmcdate_tpu_torch.tools.profile_sweep import check_carry

    model, batch = synthetic.build(12, 1, dtype=torch.float64, device="cpu", seed=3)
    inner = [int(i) for i in model.topo.inner_nodes if i != 0]
    model.calibrations = CalibrationSet(
        node=np.asarray([0, inner[0]], np.int32), lower=np.asarray([1.0, 0.3]),
        lower_pm=np.asarray([0.01, 0.02]), upper=np.asarray([2.0, np.inf]),
        upper_pm=np.asarray([0.01, 1.0]))
    model.constraints = ConstraintSet(young=np.asarray([inner[-1]], np.int32),
                                      old=np.asarray([inner[-2]], np.int32),
                                      pm=np.asarray([0.01]))
    model.braces = BraceSet(node=np.asarray([[inner[1], inner[-3]]], np.int32),
                            sd=np.asarray([0.02]))
    table = P.build_proposal_table(model.topo, model.braces, True)
    assert set(int(k) for k in table.kind) == set(range(P.N_KINDS))
    runner = ChainRunner(model, table, RunSettings("t", n_chains=6, seed=1, dtype="float64",
                                                   device="cpu", fast_sweep=False),
                         log=lambda *a: None)
    b, tuning = runner.init_chains(batch)
    out = check_carry(runner, b, tuning, 5)
    assert all(np.isfinite(v) and v < 1e-9 for v in out["max_abs_err"].values()), out
    assert out["lp_carried_vs_f64"] < 1e-8 * max(1.0, out["lp_scale"])


def test_seq_time_univariate_model():
    """The univariate model of the 10,000-taxon phase, at 30 taxa: O(N)
    data, no Cholesky factor."""
    from mcmcdate_tpu_torch.tools.seq_time import univariate_model

    model, init = univariate_model(30, device="cpu")
    assert model.chol_internal is None
    assert model.likelihood.dim == 57 and model.inv_sd_internal.shape == (57,)
    assert init.heights.shape == (1, 59)


def test_phase_time_k1_and_k3_inputs_on_cpu():
    """``phase_time.py --phase kernels``' K1 and K3 inputs, on a small
    float32 model on the CPU: the host-made K1 state (leaves at 0, root at
    1, the near-critical chains), its terms' hashes (the same state gives
    the same hashes; each clock its own), and K3's two rows, which end in
    T1, K2 and K3 under a full MVN."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch import synthetic
    from mcmcdate_tpu_torch.engine import mh as M, proposals as P
    from mcmcdate_tpu_torch.tools import phase_time

    model, batch = synthetic.build(12, 8, dtype=torch.float32, device="cpu")
    s = phase_time._k1_state(torch, model, batch)
    assert s.heights.dtype == torch.float32 and s.heights.shape == batch.heights.shape
    assert bool((s.heights[:, 0] == 1).all())
    assert bool((s.heights[:, torch.as_tensor(np.asarray(model.topo.is_leaf))] == 0).all())
    assert float((s.death[::7] - s.birth[::7]).abs().max()) < 1e-6
    bits = phase_time.k1_bits(model, s)
    assert bits == phase_time.k1_bits(model, phase_time._k1_state(torch, model, batch))
    assert len(set(bits.values())) == len(bits)
    table = P.build_proposal_table(model.topo, model.braces, False)
    tt = M.MHKernel(model, table).tt
    rows = phase_time.k3_rows(tt)
    assert table.kind[rows["pulley"]] == P.K_PULLEY_ULTRA
    assert table.kind[rows["range"]] == P.K_SCALE_SUBTREE_ULTRA
    assert all(tt.breaks(p) for p in rows.values())


def test_range_drift_is_rounding_at_float64():
    """``tools/range_drift.py``: at float64 the range phase's carried
    distances stay a fresh evaluation's after every block (the float32
    drift is rounding, ROADMAP Queue 3)."""
    import torch

    from mcmcdate_tpu_torch.tools.range_drift import replay

    out = replay(40, torch.float64, 8, 1, log=lambda *a: None)
    (e_glob, e_point, (worst, _)), = out
    assert max(e_glob, e_point, worst) < 1e-13
