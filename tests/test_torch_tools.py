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
