#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mcmcdate_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the port's CUDA kernels from csrc/ (one nvcc per
   source, all started together) and prints the time;
3. kernels: runs every kernel on the card against its plain PyTorch
   version, at the run's shape (136 taxa x 1024 chains) and at the bench
   shape (1000 taxa x 1024 chains), with the float32 tolerances below:
   K1 prior_terms, K2 whiten (full, gather and range-1024 row lists), the
   sequential sweep's ticket kernels on a synthetic model with node
   priors and the calibrated table (all 17 proposal kinds): T1
   ticket_prologue and K3 accept_select on one ticket of every kind and
   likelihood class, T3 ticket_scan on a 256-ticket run, each checked by
   replaying their proposals and decisions through the plain versions
   (records: T1 and K3 on the pulley, T3 on the FastSweeps leftovers' run
   of a sweep), and on FastSweeps' own plan steps of a synthetic model
   K4 (the likelihood point step: point_lik_prologue, point_scan and
   point_lik_epilogue, a record each, checked on the first step of both
   point kinds by replaying the kernels' proposals through the plain step;
   one point_lik_step must launch only the three and the z product), K5
   (the likelihood range-block step: range_lik_prologue, range_scan and
   range_lik_epilogue, likewise), both without a likelihood as well (the
   prologue and the epilogue alone, the epilogue taking the decisions), K6
   contra_step in its two modes (contra_slide, and contra_range with a
   record per row bucket: contra_range_16, _64 and _256) and, on the
   14 global-move families of the same model with node priors and the
   calibrated proposal table, the glob kernels G1 glob_scan, G2
   glob_dense_prologue and G3 glob_dense_epilogue (a record each, checked
   by replaying their proposals and decisions through the plain family
   scan; FastSweeps.glob_phase must launch only them).  Each kernel's
   device time and its plain version's are read from the profiler over
   back-to-back calls;
4. main path: simulate -> prepare --likelihood-spec full -> run (MHG,
   FastSweeps) at 136 taxa x 1024 chains through the port's CLI, in a
   temporary directory; checks the outputs, the carried log posterior,
   that the run launched every kernel and no plain proposal kernel, that
   its point steps went through the three K4 kernels alone (as many
   launches of each) and that its sequential phase launched no K1;
5. full width: FastSweeps through ChainRunner at 1000 taxa x 1024 chains
   (D = 1,997) on the synthetic model; median s/sweep, carry check, K4-K6,
   G1-G3 and the ticket kernels launched, the point steps through K4
   alone, the sequential phase without K1 or a plain proposal;
6. prior only: FastSweeps through ChainRunner at 136 taxa x 1024 chains
   on the synthetic model without its likelihood; carry check, the point
   steps and range blocks through their prologue and epilogue kernels
   alone, K6, G1-G3 and T3 launched;
7. sequential path: the same 136-taxon model as the main path through
   RunSettings(fast_sweep=False) (MHKernel); carry check; every sweep
   launches T1, K2 and K3 once per ticket that breaks a run, T3 per run,
   no K1 and no plain proposal;
8. univariate 10k: ChainRunner with the default settings on a univariate
   model of 10,000 taxa x 1024 chains (D = 19,997: the sequential sweep,
   no Cholesky factor); T3 against its plain version on a 256-ticket run
   of every kind (a record of its own, logged); two timed sweeps and one
   whose carried log posterior is checked, every sweep through T3 alone.

Every phase after the kernels sets each wrapper's launch count to 0 just
before it and reads it just after.  The last two lines of standard output
are the card's name and power limit and, on success, ``{"ok": true,
"device": {...}}``; the line before them is the kernels' JSON record.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_TAXA = 136
BENCH_TAXA = 1000
CHAINS = 1024
TREES = 600
# The main path's iterations after the --profile burn-in (60 sweeps).
# --profile alone would run 50; cut to 20.  The full-width, prior-only and
# sequential phases run 10 sweeps (one chunk) and one more for the carry
# check; the univariate 10k phase UNI_SWEEPS timed sweeps and one more.
# Only sweep counts are cut, never taxa or chains, so that the whole script
# stays inside half its 1200 s limit (PERF.md gives each phase's seconds
# per sweep on an H100).
ITERATIONS = 20
FULL_WIDTH_SWEEPS = 10
PRIOR_ONLY_SWEEPS = 10
SEQUENTIAL_SWEEPS = 10
UNI_TAXA = 10_000
UNI_SWEEPS = 2
# Back-to-back calls per kernel timing.
REPS = 20

# float32 tolerances of kernel against plain version, both on the card.
# K1: same formulas and CUDA math library, products rounded one by one
# (-fmad=false); only summation order (braces) differs.
K1_RTOL, K1_ATOL = 1e-5, 1e-5
# K1's birth-death block against the plain version in float64 on the same
# (float32) state: K1 evaluates it in double and rounds once, so the
# near-critical cancellation of a float32 evaluation (about +2 per inner
# node) must not show.
K1_BD_F64_RTOL, K1_BD_F64_ATOL = 1e-6, 1e-6
# K2: sums of up to D products in another order than cuBLAS: the error is
# bounded relative to the largest output.
K2_REL = 1e-5
# K3: the term sum is reduced in another order; accept decisions may
# differ only where |log u - log alpha| is below this.
K3_TIE = 1e-4
# K4, K5: the scans' sums run in another order.  Per chain, decisions agree
# up to the first that differs, which must be a tie (|log u - log alpha| <
# SCAN_TIE); dq agrees up to there within SCAN_REL of the chain's |dq|.
# K5's range step is replayed through the plain step with the kernel's
# proposals (within CONTRA_REL (1 + |x|) of the plain ones from the same
# draws) and decisions: heights, rates and terms must then be bitwise
# equal, d, z and q within SCAN_REL of their largest |value|.
SCAN_TIE = 1e-4
SCAN_REL = 1e-5
# K6 (both modes): the same formulas built with -fmad=false, but CUDA's
# normal CDF, its inverse and log in place of PyTorch's, so a proposal may
# differ from the plain one in its last bits, and a term that divides by a
# short branch amplifies that.  So: the kernel's proposals are within
# CONTRA_REL (1 + |h|) of the plain version's from the same uniforms;
# replayed through the plain version, they give the kernel's log proposal
# ratios within SCAN_TIE (1 + |lq|), its decisions except at ties (|log u -
# log alpha| < SCAN_TIE) and, with the ties taken as the kernel took them,
# its heights, rates and terms within CONTRA_REL (1 + |x|) and its accept
# counts, on every chain and ticket; the kernel keeps every branch distance
# (h_parent - h) r within CONTRA_REL (|h_parent| + |h|) |r| of its old value
# (the subtraction cancels on short branches); and its terms equal a fresh
# evaluation of its own new state within CONTRA_REL (1 + |term|).
CONTRA_REL = 1e-5
# The glob kernels' truncated-normal proposals x = mean + s ndtri(p), with p
# in float32 from each side's own normal CDF: a few ulps of p move x by
# dx/dp = s / phi(z) each, which is large in the tails.  They must be within
# CONTRA_REL (1 + |x|) + PROP_ULPS float32 eps dx/dp of the plain version's
# from the same draws (the gamma families' factor is one product: exact).
PROP_ULPS = 8
# The main path's carried log posterior (float32, updated at every accept)
# against a direct float32 evaluation of its final state by the plain
# versions: relative to the largest |log posterior|.
LP_REL = 1e-5
# That direct float32 evaluation against a float64 one of the same state:
# float32 rounding of the clock terms, the sums and the whitened residual,
# relative to the largest |log posterior|.  A biased float32 formula (the
# near-critical birth-death cancellation added about +2 per inner node,
# over 100 at 136 taxa) fails it.
LP_F64_REL = 1e-4

KERNELS = (
    ("prior_terms", "mcmcdate_tpu_torch/kernels/csrc/prior_terms.cu",
     "mcmcdate_tpu/models/dating.py:131"),
    ("whiten", "mcmcdate_tpu_torch/kernels/csrc/whiten.cu",
     "mcmcdate_tpu/models/dating.py:209"),
    ("ticket_prologue", "mcmcdate_tpu_torch/kernels/csrc/ticket_step.cu",
     "mcmcdate_tpu/engine/proposals.py:388"),
    ("accept_select", "mcmcdate_tpu_torch/kernels/csrc/accept_select.cu",
     "mcmcdate_tpu/engine/mh.py:120"),
    ("ticket_scan", "mcmcdate_tpu_torch/kernels/csrc/ticket_step.cu",
     "mcmcdate_tpu/engine/mh.py:271"),
    ("point_lik_prologue", "mcmcdate_tpu_torch/kernels/csrc/point_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1324"),
    ("point_scan", "mcmcdate_tpu_torch/kernels/csrc/point_scan.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1477"),
    ("point_lik_epilogue", "mcmcdate_tpu_torch/kernels/csrc/point_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1536"),
    ("range_lik_prologue", "mcmcdate_tpu_torch/kernels/csrc/range_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1695"),
    ("range_scan", "mcmcdate_tpu_torch/kernels/csrc/range_scan.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1839"),
    ("range_lik_epilogue", "mcmcdate_tpu_torch/kernels/csrc/range_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1876"),
    ("contra_slide", "mcmcdate_tpu_torch/kernels/csrc/contra_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1223"),
    *((f"contra_range_{rb}", "mcmcdate_tpu_torch/kernels/csrc/contra_step.cu",
       "mcmcdate_tpu/engine/fast_sweep.py:1566") for rb in (16, 64, 256)),
    ("glob_scan", "mcmcdate_tpu_torch/kernels/csrc/glob_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:878"),
    ("glob_dense_prologue", "mcmcdate_tpu_torch/kernels/csrc/glob_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:949"),
    ("glob_dense_epilogue", "mcmcdate_tpu_torch/kernels/csrc/glob_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1192"),
)
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM
# bytes/s, and float32 and float64 operations/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    """Raise with ``msg`` (or ``msg()``, built only on failure) unless
    ``cond``."""
    if not cond:
        raise SmokeError(msg() if callable(msg) else msg)


def log(msg):
    print(msg, flush=True)


def phase_device():
    import torch

    check(torch.cuda.is_available(), "no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def phase_build():
    from mcmcdate_tpu_torch.kernels import build

    path, seconds, built = build.build()
    log(f"[build] {os.path.relpath(path, HERE)}: "
        f"{'built in %.1f s' % seconds if built else 'already built'}")
    build.library()


def _sync():
    import torch

    torch.cuda.synchronize()


def _device_ms(fn, only=None, reps=REPS):
    """Device milliseconds per call of ``fn`` over ``reps`` back-to-back
    calls, from the profiler's kernel, memcpy and memset intervals (only
    those whose name contains ``only``, or one of them, where given), so
    the host's enqueue gaps do not count.  A profile that recorded none of those intervals
    (the profiler's device trace can come back empty) is taken again, up
    to twice; if all three are empty, the time comes from CUDA events
    around ``reps`` calls (which also count the gaps between launches),
    and the log says so."""
    from torch.profiler import ProfilerActivity, profile

    names = (only,) if isinstance(only, str) else only
    fn()
    _sync()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            _sync()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               and (names is None or any(o in e["name"] for o in names))]
        if dev:
            return sum(e["dur"] for e in dev) / 1e3 / reps
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    _sync()
    ms = start.elapsed_time(end) / reps
    log(f"[timing] the profiler recorded no device time for {names or 'the call'} three times: "
        f"{ms:.4f} ms a call from CUDA events")
    return ms


def _bound(nbytes, ops, ops64=0):
    """``(bound_ms, bound_by)``: the larger of the byte time and the
    operation time (``ops`` float32 and ``ops64`` float64 operations) at the
    card's published peaks."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (ops / PEAK_F32 + ops64 / PEAK_F64) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _record(err, ms, plain_ms, nbytes, ops, library_ms=None, ops64=0):
    bound_ms, bound_by = _bound(nbytes, ops, ops64)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def _perturbed(model, batch, seed):
    """A state near ``batch`` with varied scalars and rates per chain."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    C, N = batch.heights.shape
    dev = batch.heights.device

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    h = batch.heights * t(rng.uniform(0.97, 1.0, size=(C, 1)))
    h[:, 0] = 1.0
    h[:, torch.as_tensor(model.topo.is_leaf, device=dev)] = 0.0
    birth = rng.uniform(0.2, 3.0, C)
    death = rng.uniform(0.0, 3.0, C)
    death[::7] = birth[::7] + rng.uniform(-5e-7, 5e-7, len(birth[::7]))  # near-critical
    # Just above the near-critical threshold: a few float32 ulps apart.
    death[3::7] = (birth[3::7].astype(np.float32) + np.float32(1.5e-6)).astype(np.float64)
    rate_var = rng.uniform(0.02, 1.5, C)
    rate_var[::5] = 1e-3  # gamma shape > 100: the Stirling branch
    return batch.replace(
        heights=h.contiguous(), rates=t(rng.gamma(5.0, 0.2, size=(C, N))),
        birth=t(birth), death=t(death), height=t(rng.uniform(0.5, 3.0, C)),
        rate_mean=t(rng.uniform(0.5, 2.0, C)), rate_var=t(rate_var),
    )


def _node_priors(topo):
    """A few calibrations, one constraint and one brace on inner nodes."""
    import numpy as np

    from mcmcdate_tpu_torch.ops.node_priors import BraceSet, CalibrationSet, ConstraintSet

    inner = [int(i) for i in topo.inner_nodes if i != 0]
    cal = CalibrationSet(
        node=np.asarray([0, inner[0], inner[1]], np.int32),
        lower=np.asarray([1.0, 0.4, 0.0]), lower_pm=np.asarray([0.01, 0.02, 1.0]),
        upper=np.asarray([2.0, np.inf, 0.3]), upper_pm=np.asarray([0.01, 1.0, 0.05]),
        names=("root", "a", "b"))
    con = ConstraintSet(young=np.asarray([inner[-1]], np.int32),
                        old=np.asarray([inner[-2]], np.int32), pm=np.asarray([0.01]))
    br = BraceSet(node=np.asarray([[inner[2], inner[-3], -1]], np.int32),
                  sd=np.asarray([0.02]))
    return cal, con, br


_MODELS = {}


def _model(n_taxa):
    """The synthetic full-MVN model and chain batch of a shape (built once)."""
    from mcmcdate_tpu_torch import synthetic

    if n_taxa not in _MODELS:
        _MODELS[n_taxa] = synthetic.build(n_taxa, CHAINS, device="cuda")
    return _MODELS[n_taxa]


def check_prior_terms(n_taxa):
    import dataclasses

    import torch

    from mcmcdate_tpu_torch.kernels.prior_terms import prior_terms, prior_terms_plain
    from mcmcdate_tpu_torch.ops import clocks

    model, batch = _model(n_taxa)
    cal, con, br = _node_priors(model.topo)
    worst = 0.0
    for clock in clocks.MODELS:
        m = dataclasses.replace(model, clock=clock, calibrations=cal, constraints=con,
                                braces=br, mean_root_height=1.5)
        s = _perturbed(m, batch, 1)
        k = prior_terms(m, s)
        p = prior_terms_plain(m, s)
        _sync()
        fin = torch.isfinite(p)
        check(torch.equal(fin, torch.isfinite(k)), f"prior_terms {clock}: finiteness differs")
        check(torch.equal(torch.isnan(p), torch.isnan(k)), f"prior_terms {clock}: NaNs differ")
        check(torch.equal(p[~fin & ~torch.isnan(p)], k[~fin & ~torch.isnan(k)]),
              f"prior_terms {clock}: infinite terms differ")
        err = (k[fin] - p[fin]).abs()
        bad = err > K1_ATOL + K1_RTOL * p[fin].abs()
        check(not bool(bad.any()),
              lambda: f"prior_terms {clock}: max error {float(err.max()):.3g}")
        worst = max(worst, float(err.max()))
        bd = slice(4, 4 + m.topo.n + 1)
        p64 = prior_terms_plain(dataclasses.replace(m, dtype=torch.float64),
                                s.to(dtype=torch.float64))[:, bd]
        kb = k[:, bd].double()
        fin = torch.isfinite(p64)
        check(torch.equal(fin, torch.isfinite(kb)), f"prior_terms {clock}: finiteness vs f64")
        err = (kb[fin] - p64[fin]).abs()
        bad = err > K1_BD_F64_ATOL + K1_BD_F64_RTOL * p64[fin].abs()
        check(not bool(bad.any()), lambda:
              f"prior_terms {clock}: birth-death terms off float64 by {float(err.max()):.3g}")
    s = _perturbed(model, batch, 2)
    ms = _device_ms(lambda: prior_terms(model, s), only="prior_terms_kernel")
    plain_ms = _device_ms(lambda: prior_terms_plain(model, s))
    C, N = s.heights.shape
    T = sum(model.term_block_sizes)
    # Bytes: heights and rates, five scalars per chain, parent and leaf
    # flags in; the term vector out.  Operations: about 100 per node and
    # chain (two double-precision D/E evaluations and a gamma density, with
    # each exp, log or lgamma counted as 10).
    nbytes = 4 * (2 * C * N + 5 * C) + 5 * N + 4 * C * T
    return {"prior_terms": _record(worst, ms, plain_ms, nbytes, 100 * C * N)}


def check_whiten(n_taxa):
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.kernels.whiten import range_rows, whiten, whiten_plain
    from mcmcdate_tpu_torch.ops.heights import distances_internal

    model, batch = _model(n_taxa)
    s = _perturbed(model, batch, 3)
    D = model.likelihood.dim
    L, mu = model.chol_internal_t, model.mu_internal_t
    d = distances_internal(s, model.topo).contiguous()
    y, _ = whiten_plain(d, L, sub=mu)
    d2 = (d * (1.0 + 0.01 * torch.randn_like(d))).contiguous()
    table = P.build_proposal_table(model.topo, model.braces, False)
    p_gather = int(next(i for i, c in enumerate(table.d_class) if c == P.DC_GATHER))
    gather = torch.as_tensor(table.didx[p_gather], dtype=torch.int32, device=d.device)
    lo = next((int(table.d_lo[i]) for i, c in enumerate(table.d_class) if c == P.DC_B1024), 1)
    rng1024 = torch.as_tensor(range_rows(lo, 1024, D), dtype=torch.int32, device=d.device)
    delta = (d2 - d).contiguous()
    cases = {
        "full": dict(x=d, sub=mu),
        "full-delta": dict(x=d2, sub=mu, y=y, minus_y=True),
        "gather": dict(x=delta, rows=gather, y=y),
        "range1024": dict(x=delta, rows=rng1024, y=y),
    }
    worst = 0.0
    for name, kw in cases.items():
        dk, rk = whiten(L=L, **kw)
        dp, rp = whiten_plain(L=L, **kw)
        _sync()
        for what, a, b in (("dy", dk, dp), ("reduction", rk, rp)):
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            check(err <= K2_REL * max(scale, 1.0),
                  f"whiten {name} {what}: max error {err:.3g} at scale {scale:.3g}")
            worst = max(worst, err)
    kw = cases["full-delta"]
    ms = _device_ms(lambda: whiten(L=L, **kw), only="whiten")
    plain_ms = _device_ms(lambda: whiten_plain(L=L, **kw))
    # One PyTorch call of the same product, cuBLAS float32 (TF32 off).
    xs = (d2 - mu).contiguous()
    library_ms = _device_ms(lambda: torch.matmul(xs, L))
    C = d.shape[0]
    # Bytes: x, y, mu and L in, dy and the per-chain sum out.  Operations:
    # the [C, D] x [D, D] product.
    nbytes = 4 * (2 * C * D + D + D * D) + 4 * (C * D + C)
    return {"whiten": _record(worst, ms, plain_ms, nbytes, 2 * C * D * D, library_ms)}


def _mh_copy(carry):
    """A copy of an MHKernel carry."""
    from mcmcdate_tpu_torch.engine.mh import Carry
    from mcmcdate_tpu_torch.models.state import FIELDS, State

    def cl(t):
        return None if t is None else t.clone()

    return Carry(State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}),
                 carry.terms.clone(), cl(carry.d), cl(carry.y), carry.acc.clone(),
                 carry.nbad.clone())


def _mh_same(name, worst, ck, cp, logu, la_p, accept):
    """A kernel carry against the plain replay's at the kernel's proposals
    and decisions: decisions differ from the replay's log alpha only at ties
    (K3_TIE); heights, rates, scalars, terms, d and the accept and bad-term
    counts bitwise equal; y within SCAN_REL of its scale.  Returns the
    number of tie decisions."""
    import torch

    from mcmcdate_tpu_torch.models.state import FIELDS

    differ = (logu < la_p) != accept
    gap = (logu - la_p).abs()[differ]
    check(bool((gap < K3_TIE).all()), lambda: f"{name}: {int(differ.sum())} decisions differ "
          f"beyond ties (largest |log u - log alpha| {float(gap.max()):.3g})")
    for f in FIELDS:
        a, b = getattr(ck.batch, f), getattr(cp.batch, f)
        check(_same(a, b), lambda: f"{name} {f}: {int((a != b).sum())} values differ from the "
              f"replay's")
    check(_same(ck.terms, cp.terms), lambda: f"{name} terms: "
          f"{int((ck.terms != cp.terms).sum())} values differ from the replay's")
    check(torch.equal(ck.acc, cp.acc) and torch.equal(ck.nbad, cp.nbad),
          f"{name}: accept or bad-term counts differ")
    if ck.d is not None:
        check(torch.equal(ck.d, cp.d), f"{name}: d differs from the replay's")
        _within(name, worst, "y", ck.y, cp.y, SCAN_REL, max(1.0, float(cp.y.abs().max())))
    return int(differ.sum())


def _prop_lim(rec_prop, dx_dp):
    import torch

    return CONTRA_REL * (1 + rec_prop.abs()) + PROP_ULPS * torch.finfo(torch.float32).eps * dx_dp


def _ticket_one_agree(name, tk, carry, tuning, p, draw, u, worst):
    """T1, K2 where the row's class needs it, and K3 on one ticket of row
    ``p`` against the plain versions on copies of ``carry``: the kernel's
    proposal against the plain one from the same draw; replayed at it
    (and at var_tree's rate mean), T1's invalid flags and new terms
    bitwise, d_pr, lmhg and lj within SCAN_TIE (1 + |x|), delta exact; then
    K3 against the plain epilogue with its decisions (_mh_same)."""
    import torch

    from mcmcdate_tpu_torch.kernels.accept_select import accept_select, accept_select_plain
    from mcmcdate_tpu_torch.kernels.ticket_step import TicketDraws, ticket_prologue, \
        ticket_prologue_plain

    tt = tk.tt
    dr = TicketDraws.single(p, draw, u)
    ck, cp = _mh_copy(carry), _mh_copy(carry)
    pro = ticket_prologue(tt, ck, tuning, dr, 0)
    k = {f: getattr(pro, f).clone() for f in ("prop", "lmhg", "lj", "d_pr", "invalid")}
    mean = None if pro.mean is None else pro.mean.clone()
    tix, rows = tt.tix(p), tt.rows(p)
    tn = pro.tn[:, tix].clone()
    has_rows = tt.lik and (rows is None or rows.numel() > 0)
    dl = None if not has_rows else (pro.delta if rows is None else pro.delta[:, rows]).clone()
    pp = ticket_prologue_plain(tt, cp, tuning, p, draw)
    dx = torch.zeros_like(pp.prop) if pp.dx_dp is None else pp.dx_dp
    err = (k["prop"] - pp.prop).abs()
    check(bool((err <= _prop_lim(pp.prop, dx)).all()),
          lambda: f"{name}: proposals off the plain version's by {float(err.max()):.3g}")
    worst["prop"] = max(worst.get("prop", 0.0), float(err.max()))
    pp = ticket_prologue_plain(tt, cp, tuning, p, draw, given=k["prop"], given_mean=mean)
    check(torch.equal(k["invalid"], pp.invalid), f"{name}: invalid flags differ")
    check(_same(tn, pp.tn[:, tix]), f"{name}: new terms differ from the replay's")
    for f in ("d_pr", "lmhg", "lj"):
        _within(name, worst, f, k[f], getattr(pp, f), SCAN_TIE)
    if dl is not None:
        check(torch.equal(dl, pp.delta if rows is None else pp.delta[:, rows]),
              f"{name}: delta differs from the replay's")
    dy, d_lik = tk._k2(ck, p, pro)
    ak = accept_select(tt, ck, tuning, dr, 0, pro, dy, d_lik)
    ap, la_p = accept_select_plain(tt, cp, p, pp, torch.where(ak, 0.0, math.nan), dy, d_lik)
    check(torch.equal(ak, ap),
          f"{name}: the kernel accepted a proposal whose log alpha the plain version makes -inf")
    return _mh_same(name, worst, ck, cp, torch.log(u), la_p, ak), int(ak.sum())


def _ticket_scan_agree(name, tk, carry, tuning, dr, worst):
    """T3 over the whole of ``dr`` (a run) against ``ticket_scan_plain``
    replayed at its proposals, rate means and decisions, on copies of
    ``carry`` (see _ticket_one_agree).  Returns ``(ties, accepts, total)``."""
    import torch

    from mcmcdate_tpu_torch.kernels.ticket_step import ticket_scan, ticket_scan_plain

    tt = tk.tt
    ck, cp = _mh_copy(carry), _mh_copy(carry)
    out = ticket_scan(tt, ck, tuning, dr, 0, dr.n, out=True)
    _sync()
    rec = ticket_scan_plain(tt, cp, tuning, dr._replace(u_acc=torch.where(out.accept, 0.0,
                                                                              math.nan)),
                            0, dr.n, given=dict(prop=out.prop, mean=out.mean))
    check(torch.equal(rec.accept, out.accept),
          f"{name}: the kernel accepted a proposal whose log alpha the plain version makes -inf")
    err = (out.prop - rec.prop).abs()
    check(bool((err <= _prop_lim(rec.prop, rec.dx_dp)).all()),
          lambda: f"{name}: proposals off the plain version's by {float(err.max()):.3g}")
    worst["prop"] = max(worst.get("prop", 0.0), float(err.max()))
    ties = _mh_same(name, worst, ck, cp, torch.log(dr.u_acc), rec.log_alpha, out.accept)
    return ties, int(out.accept.sum()), out.accept.numel()


def _ticket_work(tt, order):
    """What a run of ``order``'s tickets must move and compute per chain:
    ``(floats, bd terms, other terms)``: per ticket its draws, the state
    entries it writes (old kept, new written), its term entries (old in,
    new out), its class rows (d, y in; d, y out) and the flags."""
    N = tt.N
    floats = bd = other = 0
    o_bd, o_ck = 4, 4 + N + 1
    for p in order:
        p = int(p)
        tix = tt.tix(p).cpu().numpy()
        n_bd = int(((tix >= o_bd) & (tix < o_ck)).sum())
        fl = int(tt.cols["fields"][p])
        nodes = (N * ((fl & 1) + ((fl >> 1) & 1))
                 + (int(tt.n_off[p + 1] - tt.n_off[p])) * (((fl >> 7) & 1) + ((fl >> 8) & 1)))
        rows = tt.rows(p)
        nr = tt.D if rows is None else int(rows.numel())
        floats += 3 + 2 * nodes + 2 * len(tix) + 4 * nr + 5
        bd += n_bd
        other += len(tix) - n_bd
    return floats, bd, other


def check_ticket(n_taxa):
    """T1 ticket_prologue, K3 accept_select and T3 ticket_scan on the
    calibrated synthetic model (all 17 proposal kinds) under its full MVN:
    T1 and K3 on one ticket of every kind and every (class, kind) pair
    against their plain versions; T3 on a 256-ticket run of the table's
    non-breaking tickets against ticket_scan_plain.  The records time T1
    and K3 on the pulley (FastSweeps' T1/K2/K3 ticket) and T3 on one run of
    the FastSweeps leftovers' non-breaking tickets, in a drawn order (the
    main path's run shape)."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch.engine import mh as M, proposals as P
    from mcmcdate_tpu_torch.kernels.accept_select import accept_select, accept_select_plain
    from mcmcdate_tpu_torch.kernels.ticket_step import TicketDraws, ticket_prologue, \
        ticket_prologue_plain, ticket_scan, ticket_scan_plain
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    fs, fcarry, tuning, gen = _glob_fast(n_taxa)
    tk = M.MHKernel(fs.model, fs.table)
    tt = tk.tt
    carry = tk.init_carry(fcarry.batch)
    C = carry.terms.shape[0]

    def draw_of(p):
        return (standard_gamma(float(tt.table.par[p]) / tuning[:, p], gen) if tt.gamma[p]
                else torch.rand(C, generator=gen, device="cuda"))

    rows = {}
    for p, kind in enumerate(tt.table.kind):
        rows.setdefault((int(kind), int(tt.table.aux[p]) if kind == P.K_SCALE_SCALAR else 0), p)
        rows.setdefault((int(kind), int(tt.d_class[p]), "dc"), p)
    check({k[0] for k in rows} == set(range(P.N_KINDS)), "the table lacks a proposal kind")
    worst, ties, n_acc = {}, 0, 0
    for p in sorted(set(rows.values())):
        t, a = _ticket_one_agree(f"ticket {tt.table.names[p]} at {n_taxa} taxa", tk, carry,
                                 tuning, p, draw_of(p), torch.rand(C, generator=gen,
                                                                   device="cuda"), worst)
        ties, n_acc = ties + t, n_acc + a
    check(n_acc > 0, "the ticket checks accepted nothing")
    log(f"[kernels] ticket_prologue + accept_select at {n_taxa} taxa: {len(set(rows.values()))} "
        f"rows (every kind and class), {n_acc} accepts, {ties} tie decisions differ from the "
        f"replay; largest differences {json.dumps(worst)}")
    tickets = np.asarray(tt.table.tickets)
    ok = np.asarray([not tt.breaks(int(p)) for p in tickets])
    order = np.random.default_rng(n_taxa).choice(tickets[ok], 256).astype(np.int32)
    w3 = {}
    ties, n_acc, n_all = _ticket_scan_agree(f"ticket_scan at {n_taxa} taxa", tk, carry, tuning,
                                            tk.draws(order, tuning, gen), w3)
    check(0 < n_acc < n_all, f"ticket_scan accepted {n_acc} of {n_all}: not a mixed case")
    log(f"[kernels] ticket_scan at {n_taxa} taxa: 256 tickets that do not break a run, {n_acc} "
        f"accepts of {n_all}, {ties} tie decisions differ from the replay, state, terms and d "
        f"bitwise equal to it; largest differences {json.dumps(w3)}")

    # T1 and K3 on the pulley.
    N, T, D = tt.N, tt.T, tt.D
    nn = T - 4 - 2 * (N + 1)
    p = int(np.nonzero(tt.table.kind == P.K_PULLEY_ULTRA)[0][0])
    draw, u = draw_of(p), torch.rand(C, generator=gen, device="cuda")
    dr = TicketDraws.single(p, draw, u)
    c1 = _mh_copy(carry)
    ms1 = _device_ms(lambda: ticket_prologue(tt, c1, tuning, dr, 0), only="ticket_prologue_kernel")
    c2 = _mh_copy(carry)
    plain1 = _device_ms(lambda: ticket_prologue_plain(tt, c2, tuning, p, draw))
    c3 = _mh_copy(carry)
    pro = ticket_prologue(tt, c3, tuning, dr, 0)
    dy, d_lik = tk._k2(c3, p, pro)
    acc0 = accept_select(tt, _mh_copy(c3), tuning, dr, 0, pro, dy, d_lik)
    ms3 = _device_ms(lambda: accept_select(tt, c3, tuning, dr, 0, pro, dy, d_lik),
                     only="accept_select_kernel")
    c4 = _mh_copy(carry)
    pp = ticket_prologue_plain(tt, c4, tuning, p, draw)
    plain3 = _device_ms(lambda: accept_select_plain(tt, c4, p, pp, u, dy, d_lik))
    # T1.  Bytes: per chain heights and rates in, the new heights and the
    # old ones out, the bd, ck and nd blocks in and out, d in and d_new and
    # delta out, a few scalars.  Operations: the birth-death block in
    # double (about 100 per node, each exp or log counted as 10), the clock
    # block (about 40 per node) and the distances (4 per row).
    nb1 = 4 * C * (4 * N + 2 * (2 * (N + 1) + nn) + 3 * D + 12)
    # K3.  Bytes: per chain dy and y and five values in; for the accepted
    # chains the three blocks and d_new in, terms, d and y out; for the
    # rejected ones the old heights in and out.  Operations: y + dy.
    na = int(acc0.sum())
    nb3 = 4 * C * (2 * D + 6) + 4 * na * (2 * (2 * (N + 1) + nn) + 3 * D) + 4 * (C - na) * 2 * N
    # T3 on the FastSweeps leftovers' non-breaking tickets of one sweep.
    sk = fs.seq_kern
    rows_t = torch.as_tensor(fs.plan.seq_rows.astype(np.int64), device="cuda")
    stun = tuning[:, rows_t].contiguous()
    seq = np.asarray(sk.table.tickets)
    seq = seq[np.random.default_rng(1).permutation(len(seq))]
    seq = np.asarray([q for q in seq if not sk.tt.breaks(int(q))], np.int32)
    scarry = M.Carry(carry.batch, carry.terms, carry.d, carry.y,
                     torch.zeros((C, sk.table.n_proposals), dtype=torch.int32, device="cuda"),
                     carry.nbad)
    sdr = sk.draws(seq, stun, gen)
    c5, c6 = _mh_copy(scarry), _mh_copy(scarry)
    ms5 = _device_ms(lambda: ticket_scan(sk.tt, c5, stun, sdr, 0, len(seq)),
                     only="ticket_scan_kernel")
    plain5 = _device_ms(lambda: ticket_scan_plain(sk.tt, c6, stun, sdr, 0, len(seq)), reps=1)
    fl5, bd5, ot5 = _ticket_work(sk.tt, seq)
    log(f"[kernels] ticket_scan at {n_taxa} taxa: the leftovers' run of {len(seq)} tickets "
        f"(of {len(sk.table.tickets)} leftovers a sweep): {ms5:.4f} ms, "
        f"{ms5 / len(seq) * 1e3:.2f} us a ticket")
    return {
        "ticket_prologue": _record(max(worst.get("prop", 0.0), worst.get("d_pr", 0.0)), ms1,
                                   plain1, nb1, C * (40 * (N + 1) + 4 * D + 100),
                                   ops64=100 * C * N),
        "accept_select": _record(worst.get("y", 0.0), ms3, plain3, nb3, 4 * C * D),
        "ticket_scan": _record(max(w3.get("prop", 0.0), w3.get("y", 0.0)), ms5, plain5,
                               4 * C * fl5, C * (40 * ot5 + 100 * len(seq)), ops64=100 * C * bd5),
    }


_FAST = {}


def _fast(n_taxa):
    """FastSweeps on the synthetic model of a shape, with a carry (z and q
    filled), a tuning and a generator (built once)."""
    import torch

    from mcmcdate_tpu_torch.engine import fast_sweep, proposals as P

    if n_taxa not in _FAST:
        model, batch = _model(n_taxa)
        table = P.build_proposal_table(model.topo, model.braces, False)
        fs = fast_sweep.FastSweeps(model, table)
        carry = fs.init_carry(batch)
        carry.z, carry.q = fs._zq_from_y(model.whitened_residual_internal(carry.batch))
        gen = torch.Generator(device="cuda").manual_seed(n_taxa)
        tuning = 0.3 + 2.7 * torch.rand((CHAINS, table.n_proposals), generator=gen,
                                        device="cuda")
        _FAST[n_taxa] = fs, carry, tuning, gen
    return _FAST[n_taxa]


def _draws(fs, sx, tuning, gen, gamma):
    import torch

    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    n = sx["rows"].shape[0]
    draw = (standard_gamma(sx["sd"] / tuning[:, sx["rows"]], gen) if gamma
            else torch.rand((CHAINS, n), generator=gen, device="cuda"))
    return draw, torch.rand((CHAINS, n), generator=gen, device="cuda")


def _same(a, b):
    """Bitwise equal, NaN where NaN."""
    import torch

    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], b[~nan])


def _copy_carry(carry):
    from mcmcdate_tpu_torch.engine.fast_sweep import FastCarry
    from mcmcdate_tpu_torch.models.state import FIELDS, State

    return FastCarry(State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}),
                     carry.terms.clone(), carry.d.clone(), carry.z.clone(), carry.q.clone(),
                     carry.acc.clone())


def _step_recorded(names, step):
    """Run ``step()`` with the kernel wrappers ``names`` of FastSweeps'
    module recorded: ``{name: output, name + "_args": arguments}``."""
    from mcmcdate_tpu_torch.engine import fast_sweep

    rec = {}
    real = {k: getattr(fast_sweep, k) for k in names}

    def recorder(key):
        def run(*args):
            rec[key + "_args"] = args
            rec[key] = real[key](*args)
            return rec[key]
        return run

    for k in real:
        setattr(fast_sweep, k, recorder(k))
    try:
        out = step()
    finally:
        for k, fn in real.items():
            setattr(fast_sweep, k, fn)
    _sync()
    return rec, out


def _within(name, worst, what, a, b, rel, scale=None):
    """``a`` within ``rel (1 + |b|)`` of ``b`` (or ``rel scale``; a tensor of
    scales, such as each chain's, holds every entry to the smallest) where
    ``b`` is finite, with the same finite entries; the largest difference
    goes to ``worst[what]``."""
    import torch

    fin = torch.isfinite(b)
    check(torch.equal(fin, torch.isfinite(a)), f"{name} {what}: finiteness differs")
    err = (a - b).abs()[fin]
    worst[what] = float(err.max()) if err.numel() else 0.0
    if scale is None:
        lim = rel * (1 + b.abs()[fin])
    else:
        lim = rel * float(scale.min() if torch.is_tensor(scale) else scale)
    check(bool((err <= lim).all()),
          lambda: f"{name} {what}: off the plain version by {worst[what]:.3g}")


K4_NAMES = ("point_lik_prologue", "point_scan", "point_lik_epilogue")


def _point_step_agree(name, fs, carry, tuning, kind, sx, draw, u):
    """K4's likelihood point step (prologue, point_scan, epilogue and the z
    product, as ``FastSweeps.point_lik_step`` runs them) on one step,
    against its plain version, on copies of ``carry``: the kernel's
    proposals against the plain version's from the same draws; the kernel's
    proposals replayed through ``point_lik_given``, with every decision
    taken as the kernel took it, whose log alpha must give the kernel's
    decisions except at ties, whose new terms must equal the prologue's
    and whose heights, rates and terms after the step must equal the
    kernels' bitwise, with d, z and q within SCAN_REL of their scale and dq
    within SCAN_REL of the smallest chain's (each chain's largest |dq|, at
    least 1).  Returns ``(worst differences, recorded kernel inputs and
    outputs)``."""
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.kernels import point_step as K

    model = fs.model
    branch = kind == P.K_SCALE_BRANCH_RATE
    leaf = model.topo.is_leaf_t
    ck, cr = _copy_carry(carry), _copy_carry(carry)
    rec, accept = _step_recorded(K4_NAMES, lambda: fs.point_lik_step(kind, ck, tuning, sx,
                                                                      draw, u))
    check(len(rec) == 6, f"{name}: the step did not run all three kernels")
    pro = rec["point_lik_prologue"]
    dq = rec["point_scan"][1]
    worst = {}
    pp = K.point_lik_prologue_plain(branch, carry.batch, carry.terms, carry.d, carry.z, tuning,
                                    sx, leaf, fs.pos_t, model.clock, draw)
    _within(name, worst, "prop", pro.prop, pp.prop, CONTRA_REL)
    forced = torch.where(accept, 0.0, math.nan)
    acc_r, pr, dq_r = K.point_lik_given(branch, cr.batch, cr.terms, cr.d, cr.z, cr.q, cr.acc,
                                        tuning, sx, leaf, fs.pos_t, model.clock, pro.prop, forced)
    check(torch.equal(acc_r, accept),
          f"{name}: the kernel accepted a proposal whose log alpha the plain version makes -inf")
    _within(name, worst, "lq", pro.lq, pr.lq, SCAN_TIE)
    check(_same(pro.tn, pr.tn), lambda: f"{name}: {int((pro.tn != pr.tn).sum())} new terms "
          f"differ from the replay's")
    for what in ("delta", "zG", "d_pr"):
        _within(name, worst, what, getattr(pro, what), getattr(pr, what), SCAN_REL)
    la = torch.nan_to_num(pr.d_pr - 0.5 * dq_r + pr.lmhg, nan=-math.inf)
    differ = (torch.log(u) < la) != accept
    gap = (torch.log(u) - la).abs()[differ]
    check(bool((gap < SCAN_TIE).all()), lambda: f"{name}: {int(differ.sum())} decisions differ "
          f"beyond ties (largest |log u - log alpha| {float(gap.max()):.3g})")
    _within(name, worst, "dq", dq, dq_r, SCAN_REL, dq_r.abs().amax(1, keepdim=True).clamp(min=1.0))
    for what, a, b in (("heights", ck.batch.heights, cr.batch.heights),
                       ("rates", ck.batch.rates, cr.batch.rates), ("terms", ck.terms, cr.terms)):
        check(_same(a, b), lambda: f"{name} {what}: {int((a != b).sum())} values differ from "
              f"the replay's")
    for what, a, b in (("d", ck.d, cr.d), ("z", ck.z, cr.z), ("q", ck.q, cr.q)):
        _within(name, worst, what, a, b, SCAN_REL, max(1.0, float(b.abs().max())))
    check(torch.equal(ck.acc, cr.acc), f"{name}: accept counts differ")
    check(0 < int(accept.sum()) < accept.numel(), f"{name}: not a mixed case")
    log(f"[kernels] {name}: B={accept.shape[1]}, KD={sx['d_rows'].shape[1]}, "
        f"{int(accept.sum())} accepts, {int(differ.sum())} tie decisions differ from the "
        f"replay, heights, rates and terms bitwise equal to it; largest differences "
        f"{json.dumps(worst)}")
    return worst, rec


def _kernel_names(fn, reps=3):
    """The device kernels (and copies) that ``reps`` calls of ``fn`` launch,
    by name, and the kernel launches the host made (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            _sync()
        events = prof.events()
        names = [e.name for e in events if e.device_type.name == "CUDA"]
        launches = sum(e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                                  "cuLaunchKernelEx") for e in events)
        if names:
            return names, launches
    raise SmokeError("the profiler recorded no device kernel")


def check_point_step(n_taxa):
    """K4 (prologue, point_scan, epilogue) on the planner's first (largest)
    step of both likelihood point kinds; one point_lik_step launches only
    the three K4 kernels and the z product; the records time the node
    slides' step (KD = 3, the widest).  Returns a record per kernel."""
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.kernels import point_step as K
    from mcmcdate_tpu_torch.kernels.point_scan import SUB, point_scan, point_scan_plain

    fs, carry, tuning, gen = _fast(n_taxa)
    model = fs.model
    leaf = model.topo.is_leaf_t
    worst = {}
    for kind in (P.K_SCALE_BRANCH_RATE, P.K_SLIDE_NODE_ULTRA):
        branch = kind == P.K_SCALE_BRANCH_RATE
        sx = fs.spec_t[kind][0]
        draw, u = _draws(fs, sx, tuning, gen, branch)
        w, rec = _point_step_agree(f"point step kind {kind} at {n_taxa} taxa", fs, carry,
                                   tuning, kind, sx, draw, u)
        for k, v in w.items():
            worst[k] = max(worst.get(k, 0.0), v)
    # The slide step (the last): its kernels alone, and what one step launches.
    # Three steps: only the three K4 kernels and the product's one or two
    # gemm kernels, each K4 kernel in at least two of the profiler's
    # records (it may drop one), at most 5 launches a step.
    c0 = _copy_carry(carry)
    names, launches = _kernel_names(lambda: fs.point_lik_step(kind, c0, tuning, sx, draw, u))
    k4 = {k: sum(k + "_kernel" in n for n in names) for k in K4_NAMES}
    other = sorted({n for n in names if not any(k + "_kernel" in n for k in K4_NAMES)})
    check(all(v >= 2 for v in k4.values()) and all("gemm" in n.lower() for n in other)
          and launches <= 15,
          f"three point_lik_steps launched {launches} kernels: {k4} and {other}, not the three "
          f"K4 kernels and the product alone")
    log(f"[kernels] three point_lik_steps at {n_taxa} taxa: {launches} launches, K4 {k4}, "
        f"other {other}")
    pro, (accept, dq) = rec["point_lik_prologue"], rec["point_scan"]
    c1, c2, c3 = _copy_carry(carry), _copy_carry(carry), _copy_carry(carry)
    pargs = (branch, c1.batch, c1.terms, c1.d, c1.z, tuning, sx, leaf, fs.pos_t, model.clock,
             draw)
    eargs = (branch, c2.batch, c2.terms, c2.d, c2.q, c2.acc, sx, pro, accept, dq)
    sargs = rec["point_scan_args"]

    def plain_step():
        p = K.point_lik_prologue_plain(*pargs)
        a, q_ = point_scan_plain(p.delta, p.zG, sx["Pblk"], p.d_pr, p.lmhg, u)
        _, dacc = K.point_lik_epilogue_plain(branch, c3.batch, c3.terms, c3.d, c3.q, c3.acc, sx,
                                             p, a, q_)
        c3.z.addmm_(dacc, sx["Prow"])

    ms = {"prologue": _device_ms(lambda: K.point_lik_prologue(*pargs),
                                 only="point_lik_prologue_kernel"),
          "scan": _device_ms(lambda: point_scan(*sargs), only="point_scan_kernel"),
          "epilogue": _device_ms(lambda: K.point_lik_epilogue(*eargs),
                                 only="point_lik_epilogue_kernel"),
          "step": _device_ms(lambda: fs.point_lik_step(kind, c3, tuning, sx, draw, u))}
    plain = {"prologue": _device_ms(lambda: K.point_lik_prologue_plain(*pargs)),
             "scan": _device_ms(lambda: point_scan_plain(*sargs)),
             "epilogue": _device_ms(lambda: K.point_lik_epilogue_plain(*eargs)),
             "step": _device_ms(plain_step)}
    C, B = accept.shape
    KC, KT, KD = sx["ch"].shape[1], sx["t_rows"].shape[1], sx["d_rows"].shape[1]
    KN = sx["cal_lo"].shape[-1]
    F = B * KD
    log(f"[kernels] point step kind {kind} at {n_taxa} taxa (B={B}, KD={KD}): device time per "
        f"step: the step {ms['step']:.4f} ms (plain {plain['step']:.4f} ms), of which "
        f"prologue {ms['prologue']:.4f}, point_scan {ms['scan']:.4f}, epilogue "
        f"{ms['epilogue']:.4f} ms")
    # Prologue.  Bytes: per chain and ticket the draw, tuning, the node's,
    # its parent's and its children's heights, their rates, the old terms
    # and d and z at the distance rows in; prop, lq, d_pr, lmhg, the new
    # terms, delta and zG out; five scalars per chain; the step's plan
    # arrays.  Operations: about 100 for the proposal and 120 per node whose
    # birth-death (in double) and clock terms it evaluates (1 + KC), special
    # functions counted as 10.
    pro_bytes = (4 * C * B * (2 + (2 + KC) + (1 + KC) + KT + 2 * KD) + 4 * C * B * (4 + KT + 2 * KD)
                 + 20 * C + 4 * B * (4 + KC + KT + KD + 4 * KN) + B)
    pro_ops = C * B * (100 + 120 * (1 + KC))
    # point_scan.  Bytes: deltas, zG, Pblk, d_pr, lmhg and u in; accept and
    # dq out.  Operations: dq0, the cross terms of each sub-block and, for
    # this run's accepts, the zG updates of the later columns (at the plain
    # version's sub-blocks of SUB tickets).
    scan_ops = C * B * (2 * KD + 2 * KD * KD)
    for lo in range(0, B, SUB):
        sn = min(SUB, B - lo)
        scan_ops += C * sn * (sn - 1) * KD * KD
        if lo + sn < B:
            scan_ops += int(accept[:, lo:lo + sn].sum()) * 2 * KD * (F - (lo + sn) * KD)
    scan_bytes = 4 * (2 * C * F + F * F + 3 * C * B) + 5 * C * B
    # Epilogue.  Bytes: accept and dq per chain and ticket in, dacc out; per
    # accepted ticket prop, its new terms and deltas in, its height and
    # terms out, d in and out at its rows, its accept count in and out; q in
    # and out; the step's plan arrays.  Operations: one add per accepted
    # distance row.
    n_acc = int(accept.sum())
    epi_bytes = (5 * C * B + 4 * C * F + 4 * n_acc * (1 + KT + KD + 1 + KT + 2 * KD + 2) + 8 * C
                 + 4 * B * (3 + KT + KD))
    return {
        "point_lik_prologue": _record(max(worst["prop"], worst["lq"]), ms["prologue"],
                                      plain["prologue"], pro_bytes, pro_ops),
        "point_scan": _record(worst["dq"], ms["scan"], plain["scan"], scan_bytes, scan_ops),
        "point_lik_epilogue": _record(max(worst["d"], worst["z"], worst["q"]), ms["epilogue"],
                                      plain["epilogue"], epi_bytes, n_acc * KD),
    }


def check_prior_only_steps(n_taxa):
    """Without a likelihood, K4's and K5's prologue and epilogue kernels
    (the epilogue taking the decisions) on the first step of both point
    kinds and the first block of every bucket of both likelihood range
    kinds, through ``FastSweeps.point_lik_step`` / ``range_lik_step``: each
    launches its prologue and epilogue once and nothing else of the port;
    the plain prologue replayed at the kernels' proposals gives their
    decisions except at ties, and the plain epilogue on their decisions
    gives their heights, rates and terms bitwise, d within SCAN_REL of its
    scale and the same accept counts; q stays as it was.  No records: the
    kernels' come from their likelihood checks."""
    import dataclasses

    import torch

    from mcmcdate_tpu_torch.engine import fast_sweep, proposals as P
    from mcmcdate_tpu_torch.kernels import point_step as KP, range_step as KR
    from mcmcdate_tpu_torch.ops import mvn

    _, _, tuning, gen = _fast(n_taxa)
    model, batch = _model(n_taxa)
    model = dataclasses.replace(model, likelihood=mvn.LikelihoodData.none())
    fs = fast_sweep.FastSweeps(model, P.build_proposal_table(model.topo, model.braces, False))
    carry = fs.init_carry(batch)
    leaf = model.topo.is_leaf_t
    cases = [("point", k, k == P.K_SCALE_BRANCH_RATE, fs.spec_t[k][0])
             for k in (P.K_SCALE_BRANCH_RATE, P.K_SLIDE_NODE_ULTRA)]
    cases += [("range", k, k == P.K_SCALE_SUBTREE_RATE, steps[0])
              for (k, _), steps in fs.range_t.items() if k != P.K_SCALE_SUBTREES_CONTRA]
    worst = {}
    for step, kind, flag, sx in cases:
        name = f"{step} step kind {kind} without a likelihood at {n_taxa} taxa"
        draw, u = _draws(fs, sx, tuning, gen, flag)
        ck, cr = _copy_carry(carry), _copy_carry(carry)
        run = fs.point_lik_step if step == "point" else fs.range_lik_step
        counts, accept = _counted(lambda: run(kind, ck, tuning, sx, draw, u))
        _sync()
        launched = {k: n for k, n in counts.items() if n}
        want = {f"{step}_lik_prologue": 1, f"{step}_lik_epilogue": 1}
        check(launched == want, f"{name}: launched {launched}, not {want}")
        if step == "point":
            pro = KP.point_lik_prologue(flag, cr.batch, cr.terms, cr.d, None, tuning, sx, leaf,
                                        fs.pos_t, model.clock, draw)
            pr = KP.point_lik_prologue_given(flag, cr.batch, cr.terms, cr.d, None, tuning, sx,
                                             leaf, fs.pos_t, model.clock, pro.prop)
            epilogue_plain = KP.point_lik_epilogue_plain
        else:
            pro = KR.range_lik_prologue(flag, cr.batch, cr.terms, cr.d, None, tuning, sx, leaf,
                                        model.clock, draw)
            pr = KR.range_lik_prologue_given(flag, cr.batch, cr.terms, cr.d, None, tuning, sx,
                                             leaf, model.clock, pro.prop)
            epilogue_plain = KR.range_lik_epilogue_plain
        la = torch.nan_to_num(pr.d_pr + pr.lmhg, nan=-math.inf)
        differ = ((torch.log(u) < la) & sx["valid"]) != accept
        gap = (torch.log(u) - la).abs()[differ]
        check(bool((gap < SCAN_TIE).all()), lambda: f"{name}: {int(differ.sum())} decisions "
              f"differ beyond ties (largest |log u - log alpha| {float(gap.max()):.3g})")
        epilogue_plain(flag, cr.batch, cr.terms, cr.d, cr.q, cr.acc, sx, pr, accept, None)
        for what, a, b in (("heights", ck.batch.heights, cr.batch.heights),
                           ("rates", ck.batch.rates, cr.batch.rates), ("terms", ck.terms, cr.terms)):
            check(_same(a, b), lambda: f"{name} {what}: {int((a != b).sum())} values differ "
                  f"from the replay's")
        _within(name, worst, "d", ck.d, cr.d, SCAN_REL, max(1.0, float(cr.d.abs().max())))
        check(torch.equal(ck.acc, cr.acc), f"{name}: accept counts differ")
        check(torch.equal(ck.q, carry.q), f"{name}: q changed")
        check(0 < int(accept.sum()) < int(sx["valid"].sum()) * accept.shape[0],
              f"{name}: not a mixed case")
        # Three steps launch the prologue and epilogue kernels alone.
        names, n_launch = _kernel_names(lambda: run(kind, ck, tuning, sx, draw, u))
        other = sorted({n for n in names if f"{step}_lik_" not in n})
        check(not other and n_launch <= 6,
              f"{name}: three steps launched {n_launch} kernels, {other} besides {step}_lik_*")
        log(f"[kernels] {name}: {int(accept.sum())} accepts, {int(differ.sum())} tie decisions "
            f"differ from the replay, heights, rates and terms bitwise equal to it; d within "
            f"{worst['d']:.3g}; three steps launched {n_launch} kernels")
    return {}


def _range_step_agree(name, fs, carry, tuning, kind, sx, draw, u):
    """K5's likelihood range step (prologue, range_scan, epilogue and the z
    product, as ``FastSweeps.range_lik_step`` runs them) on one block,
    against its plain version, on copies of ``carry``: the kernel's
    proposals against the plain version's from the same draws; the kernel's
    proposals replayed through ``range_lik_given``, with every decision
    taken as the kernel took it, whose log alpha must give the kernel's
    decisions except at ties and whose heights, rates and terms must equal
    the kernel's bitwise, with d, z and q within SCAN_REL of their scale
    and dq within SCAN_REL of the smallest chain's (each chain's largest
    |dq|, at least 1).  Returns ``(worst differences, recorded kernel inputs
    and outputs, copy)``."""
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.kernels import range_step as K

    model = fs.model
    rate = kind == P.K_SCALE_SUBTREE_RATE
    leaf = model.topo.is_leaf_t

    def copy():
        return _copy_carry(carry)

    ck, cr = copy(), copy()
    rec, accept = _step_recorded(("range_lik_prologue", "range_scan", "range_lik_epilogue"),
                                 lambda: fs.range_lik_step(kind, ck, tuning, sx, draw, u))
    check(len(rec) == 6, f"{name}: the step did not run all three kernels")
    pro = rec["range_lik_prologue"]
    dq = rec["range_scan"][1]
    worst = {}

    def within(what, a, b, rel, scale=None):
        _within(name, worst, what, a, b, rel, scale)

    # The proposals, from the same draws.
    pp = K.range_lik_prologue_plain(rate, carry.batch, carry.terms, carry.d, carry.z, tuning,
                                    sx, leaf, model.clock, draw)
    within("prop", pro.prop, pp.prop, CONTRA_REL)
    # The kernel's proposals through the plain step, each decision forced
    # as the kernel took it (log 0 < any finite log alpha; log NaN < nothing).
    forced = torch.where(accept, 0.0, math.nan)
    acc_r, pr, dq_r = K.range_lik_given(rate, cr.batch, cr.terms, cr.d, cr.z, cr.q, cr.acc,
                                        tuning, sx, leaf, model.clock, pro.prop, forced)
    check(torch.equal(acc_r, accept),
          f"{name}: the kernel accepted a proposal whose log alpha the plain version makes -inf")
    within("lq", pro.lq, pr.lq, SCAN_TIE)
    la = torch.nan_to_num(pr.d_pr - 0.5 * dq_r + pr.lmhg, nan=-math.inf)
    differ = (torch.log(u) < la) != accept
    gap = (torch.log(u) - la).abs()[differ]
    check(bool((gap < SCAN_TIE).all()), lambda: f"{name}: {int(differ.sum())} decisions differ "
          f"beyond ties (largest |log u - log alpha| {float(gap.max()):.3g})")
    within("dq", dq, dq_r, SCAN_REL, dq_r.abs().amax(1, keepdim=True).clamp(min=1.0))
    for what, a, b in (("heights", ck.batch.heights, cr.batch.heights),
                       ("rates", ck.batch.rates, cr.batch.rates), ("terms", ck.terms, cr.terms)):
        check(_same(a, b), lambda: f"{name} {what}: {int((a != b).sum())} values differ from "
              f"the replay's")
    for what, a, b in (("d", ck.d, cr.d), ("z", ck.z, cr.z), ("q", ck.q, cr.q)):
        within(what, a, b, SCAN_REL, max(1.0, float(b.abs().max())))
    check(torch.equal(ck.acc, cr.acc), f"{name}: accept counts differ")
    check(0 < int(accept.sum()) < accept.numel(), f"{name}: not a mixed case")
    log(f"[kernels] {name}: S={accept.shape[1]}, RB={sx['own'].shape[1]}, "
        f"{int(accept.sum())} accepts, {int(differ.sum())} tie decisions differ from the "
        f"replay, heights, rates and terms bitwise equal to it; largest differences "
        f"{json.dumps(worst)}")
    return worst, rec, copy


def check_range_step(n_taxa):
    """K5 (prologue, range_scan, epilogue) on the first block of every
    bucket of both likelihood range kinds; the records keep the block with
    the most tickets.  Returns a record per kernel."""
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.kernels import range_step as K
    from mcmcdate_tpu_torch.kernels.range_scan import range_scan, range_scan_plain

    fs, carry, tuning, gen = _fast(n_taxa)
    worst, timed = {}, None
    for (kind, rb), steps in fs.range_t.items():
        if kind == P.K_SCALE_SUBTREES_CONTRA:
            continue
        sx = steps[0]
        draw, u = _draws(fs, sx, tuning, gen, kind == P.K_SCALE_SUBTREE_RATE)
        w, rec, copy = _range_step_agree(f"range step kind {kind} rows {rb} at {n_taxa} taxa",
                                         fs, carry, tuning, kind, sx, draw, u)
        for k, v in w.items():
            worst[k] = max(worst.get(k, 0.0), v)
        if timed is None or sx["rows"].shape[0] > timed[1]["rows"].shape[0]:
            timed = kind, sx, draw, u, rec, copy
    kind, sx, draw, u, rec, copy = timed
    rate = kind == P.K_SCALE_SUBTREE_RATE
    model = fs.model
    leaf = model.topo.is_leaf_t
    pro, (accept, dq) = rec["range_lik_prologue"], rec["range_scan"]
    c1, c2, c3 = copy(), copy(), copy()
    pargs = (rate, c1.batch, c1.terms, c1.d, c1.z, tuning, sx, leaf, model.clock, draw)
    eargs = (rate, c2.batch, c2.terms, c2.d, c2.q, c2.acc, sx, pro, accept, dq)
    sargs = rec["range_scan_args"]

    def plain_step():
        p = K.range_lik_prologue_plain(*pargs)
        a, q_ = range_scan_plain(p.g, p.zg, sx["Q"], p.coef, p.d_pr, p.lmhg, u)
        _, dacc = K.range_lik_epilogue_plain(rate, c3.batch, c3.terms, c3.d, c3.q, c3.acc, sx,
                                             p, a, q_)
        c3.z.addmm_(dacc, sx["Prow"])

    ms = {"prologue": _device_ms(lambda: K.range_lik_prologue(*pargs),
                                 only="range_lik_prologue_kernel"),
          "scan": _device_ms(lambda: range_scan(*sargs), only="range_scan_kernel"),
          "epilogue": _device_ms(lambda: K.range_lik_epilogue(*eargs),
                                 only="range_lik_epilogue_kernel"),
          "step": _device_ms(lambda: fs.range_lik_step(kind, c3, tuning, sx, draw, u))}
    plain = {"prologue": _device_ms(lambda: K.range_lik_prologue_plain(*pargs)),
             "scan": _device_ms(lambda: range_scan_plain(*sargs)),
             "epilogue": _device_ms(lambda: K.range_lik_epilogue_plain(*eargs)),
             "step": _device_ms(plain_step)}
    C, S = accept.shape
    RB = sx["own"].shape[1]
    F = S * RB
    KN = pro.cal_new.shape[-1]
    R = int((sx["own"] >= 0).sum())                     # valid rows of the block
    rows_acc = int((accept.to(torch.int64) * (sx["own"] >= 0).sum(1)).sum())
    log(f"[kernels] range step kind {kind} at {n_taxa} taxa (S={S}, RB={RB}): device time per "
        f"block: the step {ms['step']:.4f} ms (plain {plain['step']:.4f} ms), of which "
        f"prologue {ms['prologue']:.4f}, range_scan {ms['scan']:.4f}, epilogue "
        f"{ms['epilogue']:.4f} ms")
    # Prologue.  Bytes: per chain and ticket the draw, tuning, the root's
    # and its parent's heights in and five outputs; per chain and valid row
    # its height, parent height, rate, d, z and two terms in; five row
    # outputs per chain and row slot; per calibration slot a height and a
    # term in and the term out; five scalars per chain; the block's plan
    # arrays.  Operations: about 120 per row (the birth-death term in
    # double, the clock term) and 100 per ticket (the proposal), special
    # functions counted as 10.
    pro_bytes = (4 * C * S * 9 + 4 * C * R * 7 + 4 * C * F * 5 + 4 * C * S * KN * 3 + 20 * C
                 + 4 * 3 * F + 4 * 8 * S)
    # range_scan.  Bytes: g, zg, Q and the four [C, S] inputs in; accept
    # and dq out.  Operations: the Gram blocks a <= b (2 RB^2 + 2 RB each),
    # v, the scan.
    scan_ops = C * (S * (S + 1) // 2 * (2 * RB * RB + 2 * RB) + 2 * S * RB + 3 * S * S)
    scan_bytes = 4 * (2 * C * F + F * F + 4 * C * S) + 5 * C * S
    # Epilogue.  Bytes: accept, coef and dq per chain and ticket in; dacc
    # out; per accepted row g and its three new values in, its height or
    # rate and two terms out, d in and out; q in and out; the block's
    # plan arrays.  Operations: one product per accepted row.
    epi_bytes = (9 * C * S + 4 * C * F + (28 if rate else 36) * rows_acc + 8 * C + 4 * 2 * F
                 + 4 * S)
    sw = worst
    return {
        "range_lik_prologue": _record(max(sw["prop"], sw["lq"]), ms["prologue"],
                                      plain["prologue"], pro_bytes, C * (120 * R + 100 * S)),
        "range_scan": _record(sw["dq"], ms["scan"], plain["scan"], scan_bytes, scan_ops),
        "range_lik_epilogue": _record(max(sw["d"], sw["z"], sw["q"]), ms["epilogue"],
                                      plain["epilogue"], epi_bytes, rows_acc),
    }


def _contra_agree(name, mode, fs, carry, tuning, sx, u_prop, u_acc):
    """K6 in one mode on one step against its plain version, on copies of
    ``carry``: the kernel's proposals against the plain version's from the
    same uniforms; the kernel's proposals replayed through the plain
    version, whose decisions must equal the kernel's except at ties and,
    with the ties taken as the kernel took them, whose heights, rates, terms
    and accept counts must equal the kernel's on every chain and ticket;
    distance invariance; and the kernel's terms against a fresh evaluation
    of its own new state.  Returns ``(worst differences, kernel output,
    run(fn))``, where ``run`` calls the kernel or its plain version on that
    function's own copy."""
    import torch

    from mcmcdate_tpu_torch.engine.fast_sweep import FastCarry
    from mcmcdate_tpu_torch.kernels import contra_step as K
    from mcmcdate_tpu_torch.kernels.prior_terms import prior_terms_plain
    from mcmcdate_tpu_torch.models.state import FIELDS, State

    kernel, plain, given = getattr(K, f"contra_{mode}"), getattr(K, f"contra_{mode}_plain"), \
        getattr(K, f"contra_{mode}_given")
    model = fs.model
    leaf = model.topo.is_leaf_t

    def copy():
        return FastCarry(State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}),
                         carry.terms.clone(), carry.d, carry.z, carry.q, carry.acc.clone())

    def run(fn, c):
        return fn(c.batch, c.terms, c.acc, tuning, sx, leaf, model.clock, u_prop, u_acc)

    def lengths(st):
        """Branch distances (time x rate) and the size of the products they
        are the difference of: a short branch loses bits to cancellation."""
        par, nr = model.topo.parent_t, model.topo.non_root_t
        h, r = st.heights, st.rates
        return (torch.where(nr, (h[:, par] - h) * r, 0.0),
                torch.where(nr, (h[:, par].abs() + h.abs()) * r.abs(), 0.0))

    worst = {}

    def within(what, a, b, rel):
        fin = torch.isfinite(b)
        check(torch.equal(fin, torch.isfinite(a)), f"{name} {what}: finiteness differs")
        inf = ~fin & ~torch.isnan(b)
        check(torch.equal(a[inf], b[inf]), f"{name} {what}: infinite values differ")
        err = (a - b).abs()[fin]
        worst[what] = float(err.max()) if err.numel() else 0.0
        check(bool((err <= rel * (1 + b.abs()[fin])).all()),
              lambda: f"{name} {what}: off the plain version by {worst[what]:.3g}")

    ck, cp, cr = copy(), copy(), copy()
    ok, op = run(kernel, ck), run(plain, cp)
    _sync()
    valid = sx["valid"].expand_as(ok.accept)
    # The proposals, drawn from the same uniforms.
    within("h_prop", torch.where(valid, ok.h_prop, 0.0), torch.where(valid, op.h_prop, 0.0),
           CONTRA_REL)
    # The kernel's proposals through the plain version, each decision taken
    # as the kernel took it (log 0 < any finite log alpha; log NaN < nothing).
    forced = torch.where(ok.accept, 0.0, math.nan)
    orr = given(cr.batch, cr.terms, cr.acc, tuning, sx, leaf, model.clock, ok.h_prop, forced)
    within("lq", torch.where(valid, ok.lq, 0.0), torch.where(valid, orr.lq, 0.0), SCAN_TIE)
    check(torch.equal(orr.accept, ok.accept),
          f"{name}: the kernel accepted a proposal whose log alpha the plain version makes -inf")
    logu = torch.log(u_acc)
    differ = ((logu < orr.log_alpha) & valid) != ok.accept
    gap = (logu - orr.log_alpha).abs()[differ]
    check(bool((gap < SCAN_TIE).all()), lambda: f"{name}: {int(differ.sum())} decisions differ "
          f"beyond ties (largest |log u - log alpha| {float(gap.max()):.3g})")
    fin = torch.isfinite(orr.log_alpha)
    check(torch.equal(fin, torch.isfinite(ok.log_alpha)), f"{name}: log alpha finiteness differs")
    worst["log_alpha"] = float((ok.log_alpha - orr.log_alpha).abs()[fin].max())
    for what, a, b in (("heights", ck.batch.heights, cr.batch.heights),
                       ("rates", ck.batch.rates, cr.batch.rates), ("terms", ck.terms, cr.terms)):
        within(what, a, b, CONTRA_REL)
    check(torch.equal(ck.acc, cr.acc), f"{name}: accept counts differ")
    check(0 < int(ok.accept.sum()) < int(valid.sum()), f"{name}: not a mixed case")
    (l0, m0), (l1, _) = lengths(carry.batch), lengths(ck.batch)
    worst["distances"] = float(((l1 - l0).abs() / m0.clamp(min=1e-30)).max())
    check(worst["distances"] <= CONTRA_REL, lambda: f"{name}: a branch distance moved by "
          f"{worst['distances']:.3g} of its heights' products")
    direct = prior_terms_plain(model, ck.batch)
    fin = torch.isfinite(direct)
    check(torch.equal(fin, torch.isfinite(ck.terms)), f"{name} terms: finiteness differs")
    err = (ck.terms[fin] - direct[fin]).abs()
    worst["fresh_terms"] = float(err.max())
    check(bool((err <= CONTRA_REL * (1 + direct[fin].abs())).all()),
          lambda: f"{name} terms: off a fresh evaluation by {worst['fresh_terms']:.3g}")
    n_bits = sum(int((x != y).sum()) for x, y in (
        (ck.batch.heights, cp.batch.heights), (ck.batch.rates, cp.batch.rates),
        (ck.terms, cp.terms)))
    log(f"[kernels] {name}: {tuple(u_acc.shape)} tickets, {int(ok.accept.sum())} accepts, "
        f"{int(differ.sum())} tie decisions differ from the replay, "
        f"{int((ok.accept != op.accept).sum())} from the plain run, {n_bits} values not "
        f"bitwise equal to the plain run's; largest differences {json.dumps(worst)}")
    return worst, ok, lambda fn: run(fn, ck if fn is kernel else cp)


def _contra_steps(fs, mode):
    """The plan steps of a K6 mode: ``(label, rows bucket, step)`` for the
    first contrary slide step, or the first block of each contrary range
    bucket."""
    from mcmcdate_tpu_torch.engine import proposals as P

    if mode == "slide":
        return [("slide", None, fs.spec_t[P.K_SLIDE_NODES_CONTRA][0])]
    return sorted(((f"range {rb} rows", rb, blocks[0]) for (k, rb), blocks in fs.range_t.items()
                   if k == P.K_SCALE_SUBTREES_CONTRA), key=lambda st: st[1])


def _check_contra(mode, n_taxa):
    """K6's ``mode`` at every step of ``_contra_steps``: ``[(rows bucket,
    step, accept, ms, plain_ms, worst)]``."""
    from mcmcdate_tpu_torch.kernels import contra_step as K

    kernel, plain = getattr(K, f"contra_{mode}"), getattr(K, f"contra_{mode}_plain")
    fs, carry, tuning, gen = _fast(n_taxa)
    out = []
    for step, rb, sx in _contra_steps(fs, mode):
        u_prop, u_acc = _draws(fs, sx, tuning, gen, False)
        w, ok, run = _contra_agree(f"contra_{mode} {step} at {n_taxa} taxa", mode, fs, carry,
                                   tuning, sx, u_prop, u_acc)
        ms = _device_ms(lambda: run(kernel), only=f"contra_{mode}_kernel")
        plain_ms = _device_ms(lambda: run(plain))
        log(f"[kernels] contra_{mode} {step} at {n_taxa} taxa: device time per call: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        out.append((rb, sx, ok.accept, ms, plain_ms, max(w["h_prop"], w["heights"])))
    return out


def check_contra_slide(n_taxa):
    [(_, sx, accept, ms, plain_ms, worst)] = _check_contra("slide", n_taxa)
    C, B = accept.shape
    KC, KT = sx["ch"].shape[1], sx["t_rows"].shape[1]
    # Bytes: per (chain, ticket) the gathered heights, rates, tuning,
    # uniforms and touched terms in, the accept mask, log alpha and the
    # proposal out, and for its accepts the height, rates, terms and count
    # out; per chain four scalars; the step's plan arrays.  Operations:
    # about 60 per touched term and 100 for the truncated normal (each
    # special function counted as 10).
    nbytes = (4 * C * B * (9 + 2 * KC + KT) + C * B + 16 * C + B * (4 * (4 + KC + KT) + 1)
              + 4 * int(accept.sum()) * (3 + KC + KT))
    return {"contra_slide": _record(worst, ms, plain_ms, nbytes, C * B * (60 * KT + 100))}


def check_contra_range(n_taxa):
    """A record per row bucket: ``contra_range_16``, ``_64``, ``_256``."""
    out = {}
    for rb, sx, accept, ms, plain_ms, worst in _check_contra("range", n_taxa):
        C, S = accept.shape
        RB = sx["own"].shape[1]
        rows = (sx["own"] >= 0).sum(1)                      # valid rows per ticket [S]
        R = int(rows.sum())
        acc_rows = int((accept.to(rows.dtype) * rows).sum())
        # Bytes: per (chain, ticket) the tuning, uniforms and parent height
        # in and the accept mask, log alpha and proposal out; per chain and
        # valid row its height, rate and two terms in, and for the accepted
        # tickets' rows the same out; per chain four scalars; the block's
        # plan arrays (rows, parents, leaf flags).  Operations: about 120
        # per row (its birth-death term in double and its clock term) and
        # 100 per ticket for the truncated normal (special functions
        # counted as 10).
        nbytes = (4 * C * S * 7 + C * S + 4 * C * R * 4 + 4 * acc_rows * 4 + 16 * C
                  + S * RB * 9 + 4 * S * 8)
        out[f"contra_range_{rb}"] = _record(worst, ms, plain_ms, nbytes,
                                            C * (120 * R + 100 * S))
    return out


_GLOB = {}


def _glob_fast(n_taxa):
    """FastSweeps on the synthetic model of a shape with the smoke's node
    priors and the calibrated proposal table, where all 14 glob families
    appear, with a carry (z and q filled), a tuning and a generator (built
    once)."""
    import dataclasses

    import torch

    from mcmcdate_tpu_torch.engine import fast_sweep, proposals as P

    if n_taxa not in _GLOB:
        model, batch = _model(n_taxa)
        cal, con, br = _node_priors(model.topo)
        model = dataclasses.replace(model, calibrations=cal, constraints=con, braces=br)
        table = P.build_proposal_table(model.topo, model.braces, model.calibrations_available)
        fs = fast_sweep.FastSweeps(model, table)
        carry = fs.init_carry(batch)
        carry.z, carry.q = fs._zq_from_y(model.whitened_residual_internal(carry.batch))
        gen = torch.Generator(device="cuda").manual_seed(n_taxa + 1)
        tuning = 0.3 + 2.7 * torch.rand((CHAINS, table.n_proposals), generator=gen,
                                        device="cuda")
        _GLOB[n_taxa] = fs, carry, tuning, gen
    return _GLOB[n_taxa]


def _glob_draws(fam, tuning, gen):
    """A family's draws as ``FastSweeps.glob_phase`` makes them: ``(tun,
    draws, u_acc)``, each ``[C, n]``."""
    import torch

    from mcmcdate_tpu_torch.kernels import glob_step as G
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    tun = tuning.index_select(1, fam.rows)
    draws = (standard_gamma(fam.sd / tun, gen) if fam.tag in G.GAMMA_TAGS
             else torch.rand((CHAINS, fam.n), generator=gen, device="cuda"))
    return tun, draws, torch.rand((CHAINS, fam.n), generator=gen, device="cuda")


def _glob_run(fs, fam, carry, tun, draws, u_acc):
    """A family through the glob kernels, as ``FastSweeps.glob_phase``
    runs it: ``(accept, prop, mean)`` ``[C, n]`` (mean: var_tree's only)."""
    import torch

    from mcmcdate_tpu_torch.kernels import glob_step as G

    if G.FAMILIES[fam.tag].lik != G.DENSE:
        out = G.glob_scan(fs.glob, fam, carry, tun, draws, u_acc)
        return out.accept, out.prop, None
    acc, prop, mean = [], [], []
    for s in range(fam.n):
        pro = G.glob_dense_prologue(fs.glob, fam, s, carry, tun, draws)
        acc.append(G.glob_dense_epilogue(fs.glob, fam, s, carry, pro, fs._x_P(pro.delta), u_acc))
        prop.append(pro.prop)
        mean.append(pro.mean)
    return (torch.stack(acc, 1), torch.stack(prop, 1),
            torch.stack(mean, 1) if fam.tag == "var_tree" else None)


def _glob_agree(name, fs, carry, fam, tun, draws, u):
    """One family through the glob kernels against its plain scan, on
    copies of ``carry``: the kernels' proposals (and var_tree's rate means)
    against the plain version's from the same draws; the kernels'
    proposals replayed through ``glob_family_plain`` with every decision
    taken as the kernels took it, whose log alpha must give the kernels'
    decisions except at ties and whose heights, rates, scalars and terms
    must equal the kernels' bitwise, with d, z and q within SCAN_REL of
    their scale and equal accept counts.  Returns ``(worst differences,
    accept)``."""
    import torch

    ck, cr = _copy_carry(carry), _copy_carry(carry)
    accept, prop, mean = _glob_run(fs, fam, ck, tun, draws, u)
    _sync()
    forced = torch.where(accept, 0.0, math.nan)
    rec = fs.glob_family_plain(fam.tag, cr, tun, draws, forced, given=dict(prop=prop, mean=mean))
    _sync()
    worst = {}

    def within(what, a, b, lim):
        fin = torch.isfinite(b)
        check(torch.equal(fin, torch.isfinite(a)), f"{name} {what}: finiteness differs")
        err = (a - b).abs()[fin]
        worst[what] = float(err.max()) if err.numel() else 0.0
        check(bool((err <= lim[fin] if torch.is_tensor(lim) else err <= lim).all()),
              lambda: f"{name} {what}: off the plain version by {worst[what]:.3g}")

    lim = CONTRA_REL * (1 + rec.prop.abs())
    if rec.dx_dp is not None:
        lim = lim + PROP_ULPS * torch.finfo(torch.float32).eps * rec.dx_dp
    within("prop", prop, rec.prop, lim)
    if mean is not None:
        within("mean", mean, rec.mean, CONTRA_REL * (1 + rec.mean.abs()))
    check(torch.equal(rec.accept, accept),
          f"{name}: the kernel accepted a proposal whose log alpha the plain version makes -inf")
    differ = (torch.log(u) < rec.log_alpha) != accept
    gap = (torch.log(u) - rec.log_alpha).abs()[differ]
    check(bool((gap < SCAN_TIE).all()), lambda: f"{name}: {int(differ.sum())} decisions differ "
          f"beyond ties (largest |log u - log alpha| {float(gap.max()):.3g})")
    for what in ("heights", "rates", "birth", "death", "height", "rate_mean", "rate_var"):
        a, b = getattr(ck.batch, what), getattr(cr.batch, what)
        check(_same(a, b), lambda: f"{name} {what}: {int((a != b).sum())} values differ from "
              f"the replay's")
    check(_same(ck.terms, cr.terms), lambda: f"{name} terms: "
          f"{int((ck.terms != cr.terms).sum())} values differ from the replay's")
    for what, a, b in (("d", ck.d, cr.d), ("z", ck.z, cr.z), ("q", ck.q, cr.q)):
        within(what, a, b, SCAN_REL * max(1.0, float(b.abs().max())))
    check(torch.equal(ck.acc, cr.acc), f"{name}: accept counts differ")
    log(f"[kernels] {name}: {fam.n} tickets, {int(accept.sum())} accepts of {accept.numel()}, "
        f"{int(differ.sum())} tie decisions differ from the replay, state and terms bitwise "
        f"equal to it; largest differences {json.dumps(worst)}")
    return worst, accept


def check_glob(n_taxa):
    """G1-G3 on all 14 glob families of the calibrated synthetic model,
    each family's tickets in full, against the plain scan; then
    ``FastSweeps.glob_phase`` on the card launches only the glob kernels
    (never K1 nor the plain step).  The records time G1 on bd_scale (the
    family with the most tickets) and G2/G3 on sub_ultra's first ticket."""
    import torch

    from mcmcdate_tpu_torch.engine.fast_sweep import GLOB_ORDER
    from mcmcdate_tpu_torch.kernels import glob_step as G

    fs, carry, tuning, gen = _glob_fast(n_taxa)
    check(tuple(fs.glob_fam) == GLOB_ORDER,
          f"the calibrated model has the glob families {tuple(fs.glob_fam)}")
    worst, n_acc, n_all, draws_of = {}, 0, 0, {}
    for tag, fam in fs.glob_fam.items():
        draws_of[tag] = _glob_draws(fam, tuning, gen)
        w, accept = _glob_agree(f"glob {tag} at {n_taxa} taxa", fs, carry, fam, *draws_of[tag])
        for k, v in w.items():
            worst[k] = max(worst.get(k, 0.0), v)
        n_acc += int(accept.sum())
        n_all += accept.numel()
        draws_of[tag] += (accept,)
    check(0 < n_acc < n_all, f"glob families accepted {n_acc} of {n_all}: not a mixed case")
    dense = [f for f in fs.glob_fam.values() if G.FAMILIES[f.tag].lik == G.DENSE]
    counts, _ = _counted(lambda: fs.glob_phase(_copy_carry(carry), tuning, gen))
    want = dict(glob_scan=len(fs.glob_fam) - len(dense),
                glob_dense_prologue=sum(f.n for f in dense),
                glob_dense_epilogue=sum(f.n for f in dense))
    check({k: v for k, v in counts.items() if v} == want,
          f"glob_phase launched {counts}, not only the glob kernels {want}")
    C, N = carry.batch.heights.shape
    D = carry.d.shape[1]
    nn = carry.terms.shape[1] - 4 - 2 * (N + 1)  # node-prior terms
    log(f"[kernels] glob_phase at {n_taxa} taxa: launches {want}, K1 and the plain step none")

    # G1 on bd_scale, the whole family.
    fam = fs.glob_fam["bd_scale"]
    tun, draws, u, accept = draws_of["bd_scale"]
    c1, c2 = _copy_carry(carry), _copy_carry(carry)
    ms1 = _device_ms(lambda: G.glob_scan(fs.glob, fam, c1, tun, draws, u), only="glob_scan_kernel")
    plain1 = _device_ms(lambda: fs.glob_family_plain("bd_scale", c2, tun, draws, u), reps=3)
    n = fam.n
    # Bytes: per chain the heights, the sc and bd term blocks and the five
    # scalars in, the three draws per ticket in and accept and prop out;
    # for the chains that accepted a ticket the two blocks and the two
    # rates out; the family's plan arrays.  Operations: per chain and
    # ticket the birth-death block in double (about 100 per node, each
    # exp or log counted as 10) and the proposal and scalar terms (about
    # 100 in float32).
    moved = int(accept.any(1).sum())
    nb1 = C * (4 * (N + (N + 5) + 5 + 3 * n) + 5 * n) + moved * 4 * (N + 7) + 12 * n
    # G2 and G3 on sub_ultra's first ticket.
    fam = fs.glob_fam["sub_ultra"]
    tun, draws, u, accept = draws_of["sub_ultra"]
    c3 = _copy_carry(carry)
    pro = G.glob_dense_prologue(fs.glob, fam, 0, c3, tun, draws)
    w = fs._x_P(pro.delta)
    pplain = G.glob_dense_prologue_plain(fs.glob, "sub_ultra", c3, tun[:, 0], fam.ticket(0),
                                         draws[:, 0])
    ms2 = _device_ms(lambda: G.glob_dense_prologue(fs.glob, fam, 0, c3, tun, draws),
                     only="glob_dense_prologue_kernel")
    plain2 = _device_ms(lambda: G.glob_dense_prologue_plain(
        fs.glob, "sub_ultra", c3, tun[:, 0], fam.ticket(0), draws[:, 0]))
    c4, c5 = _copy_carry(carry), _copy_carry(carry)
    acc0 = G.glob_dense_epilogue(fs.glob, fam, 0, _copy_carry(carry), pro, w, u)
    ms3 = _device_ms(lambda: G.glob_dense_epilogue(fs.glob, fam, 0, c4, pro, w, u),
                     only="glob_dense_epilogue_kernel")
    plain3 = _device_ms(lambda: G.glob_dense_epilogue_plain(fs.glob, "sub_ultra", c5, pplain, w,
                                                             u[:, 0], int(fam.grp.rows[0])))
    blk = 2 * (N + 1) + nn  # bd, ck and nd blocks
    # G2.  Bytes: per chain heights, rates, the three blocks, d, five
    # scalars and two draws in; the proposed heights, blocks, d_new, delta,
    # five scalars and six per-chain values out.  Operations: the
    # birth-death block in double, the clock block (about 40 per node) and
    # the distances (4 per row) in float32.
    nb2 = 4 * C * (2 * N + blk + D + 7) + 4 * C * (N + blk + 2 * D + 11)
    # G3.  Bytes: per chain delta, z, w, q and five per-chain values in;
    # for the accepted chains the proposed heights, blocks, d_new and z in
    # and heights, blocks, d, z, q and the count out.  Operations: dq (4
    # per row).
    na = int(acc0.sum())
    nb3 = 4 * C * (3 * D + 6) + 4 * na * (2 * (N + blk + 2 * D) + 2)
    return {
        "glob_scan": _record(max(worst["prop"], worst.get("mean", 0.0)), ms1, plain1, nb1,
                             100 * C * n, ops64=100 * C * n * N),
        "glob_dense_prologue": _record(worst["prop"], ms2, plain2, nb2,
                                      C * (40 * (N + 1) + 4 * D + 100), ops64=100 * C * N),
        "glob_dense_epilogue": _record(max(worst["d"], worst["z"], worst["q"]), ms3, plain3,
                                       nb3, 4 * C * D),
    }


# Each check returns its kernels' records by kernel name.
CHECKS = (check_prior_terms, check_whiten, check_ticket, check_point_step,
          check_range_step, check_prior_only_steps, check_contra_slide, check_contra_range,
          check_glob)


def phase_kernels():
    """Every kernel against its plain version at both shapes; the record
    keeps the run's shape (136 taxa)."""
    results = {}
    for n_taxa in (MAIN_TAXA, BENCH_TAXA):
        for fn in CHECKS:
            t0 = time.perf_counter()
            for name, r in fn(n_taxa).items():
                lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
                log(f"[kernels] {name} at {n_taxa} taxa x {CHAINS} chains: max error "
                    f"{r['max_abs_err']:.3g}, device time per call: kernel {r['ms']:.4f} ms, "
                    f"plain {r['plain_ms']:.4f} ms{lib}, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}) (check took {time.perf_counter() - t0:.1f} s)")
                if n_taxa == MAIN_TAXA:
                    results[name] = r
        _FAST.pop(n_taxa, None)
        _GLOB.pop(n_taxa, None)
        _MODELS.pop(n_taxa, None)
    return results


def check_carried_posterior(runner, run_dir, lp_post):
    """The run's last log posterior per chain, which the sweep carries
    incrementally (prior terms replaced per accepted ticket, the whitened
    residual updated by K2's deltas), against a fresh float32 evaluation of
    the saved final state by the plain versions; and that float32
    evaluation against a float64 one of the same state (the model's float32
    rounding, not the carry's).  Returns both errors."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch.engine import checkpoint as ckpt
    from mcmcdate_tpu_torch.tools.profile_sweep import direct_log_posterior

    state, _, _, _ = ckpt.load("smoke", in_dir=run_dir, device=runner.device)

    def direct(dtype):
        return direct_log_posterior(runner.model, state, dtype).double().cpu().numpy()

    d32 = direct(torch.float32)
    err = float(np.abs(d32 - lp_post).max())
    scale = float(np.abs(d32).max())
    check(err <= LP_REL * scale,
          f"carried log posterior is off the direct one by {err:.3g} at scale {scale:.3g}")
    err64 = float(np.abs(d32 - direct(torch.float64)).max())
    check(err64 <= LP_F64_REL * scale,
          f"float32 log posterior is off the float64 one by {err64:.3g} at scale {scale:.3g}")
    return err, err64


def _wrappers():
    from mcmcdate_tpu_torch.kernels.accept_select import accept_select
    from mcmcdate_tpu_torch.kernels.contra_step import contra_range, contra_slide
    from mcmcdate_tpu_torch.kernels.glob_step import (
        glob_dense_epilogue,
        glob_dense_prologue,
        glob_scan,
    )
    from mcmcdate_tpu_torch.kernels.point_scan import point_scan
    from mcmcdate_tpu_torch.kernels.point_step import point_lik_epilogue, point_lik_prologue
    from mcmcdate_tpu_torch.kernels.prior_terms import prior_terms
    from mcmcdate_tpu_torch.kernels.range_scan import range_scan
    from mcmcdate_tpu_torch.kernels.range_step import range_lik_epilogue, range_lik_prologue
    from mcmcdate_tpu_torch.kernels.ticket_step import ticket_prologue, ticket_scan
    from mcmcdate_tpu_torch.kernels.whiten import whiten

    return {"prior_terms": prior_terms, "whiten": whiten, "ticket_prologue": ticket_prologue,
            "accept_select": accept_select, "ticket_scan": ticket_scan,
            "point_lik_prologue": point_lik_prologue, "point_scan": point_scan,
            "point_lik_epilogue": point_lik_epilogue, "range_lik_prologue": range_lik_prologue,
            "range_scan": range_scan, "range_lik_epilogue": range_lik_epilogue,
            "contra_slide": contra_slide, "contra_range": contra_range, "glob_scan": glob_scan,
            "glob_dense_prologue": glob_dense_prologue,
            "glob_dense_epilogue": glob_dense_epilogue}


def _counted(run, inside=(), within=None):
    """Launch counts of every kernel during ``run()``, set to 0 just before
    it, with ``contra_range``'s also by row bucket (``contra_range_16``,
    ...); returns ``(counts, run's result)``.  The plain proposal kernels
    (``proposals.KERNELS``) are counted too, under ``plain_proposals``.
    ``inside`` names ``(class, method)`` pairs: the launch counts and plain
    proposals of their calls, and the calls, go to ``within[method]``."""
    from mcmcdate_tpu_torch.engine import proposals as P

    wrappers = _wrappers()
    by_rows = wrappers["contra_range"].launches_by_rows
    for w in wrappers.values():
        w.launches = 0
    for rb in by_rows:
        by_rows[rb] = 0
    plain = [0]
    real_k = dict(P.KERNELS)

    def counting(fn):
        def k(*a, **kw):
            plain[0] += 1
            return fn(*a, **kw)
        return k

    def inside_of(real, acc):
        def wrapped(self, *a, **kw):
            before = {k: w.launches for k, w in wrappers.items()}
            p0 = plain[0]
            out = real(self, *a, **kw)
            for k, w in wrappers.items():
                acc[k] = acc.get(k, 0) + w.launches - before[k]
            acc["plain_proposals"] = acc.get("plain_proposals", 0) + plain[0] - p0
            acc["calls"] = acc.get("calls", 0) + 1
            return out
        return wrapped

    saved = [(cls, meth, getattr(cls, meth)) for cls, meth in inside]
    for kk, fn in real_k.items():
        P.KERNELS[kk] = counting(fn)
    for cls, meth, real in saved:
        setattr(cls, meth, inside_of(real, within.setdefault(meth, {})))
    try:
        out = run()
    finally:
        P.KERNELS.update(real_k)
        for cls, meth, real in saved:
            setattr(cls, meth, real)
    counts = {k: w.launches for k, w in wrappers.items()}
    counts.update({f"contra_range_{rb}": n for rb, n in by_rows.items()})
    counts["plain_proposals"] = plain[0]
    return counts, out


def _check_seq_phase(name, within):
    """FastSweeps' sequential phase went through the ticket kernels alone:
    no K1, no plain proposal, T3 launched."""
    n = within.get("seq_phase", {})
    check(n.get("calls", 0) > 0, f"{name}: the sequential phase never ran")
    check(n["prior_terms"] == 0 and n["plain_proposals"] == 0 and n["ticket_scan"] > 0,
          f"{name}: the sequential phase launched {n}, not T3 (and T1, K2, K3) alone")
    return {k: round(v / n["calls"], 2) for k, v in n.items() if v and k != "calls"}


def _check_seq_sweeps(name, kern, within, n_chunks):
    """Every MHKernel sweep went through the ticket kernels alone: no K1
    and no plain proposal inside a sweep; T1, K2 and K3 once per ticket
    that breaks a run, T3 once per heavy ticket and at most once per run
    between them.  Returns the launches per sweep."""
    from mcmcdate_tpu_torch.kernels.ticket_step import HEAVY

    n = within.get("sweep_once", {})
    calls = n.get("calls", 0)
    check(calls > 0, f"{name}: no sweep ran")
    tt = kern.tt
    brk = sum(tt.breaks(int(p)) for p in kern.table.tickets)
    heavy = sum(not tt.breaks(int(p)) and tt.work[p] > HEAVY for p in kern.table.tickets)
    want = {"ticket_prologue": brk * calls, "accept_select": brk * calls,
            "whiten": brk * calls}
    got = {k: n.get(k, 0) for k in want}
    check(got == want, f"{name}: T1, K2, K3 launched {got}, not once per breaking ticket {want}")
    check(n["prior_terms"] == 0 and n["plain_proposals"] == 0,
          f"{name}: a sweep launched K1 or a plain proposal: {n}")
    check(max(1, heavy) * calls <= n["ticket_scan"] <= (2 * (brk + heavy) + n_chunks) * calls,
          f"{name}: {n['ticket_scan']} T3 launches in {calls} sweeps ({heavy} heavy tickets)")
    return {k: round(v / calls, 2) for k, v in n.items() if v and k != "calls"}


def _check_point_path(name, launches, kern):
    """The point and range phases of a FastSweeps run went through K4 and
    K5 alone: one prologue, scan and epilogue per likelihood point step and
    range block, or without a likelihood one prologue and epilogue and no
    scan (no plain step), and every contrary range bucket of the plan
    through K6."""
    from mcmcdate_tpu_torch.engine import proposals as P

    for step in ("point", "range"):
        names = tuple(f"{step}_{k}" for k in ("lik_prologue", "scan", "lik_epilogue"))
        n = {k: launches[k] for k in names}
        want = n[names[0]] > 0 and n[names[2]] == n[names[0]]
        want = want and n[names[1]] == (n[names[0]] if kern.use_lik else 0)
        check(want, f"{name}: the {step} steps launched {n}, not one prologue, "
              f"{'scan' if kern.use_lik else 'no scan'} and epilogue per step")
    for (k, rb) in kern.range_t:
        if k == P.K_SCALE_SUBTREES_CONTRA:
            check(launches[f"contra_range_{rb}"] > 0,
                  f"{name}: never launched contra_range on the {rb}-row bucket")


def phase_main_path():
    import numpy as np
    import torch

    from mcmcdate_tpu_torch import cli
    from mcmcdate_tpu_torch.engine.fast_sweep import FastSweeps

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        cli.main(["simulate", "--leaves", str(MAIN_TAXA), "--trees", str(TREES),
                  "--out", data])
        log(f"[main path] simulate took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cli.main(["prepare", "-a", "smoke", "--rooted-tree", os.path.join(data, "time.tree"),
                  "--trees", os.path.join(data, "trees.nwk"), "--likelihood-spec", "full",
                  "--out-dir", tmp])
        log(f"[main path] prepare took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        within = {}
        launches, runner = _counted(lambda: cli.main(
            ["run", "-a", "smoke", "--chains", str(CHAINS), "--profile", "--seed", "1",
             "--device", "cuda", "--iterations", str(ITERATIONS), "--out-dir", tmp]),
            inside=((FastSweeps, "seq_phase"),), within=within)
        wall = time.perf_counter() - t0
        check(isinstance(runner.kern, FastSweeps), "run did not take FastSweeps")
        for suffix in ("params.monitor", "timetree.monitor", "ratetree.monitor",
                       "prior.monitor", "mcmc.npz", "mcmc.json", "trace.npz"):
            check(os.path.exists(os.path.join(tmp, f"smoke.{suffix}")), f"missing smoke.{suffix}")
        with np.load(os.path.join(tmp, "smoke.trace.npz")) as z:
            lp_post = z["lp_post"]
        check(lp_post.shape[1] == CHAINS, f"trace has {lp_post.shape[1]} chains")
        check(bool(np.isfinite(lp_post[-1]).all()), "lp_post is not finite for every chain")
        lp_err, lp_f64 = check_carried_posterior(runner, tmp, lp_post[-1])
        rate = runner.accepted / runner.attempted
        check(0.0 < rate < 1.0, f"overall acceptance {rate}")
        n_sweeps = len(runner.sweep_seconds) * 10
        for k, n in launches.items():
            if k != "plain_proposals":
                check(n > 0 or k.startswith("contra_range_"), f"the main path never launched {k}")
        check(launches["plain_proposals"] == 0, "the main path ran a plain proposal kernel")
        seq_per_sweep = _check_seq_phase("main path", within)
        _check_point_path("main path", launches, runner.kern)
        # The sequential model for the last phase: this run's prepared data.
        args = cli.build_parser().parse_args(["run", "-a", "smoke", "--out-dir", tmp])
        seq_model, seq_init = cli._load_model(args, torch.device("cuda"), torch.float32,
                                              lambda *a: None)
    med = statistics.median(runner.sweep_seconds)
    per_sweep = {k: n / n_sweeps for k, n in launches.items()}
    log(f"[main path] FastSweeps, {MAIN_TAXA} taxa x {CHAINS} chains, {n_sweeps} sweeps "
        f"(--profile burn-in of 60, then {ITERATIONS} iterations: cut from --profile's 50) "
        f"in {wall:.1f} s; median "
        f"{med:.4f} s per sweep on {torch.cuda.get_device_name(0)}; acceptance {rate:.4f}; "
        f"carried log posterior within {lp_err:.3g} of the direct float32 one (float32 vs "
        f"float64 evaluation of the final state: {lp_f64:.3g}); launches {launches}; "
        f"per sweep {json.dumps({k: round(v, 2) for k, v in per_sweep.items()})}; the "
        f"sequential phase per sweep, no K1 and no plain proposal: {json.dumps(seq_per_sweep)}")
    return launches, (seq_model, seq_init)


def _check_lp(name, model, batch, lp_carried):
    """A run's carried float32 log posterior against a direct float32
    evaluation of its final state, and that against float64 (the limits of
    the main path's check)."""
    import torch

    from mcmcdate_tpu_torch.tools.profile_sweep import direct_log_posterior

    d32 = direct_log_posterior(model, batch, torch.float32).double()
    d64 = direct_log_posterior(model, batch, torch.float64)
    check(bool(torch.isfinite(lp_carried).all()), f"{name}: log posterior not finite")
    scale = float(d32.abs().max())
    err = float((lp_carried.double() - d32).abs().max())
    check(err <= LP_REL * scale,
          f"{name}: carried log posterior off the direct one by {err:.3g} at scale {scale:.3g}")
    err64 = float((d32 - d64).abs().max())
    check(err64 <= LP_F64_REL * scale,
          f"{name}: float32 log posterior off float64 by {err64:.3g} at scale {scale:.3g}")
    return err, err64


def _runner_phase(name, model, init, fast_sweep, n_sweeps, need):
    """``n_sweeps`` sweeps through ``ChainRunner`` (chunks of 10, counted),
    then one more sweep whose carried log posterior is checked.  Fails
    unless every kernel in ``need`` was launched, or where a sweep's
    sequential part (FastSweeps' sequential phase, or the sequential
    sweep) launched K1 or a plain proposal."""
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.engine.chains import ChainRunner, RunSettings, new_key
    from mcmcdate_tpu_torch.engine.fast_sweep import FastSweeps
    from mcmcdate_tpu_torch.engine.mh import MHKernel

    table = P.build_proposal_table(model.topo, model.braces, model.calibrations_available)
    settings = RunSettings(name, n_chains=CHAINS, seed=1, device="cuda",
                           fast_sweep=fast_sweep)
    runner = ChainRunner(model, table, settings, log=lambda *a: None)
    batch, tuning = runner.init_chains(init)

    def run():
        out = runner._run_window(batch, tuning, new_key(1), n_sweeps)
        b, _, acc, tot, _ = out
        b2, lp_pr, lp_lik, *_ = runner.kern.sweeps(b, tuning, 7, 1)
        return b2, lp_pr + lp_lik, float(acc.sum()) / float(tot.sum())

    t0 = time.perf_counter()
    within = {}
    inside = (FastSweeps, "seq_phase") if fast_sweep else (MHKernel, "sweep_once")
    launches, (batch, lp, rate) = _counted(run, inside=(inside,), within=within)
    wall = time.perf_counter() - t0
    for k in need:
        check(launches[k] > 0, f"{name}: never launched {k}")
    check(launches["plain_proposals"] == 0, f"{name}: ran a plain proposal kernel")
    if fast_sweep:
        _check_point_path(name, launches, runner.kern)
        seq = _check_seq_phase(name, within)
    else:
        seq = _check_seq_sweeps(name, runner.kern, within, 1)
    err, err64 = _check_lp(name, model, batch, lp)
    med = statistics.median(runner.sweep_seconds)
    if fast_sweep and runner.kern.use_lik:
        gathered = sum(sx[k].untyped_storage().nbytes() for steps in runner.kern.spec_t.values()
                       for sx in steps for k in ("Prow", "Pblk") if k in sx)
        log(f"[{name}] the point steps' Prow and Pblk, gathered once: {gathered / 1e9:.3f} GB")
    log(f"[{name}] {type(runner.kern).__name__}, {model.topo.n_leaves} taxa x {CHAINS} "
        f"chains, {n_sweeps + 1} sweeps in {wall:.1f} s; median {med:.4f} s per sweep "
        f"(chunks of 10) on {torch.cuda.get_device_name(0)}; acceptance {rate:.4f}; carried "
        f"log posterior within {err:.3g} of the direct float32 one (float32 vs float64: "
        f"{err64:.3g}); launches {launches}; {'the sequential phase' if fast_sweep else 'a sweep'}"
        f" per sweep, no K1 and no plain proposal: {json.dumps(seq)}")
    return launches


def phase_full_width():
    from mcmcdate_tpu_torch import synthetic

    model, batch = synthetic.build(BENCH_TAXA, 1, device="cuda")
    log(f"[full width] cut: {FULL_WIDTH_SWEEPS} sweeps (+1 for the carry check)")
    return _runner_phase("full width", model, batch, True, FULL_WIDTH_SWEEPS,
                         ("point_lik_prologue", "point_scan", "point_lik_epilogue",
                          "range_lik_prologue", "range_scan", "range_lik_epilogue",
                          "contra_slide", "contra_range", "glob_scan", "glob_dense_prologue",
                          "glob_dense_epilogue", "ticket_prologue", "accept_select",
                          "ticket_scan"))


def phase_prior_only():
    import dataclasses

    from mcmcdate_tpu_torch import synthetic
    from mcmcdate_tpu_torch.ops import mvn

    model, batch = synthetic.build(MAIN_TAXA, 1, device="cuda")
    model = dataclasses.replace(model, likelihood=mvn.LikelihoodData.none())
    log(f"[prior only] cut: {PRIOR_ONLY_SWEEPS} sweeps (+1 for the carry check)")
    return _runner_phase("prior only", model, batch, True, PRIOR_ONLY_SWEEPS,
                         ("point_lik_prologue", "point_lik_epilogue", "range_lik_prologue",
                          "range_lik_epilogue", "contra_slide", "contra_range", "glob_scan",
                          "glob_dense_prologue", "glob_dense_epilogue", "ticket_scan"))


def phase_sequential(seq):
    model, init = seq
    log(f"[sequential] cut: {SEQUENTIAL_SWEEPS} sweeps (+1 for the carry check) of the "
        f"main path's model")
    return _runner_phase("sequential", model, init, False, SEQUENTIAL_SWEEPS,
                         ("prior_terms", "whiten", "ticket_prologue", "accept_select",
                          "ticket_scan"))


def phase_univariate_10k():
    """The sequential path at its own full width: ChainRunner with the
    default settings on a univariate model of UNI_TAXA taxa (D = 19,997 >
    UNIVARIATE_DENSE_MAX, so the runner takes MHKernel; nothing O(N^2):
    no Cholesky factor) x CHAINS chains.  T3 against its plain version on
    a 256-ticket run of every kind (the record at this shape); then
    UNI_SWEEPS timed sweeps and one whose carried log posterior is checked,
    every sweep through T3 alone (no K1, no plain proposal, no T1, K2 or
    K3: no ticket breaks a run under the univariate kind)."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.engine.chains import ChainRunner, RunSettings
    from mcmcdate_tpu_torch.engine.fast_sweep import UNIVARIATE_DENSE_MAX
    from mcmcdate_tpu_torch.engine.mh import MHKernel
    from mcmcdate_tpu_torch.kernels.ticket_step import CHUNK, ticket_scan, ticket_scan_plain
    from mcmcdate_tpu_torch.tools.seq_time import univariate_model

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, init = univariate_model(UNI_TAXA, seed=0)
    check(model.chol_internal is None, "the univariate model built a Cholesky factor")
    check(model.likelihood.dim > UNIVARIATE_DENSE_MAX,
          f"D = {model.likelihood.dim} does not exceed {UNIVARIATE_DENSE_MAX}")
    table = P.build_proposal_table(model.topo, model.braces, model.calibrations_available)
    runner = ChainRunner(model, table, RunSettings("uni10k", n_chains=CHAINS, seed=1,
                                                   device="cuda"), log=lambda *a: None)
    tk = runner.kern
    check(isinstance(tk, MHKernel), f"the runner took {type(tk).__name__}, not MHKernel")
    batch, tuning = runner.init_chains(init)
    _sync()
    setup_s = time.perf_counter() - t0
    n_t = int(table.n_tickets)
    log(f"[univariate 10k] {UNI_TAXA} taxa x {CHAINS} chains, D = {model.likelihood.dim}, "
        f"{table.n_proposals} proposal rows, {n_t} tickets a sweep ({-(-n_t // CHUNK)} chunks); "
        f"setup {setup_s:.1f} s; cut: {UNI_SWEEPS} timed sweeps (+1 for the carry check)")
    gen = torch.Generator(device="cuda").manual_seed(10)
    carry = tk.init_carry(batch)
    order = np.random.default_rng(10).choice(np.asarray(table.tickets), 256).astype(np.int32)
    dr = tk.draws(order, tuning, gen)
    w = {}
    ties, n_acc, n_all = _ticket_scan_agree("ticket_scan at 10000 taxa", tk, carry, tuning, dr, w)
    check(0 < n_acc < n_all, f"ticket_scan accepted {n_acc} of {n_all}: not a mixed case")
    c1, c2 = _mh_copy(carry), _mh_copy(carry)
    ms = _device_ms(lambda: ticket_scan(tk.tt, c1, tuning, dr, 0, len(order)),
                    only="ticket_scan_kernel", reps=5)
    plain_ms = _device_ms(lambda: ticket_scan_plain(tk.tt, c2, tuning, dr, 0, len(order)), reps=1)
    fl, bd, ot = _ticket_work(tk.tt, order)
    rec = _record(max(w.get("prop", 0.0), w.get("y", 0.0)), ms, plain_ms, 4 * CHAINS * fl,
                  CHAINS * (40 * ot + 100 * len(order)), ops64=100 * CHAINS * bd)
    log(f"[kernels] ticket_scan at {UNI_TAXA} taxa x {CHAINS} chains (univariate, 256 tickets of "
        f"every kind): {n_acc} accepts of {n_all}, {ties} tie decisions differ from the replay, "
        f"state, terms and d bitwise equal to it; largest differences {json.dumps(w)}; device "
        f"time per call: kernel {ms:.4f} ms ({ms / len(order) * 1e3:.2f} us a ticket), plain "
        f"{plain_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    del carry, c1, c2
    torch.cuda.empty_cache()

    def run():
        times, b = [], batch
        for i in range(UNI_SWEEPS):
            t1 = time.perf_counter()
            b = tk.sweeps(b, tuning, 2 + i, 1)[0]
            _sync()
            times.append(time.perf_counter() - t1)
        b2, lp_pr, lp_lik, acc, tot, _ = tk.sweeps(b, tuning, 7, 1)
        return times, b2, lp_pr + lp_lik, float(acc.sum()) / float(tot.sum())

    within = {}
    t0 = time.perf_counter()
    launches, (times, b2, lp, rate) = _counted(run, inside=((MHKernel, "sweep_once"),),
                                               within=within)
    wall = time.perf_counter() - t0
    check(launches["plain_proposals"] == 0, "univariate 10k: ran a plain proposal kernel")
    per_sweep = _check_seq_sweeps("univariate 10k", tk, within, -(-n_t // CHUNK))
    check(0.0 < rate < 1.0, f"univariate 10k: acceptance {rate}")
    err, err64 = _check_lp("univariate 10k", model, b2, lp)
    log(f"[univariate 10k] MHKernel, {UNI_SWEEPS + 1} sweeps in {wall:.1f} s; sweeps "
        f"{json.dumps([round(t, 4) for t in times])} s, median {statistics.median(times):.4f} s "
        f"per sweep on {torch.cuda.get_device_name(0)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; acceptance {rate:.4f}; carried log "
        f"posterior within {err:.3g} of the direct float32 one (float32 vs float64: "
        f"{err64:.3g}); launches per sweep {json.dumps(per_sweep)}")
    return launches, rec


def main():
    """Run every phase; any failure raises, so the exit code is not 0."""
    import torch

    smi = phase_device()
    phase_build()
    t0 = time.perf_counter()
    results = phase_kernels()
    log(f"[kernels] all checks took {time.perf_counter() - t0:.1f} s")
    launches, seq = phase_main_path()
    full = phase_full_width()
    prior = phase_prior_only()
    sequential = phase_sequential(seq)
    uni, uni_rec = phase_univariate_10k()
    log(f"[ticket_scan] at {UNI_TAXA} taxa: {json.dumps(uni_rec)}")
    check("jax" not in sys.modules, "the port imported jax")
    check(not [m for m in sys.modules if m == "mcmcdate_tpu" or m.startswith("mcmcdate_tpu.")],
          "the port imported the JAX package")

    name = torch.cuda.get_device_name(0)
    record = {"kernels": [
        dict(name=k, route="cuda", source=src, replaces=rep, launches=launches[k],
             launches_by_path={"main": launches[k], "full_width": full[k],
                               "prior_only": prior[k], "sequential": sequential[k],
                               "univariate_10k": uni[k]},
             **results[k]) for k, src, rep in KERNELS
    ]}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
