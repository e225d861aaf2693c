#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mcmcdate_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the port's CUDA kernels from csrc/ and prints the time;
3. kernels: runs K1 prior_terms, K2 whiten (full, gather and range-1024
   row lists) and K3 accept_select on the card against their plain PyTorch
   versions, at the run's shape (136 taxa x 1024 chains) and at the bench
   shape (1000 taxa x 1024 chains), with the float32 tolerances below, and
   times each with CUDA events;
4. main path: simulate -> prepare --likelihood-spec full -> run (MHG, the
   sequential sweep) at 136 taxa x 1024 chains through the port's CLI, in
   a temporary directory; checks the outputs and that the run launched
   every kernel.

The last two lines of standard output are the card's name and power limit
and, on success, ``{"ok": true, "device": {...}}``; the line before them is
the kernels' JSON record.
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
# The run's iterations after the --profile burn-in (60 sweeps).  --profile
# alone would run 50; cut to 20 so the whole script stays inside its
# time limit (about 5 s per sweep at this shape on an H100).  Only the
# iterations are cut, never the taxa or the chains.
ITERATIONS = 20

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
    ("accept_select", "mcmcdate_tpu_torch/kernels/csrc/accept_select.cu",
     "mcmcdate_tpu/engine/mh.py:120"),
)


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


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


def _time_ms(fn, reps=20):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch

    fn()
    _sync()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
        check(not bool(bad.any()), f"prior_terms {clock}: max error {float(err.max()):.3g}")
        worst = max(worst, float(err.max()))
        bd = slice(4, 4 + m.topo.n + 1)
        p64 = prior_terms_plain(dataclasses.replace(m, dtype=torch.float64),
                                s.to(dtype=torch.float64))[:, bd]
        kb = k[:, bd].double()
        fin = torch.isfinite(p64)
        check(torch.equal(fin, torch.isfinite(kb)), f"prior_terms {clock}: finiteness vs f64")
        err = (kb[fin] - p64[fin]).abs()
        bad = err > K1_BD_F64_ATOL + K1_BD_F64_RTOL * p64[fin].abs()
        check(not bool(bad.any()),
              f"prior_terms {clock}: birth-death terms off float64 by {float(err.max()):.3g}")
    s = _perturbed(model, batch, 2)
    ms = _time_ms(lambda: prior_terms(model, s))
    plain_ms = _time_ms(lambda: prior_terms_plain(model, s))
    return worst, ms, plain_ms


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
        "full": dict(x=d, rows=model.rows_all, sub=mu),
        "full-delta": dict(x=d2, rows=model.rows_all, sub=mu, y=y, minus_y=True),
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
    ms = _time_ms(lambda: whiten(L=L, **kw))
    plain_ms = _time_ms(lambda: whiten_plain(L=L, **kw))
    return worst, ms, plain_ms


def check_accept_select(n_taxa):
    import torch

    from mcmcdate_tpu_torch.kernels.accept_select import accept_select, accept_select_plain
    from mcmcdate_tpu_torch.models.state import FIELDS, State
    from mcmcdate_tpu_torch.ops.heights import distances_internal

    model, batch = _model(n_taxa)
    old = _perturbed(model, batch, 4)
    new = _perturbed(model, batch, 5).replace(death=old.death)  # one field unchanged
    terms = model.log_prior_terms(old)
    terms2 = model.log_prior_terms(new)
    terms2[3::11, 7] = -math.inf  # some invalid proposals
    C = terms.shape[0]
    dev = terms.device
    g = torch.Generator(device=dev).manual_seed(0)
    d = distances_internal(old, model.topo).contiguous()
    d_new = distances_internal(new, model.topo).contiguous()
    y = torch.randn(d.shape, generator=g, device=dev)
    dy = 0.1 * torch.randn(d.shape, generator=g, device=dev)
    d_lik = -0.5 * torch.sum(dy * (2 * y + dy), dim=1)
    d_pr = torch.sum(terms2 - terms, dim=1)
    # log_mhg chosen so that about half of the chains accept.
    log_mhg = -(d_pr + d_lik) + torch.randn(C, generator=g, device=dev)
    lj = 0.01 * torch.randn(C, generator=g, device=dev)
    u = torch.rand(C, generator=g, device=dev)
    P = 40

    def run(fn, reps=1):
        st = State(**{k: getattr(old, k).clone() for k in FIELDS})
        nw = new.replace(death=st.death)
        out = dict(terms=terms.clone(), d=d.clone(), y=y.clone(),
                   acc=torch.zeros((C, P), dtype=torch.int32, device=dev))
        for _ in range(reps):
            a = fn(out["terms"], terms2, log_mhg, u, st, nw, out["acc"], 3, d_lik=d_lik, lj=lj,
                   d=out["d"], d_new=d_new, y=out["y"], dy=dy)
        return a, st, out

    ak, sk, ok_ = run(accept_select)
    ap, sp, op = run(accept_select_plain)
    _sync()
    differ = ak != ap
    if bool(differ.any()):
        alpha = (d_pr.masked_fill(~torch.isfinite(terms2).all(1), -math.inf) + d_lik
                 + log_mhg + lj)
        gap = (torch.log(u) - alpha).abs()[differ]
        check(bool((gap < K3_TIE).all()), f"accept_select: {int(differ.sum())} decisions differ")
    n_acc = int(ap.sum())
    check(0 < n_acc < C, f"accept_select check accepted {n_acc} of {C}: not a mixed case")
    same = ~differ
    worst = 0.0
    for name in FIELDS:
        a, b = getattr(sk, name)[same], getattr(sp, name)[same]
        worst = max(worst, float((a - b).abs().max()))
    for name in ("terms", "d", "y", "acc"):
        a, b = ok_[name][same], op[name][same]
        fin = torch.isfinite(b.float())
        check(torch.equal(fin, torch.isfinite(a.float())), f"accept_select {name}: inf differs")
        worst = max(worst, float((a[fin].float() - b[fin].float()).abs().max()))
    check(worst == 0.0, f"accept_select: selected values differ by {worst:.3g}")
    ms = _time_ms(lambda: run(accept_select, 1))
    base = _time_ms(lambda: run(lambda *a, **k: None, 1))  # the copies alone
    plain_ms = _time_ms(lambda: run(accept_select_plain, 1))
    return worst, max(ms - base, 0.0), max(plain_ms - base, 0.0)


def phase_kernels():
    results = {}
    for n_taxa in (MAIN_TAXA, BENCH_TAXA):
        for name, fn in (("prior_terms", check_prior_terms), ("whiten", check_whiten),
                         ("accept_select", check_accept_select)):
            t0 = time.perf_counter()
            err, ms, plain_ms = fn(n_taxa)
            log(f"[kernels] {name} at {n_taxa} taxa x {CHAINS} chains: max error {err:.3g}, "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                f"(check took {time.perf_counter() - t0:.1f} s)")
            if n_taxa == MAIN_TAXA:
                results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
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


def phase_main_path():
    import numpy as np

    from mcmcdate_tpu_torch import cli
    from mcmcdate_tpu_torch.kernels.accept_select import accept_select
    from mcmcdate_tpu_torch.kernels.prior_terms import prior_terms
    from mcmcdate_tpu_torch.kernels.whiten import whiten

    wrappers = {"prior_terms": prior_terms, "whiten": whiten, "accept_select": accept_select}
    for w in wrappers.values():
        w.launches = 0
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
        runner = cli.main(["run", "-a", "smoke", "--chains", str(CHAINS), "--profile",
                           "--seed", "1", "--device", "cuda", "--iterations", str(ITERATIONS),
                           "--out-dir", tmp])
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
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
        tickets = runner.table.n_tickets * n_sweeps
        for k, n in launches.items():
            check(n > 0, f"the run never launched {k}")
        check(launches["prior_terms"] >= tickets,
              f"prior_terms launched {launches['prior_terms']} times for {tickets} tickets")
    import torch

    med = statistics.median(runner.sweep_seconds)
    log(f"[main path] {MAIN_TAXA} taxa x {CHAINS} chains, {runner.table.n_tickets} tickets "
        f"per sweep, {n_sweeps} sweeps (--profile burn-in of 60, then {ITERATIONS} "
        f"iterations: cut from --profile's 50 to fit the time limit) in {wall:.1f} s; "
        f"median {med:.4f} s per sweep on {torch.cuda.get_device_name(0)}; "
        f"acceptance {rate:.4f}; carried log posterior within {lp_err:.3g} of the direct "
        f"float32 one (float32 vs float64 evaluation of the final state: {lp_f64:.3g}); "
        f"launches {launches}")
    return launches, med


def main():
    """Run every phase; any failure raises, so the exit code is not 0."""
    import torch

    smi = phase_device()
    phase_build()
    results = phase_kernels()
    launches, _ = phase_main_path()
    check("jax" not in sys.modules, "the port imported jax")

    name = torch.cuda.get_device_name(0)
    record = {"kernels": [
        dict(name=k, route="cuda", source=src, replaces=rep, launches=launches[k],
             **results[k]) for k, src, rep in KERNELS
    ]}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
