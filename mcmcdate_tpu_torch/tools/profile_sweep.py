"""Profile a sweep on a CUDA card and check its carry.

Run from the root of a checkout, on a machine with a card:

    python -m mcmcdate_tpu_torch.tools.profile_sweep [--sweep fast|sequential]
        [--taxa 136|1000|5000] [--fiber-slide P] [--bold-contra P]
        [--out profile_sweep.json] [--trace TRACE.json]

at the shape of ``chip_smoke.py``'s main path (136 taxa x 1024 chains) or,
with ``--taxa 1000``, of its full-width phase (1000 taxa x 1024 chains),
or with ``--taxa 5000`` of its banded full-width phase (5,000 taxa x 1024
chains, "banded 128"), for the ticket-batched sweep (``fast``, the default, as ``run`` takes it)
or the sequential one:

1. at 136 taxa ``simulate`` and ``prepare --likelihood-spec full`` in a
   temporary directory, then the run's initial chain batch (jittered
   rates, untuned proposals), as ``run`` builds it; at 1000 taxa the
   ``synthetic.build`` model (a full MVN likelihood over 1,997 distances),
   at 5000 its banded model (9,997 distances, bandwidth 128), and the same
   initial batch;
2. ``WARMUP`` sweeps, then ``TIMED`` sweeps, each timed on the host clock
   up to a device sync;
3. one sweep under ``torch.profiler``: kernel launches (runtime and driver
   API calls), device time per kernel name, and the device's busy share:
   the union of the kernel, memcpy and memset intervals of the trace over
   the sweep's host span, so that rows which overlap or repeat one another
   count once.  For the ticket-batched sweep, also launches, device time
   and host span per phase (``seq``, ``glob``, ``point``, ``range``,
   ``y`` and, with ``--fiber-slide``, ``fiber``), with the phase's
   launches counted by the kernel they started:
   a device interval belongs to the phase whose host span holds the launch
   it came from; and the number of range blocks of each proposal kind;
4. one sweep with the carry checked: for the sequential sweep after every
   ticket (distances ``d``, whitened residual ``y``, prior terms against
   direct float32 evaluations of the carried state); for the batched one
   at the end of every phase (``d``, the terms, and ``y`` after the
   sequential phase or ``z = P (d - mu)`` and ``q`` after the others); at
   the end the carried log posterior against direct float32 and float64
   ones.

``--fiber-slide P`` and ``--bold-contra P`` turn the optional moves of
``run`` on in the ticket-batched sweep (the fiber node-slide phase with
probability ``P`` a sweep, F1 a colour class; the bold mixture in K6's
range mode and G1's sub_contra, factor 8).  Writes the record to ``--out``
(also printed as the last line).  The
profiler's chrome trace (hundreds of MB at the default shape) is kept only
where ``--trace`` names a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
PORT_KERNELS = ("prior_terms_kernel", "whiten", "accept_select_kernel",
                "point_lik_prologue_kernel", "point_scan_kernel", "point_lik_epilogue_kernel",
                "range_lik_prologue_kernel", "range_scan_kernel", "range_lik_epilogue_kernel",
                "contra_slide_kernel", "contra_range_kernel", "glob_scan_kernel",
                "glob_dense_prologue_kernel", "glob_dense_epilogue_kernel",
                "ticket_prologue_kernel", "ticket_scan_kernel", "band_kernel", "band_rows_kernel",
                "fiber_slide_kernel", "fiber_de_kernel")
PHASES = ("seq", "glob", "point", "range", "y", "fiber")
TAXA, FULL_TAXA, BANDED_TAXA, CHAINS, TREES, SEED = 136, 1000, 5000, 1024, 600, 1
WARMUP, TIMED = 10, 2
TOP_BY_PHASE = 16  # kernel names kept per phase, by launches


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def setup(tmp: str, fast: bool = True, taxa: int = TAXA, moves=None):
    """The run's model, runner and initial batch and tuning, on the card:
    the main path's simulated and prepared model at ``TAXA``, the synthetic
    full model at ``FULL_TAXA`` and banded one at ``BANDED_TAXA``;
    ``moves``: the optional moves' ``RunSettings`` fields."""
    moves = moves or {}
    from .. import cli, synthetic
    from ..engine import proposals as props
    from ..engine.chains import ChainRunner, RunSettings

    quiet = lambda *a: None  # noqa: E731
    if taxa in (FULL_TAXA, BANDED_TAXA):
        model, init = synthetic.build(taxa, 1, device="cuda",
                                      kind="banded" if taxa == BANDED_TAXA else "full")
        table = props.build_proposal_table(model.topo, model.braces, False)
        settings = RunSettings("prof", n_chains=CHAINS, seed=SEED, device="cuda",
                               fast_sweep=fast, **moves)
        runner = ChainRunner(model, table, settings, log=quiet)
        return (runner, *runner.init_chains(init))
    data = os.path.join(tmp, "data")
    cli.main(["simulate", "--leaves", str(TAXA), "--trees", str(TREES), "--out", data])
    cli.main(["prepare", "-a", "prof", "--rooted-tree", os.path.join(data, "time.tree"),
              "--trees", os.path.join(data, "trees.nwk"), "--likelihood-spec", "full",
              "--out-dir", tmp])
    args = cli.build_parser().parse_args(
        ["run", "-a", "prof", "--chains", str(CHAINS), "--seed", str(SEED),
         "--device", "cuda", "--out-dir", tmp])
    model, init = cli._load_model(args, torch.device("cuda"), torch.float32, quiet)
    table = props.build_proposal_table(model.topo, model.braces, model.calibrations_available)
    settings = dataclasses.replace(cli._settings(args), fast_sweep=fast, **moves)
    runner = ChainRunner(model, table, settings, log=quiet)
    batch, tuning = runner.init_chains(init)
    return runner, batch, tuning


def _union(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def trace_summary(trace_path: str) -> dict:
    """Launches, device time per kernel and the busy share of the sweep
    from a chrome trace with one ``sweep`` annotation (times in us); per
    phase where the trace has phase annotations."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    span = next(e for e in events if e.get("cat") == "user_annotation" and e["name"] == "sweep")
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS and t0 <= e["ts"] <= t1]
    launch_ev = [e for e in events
                 if e.get("cat", "").startswith("cuda_") and e["name"] in LAUNCH_NAMES
                 and t0 <= e["ts"] <= t1]
    per_name: dict = {}
    for e in device:
        n, us = per_name.get(e["name"], (0, 0.0))
        per_name[e["name"]] = (n + 1, us + e["dur"])
    busy_us = _union((e["ts"], min(e["ts"] + e["dur"], t1)) for e in device)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])
    port = {}
    for k in PORT_KERNELS:
        rows = [(n, us) for name, (n, us) in per_name.items() if k in name]
        n = sum(r[0] for r in rows)
        us = sum(r[1] for r in rows)
        port[k] = dict(calls=n, device_s=us * 1e-6, us_per_call=us / n if n else None)
    out = dict(
        sweep_host_s=span["dur"] * 1e-6,
        launches=len(launch_ev),
        device_events=len(device),
        device_sum_s=sum(e["dur"] for e in device) * 1e-6,
        device_busy_s=busy_us * 1e-6,
        busy_share=busy_us / span["dur"] if span["dur"] else None,
        port_kernels=port,
        top_device=[dict(name=name[:120], calls=n, device_s=us * 1e-6)
                    for name, (n, us) in top[:12]],
    )
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"] in PHASES)
    if spans:
        def phase_of(ts):
            return next((nm for a, b, nm in spans if a <= ts <= b), None)

        launch_at = {e.get("args", {}).get("correlation"): e["ts"] for e in launch_ev}
        kernel_of = {e.get("args", {}).get("correlation"): e["name"] for e in device}
        phases = {nm: dict(host_s=0.0, launches=0, device_s=0.0) for _, _, nm in spans}
        by_kernel = {nm: {} for nm in phases}
        for a, b, nm in spans:
            phases[nm]["host_s"] += (b - a) * 1e-6
        for e in launch_ev:
            nm = phase_of(e["ts"])
            if nm:
                phases[nm]["launches"] += 1
                k = kernel_of.get(e.get("args", {}).get("correlation"), e["name"])[:100]
                by_kernel[nm][k] = by_kernel[nm].get(k, 0) + 1
        for nm, counts in by_kernel.items():
            phases[nm]["launches_by_kernel"] = dict(
                sorted(counts.items(), key=lambda kv: -kv[1])[:TOP_BY_PHASE])
        for e in device:
            ts = launch_at.get(e.get("args", {}).get("correlation"))
            nm = phase_of(ts) if ts is not None else None
            if nm:
                phases[nm]["device_s"] += e["dur"] * 1e-6
        out["phases"] = phases
    return out


def whitened_plain(m, d):
    """The model's own whitening ``((d - mu) L, sum of its squares)`` by the
    plain versions: K2's for the full and sparse kinds, B1's for the banded
    one, elementwise for the univariate one."""
    from ..kernels.band_matmul import band_matmul_plain
    from ..kernels.whiten import whiten_plain
    from ..ops import mvn

    if m.likelihood.kind == mvn.UNIVARIATE:
        y = (d - m.mu_internal_t) * m.inv_sd_internal_t
        return y, (y * y).sum(-1)
    if m.likelihood.kind == mvn.BANDED:
        return band_matmul_plain(d, m.band_L3_internal_t, sub=m.mu_internal_t, upper=True)
    return whiten_plain(d, m.chol_internal_t, sub=m.mu_internal_t)


def direct_log_posterior(model, state, dtype):
    """``[C]`` log posterior of ``state`` evaluated afresh by the kernels'
    plain versions in ``dtype``, on the state's device."""
    from ..kernels.prior_terms import prior_terms_plain
    from ..ops import mvn
    from ..ops.heights import distances_internal

    m = dataclasses.replace(model, dtype=dtype)
    s = state.to(dtype=dtype)
    lp = prior_terms_plain(m, s).sum(-1)
    if m.likelihood.kind == mvn.NONE:
        return lp
    _, q = whitened_plain(m, distances_internal(s, m.topo))
    return lp + m.log_lik_const - 0.5 * q


def check_carry(runner, batch, tuning, seed: int) -> dict:
    """One sequential sweep with the carry held against direct float32
    evaluations after every segment (a run of tickets, or a ticket alone);
    largest absolute errors over all segments and chains."""
    from ..kernels.prior_terms import prior_terms_plain
    from ..ops.heights import distances_internal

    kern = runner.kern
    m = kern.model
    worst = {k: torch.zeros((), device=runner.device) for k in ("d", "y", "terms")}
    segment = kern.segment

    def checked(carry, *a, **k):
        out = segment(carry, *a, **k)
        d = distances_internal(carry.batch, m.topo)
        y, _ = whitened_plain(m, d)
        terms = prior_terms_plain(m, carry.batch)
        for key, a_, b_ in (("d", carry.d, d), ("y", carry.y, y), ("terms", carry.terms, terms)):
            worst[key] = torch.maximum(worst[key], (a_ - b_).abs().nan_to_num(0.0).max())
        return out

    kern.segment = checked
    try:
        batch, lp_pr, lp_lik, *_ = kern.sweeps(batch, tuning, seed, 1)
    finally:
        kern.segment = segment
    return dict(max_abs_err={k: float(v) for k, v in worst.items()},
                **_lp_check(m, batch, lp_pr + lp_lik))


def _wrapped(kern, names, around):
    """Replace each phase method ``names`` of ``kern`` by ``around(name,
    method)``; returns a function that restores them."""
    saved = {nm: getattr(kern, nm) for nm in names}
    for nm, fn in saved.items():
        setattr(kern, nm, around(nm, fn))

    def restore():
        for nm, fn in saved.items():
            setattr(kern, nm, fn)
    return restore


# FastSweeps methods of the phases, by phase name.
FAST_PHASES = {"seq": "seq_phase", "glob": "glob_phase", "point": "point_phase",
               "range": "range_phase", "y": "_y_from_d", "fiber": "fiber_phase"}


def check_carry_fast(runner, batch, tuning, seed: int) -> dict:
    """One batched sweep with the carry held against direct float32
    evaluations at the end of every phase; largest absolute errors over
    all chains, per phase, each beside the largest direct value
    (``<name>_scale``)."""
    from ..kernels.prior_terms import prior_terms_plain
    from ..ops.heights import distances_internal

    kern = runner.kern
    m = kern.model
    worst: dict = {}

    def around(name, fn):
        def run(*a, **k):
            out = fn(*a, **k)
            if name == "y":
                return out
            carry = a[0]
            d = distances_internal(carry.batch, m.topo)
            got = {"d": (carry.d, d), "terms": (carry.terms, prior_terms_plain(m, carry.batch))}
            if name == "seq":
                got["y"] = (a[1], kern._y_from_d(d))
            elif kern.use_lik:
                z = kern._x_P(d - kern.mu)
                got["z"] = (carry.z, z)
                got["q"] = (carry.q, ((d - kern.mu) * z).sum(-1))
            w = worst.setdefault(name, {})
            for k, (x, y) in got.items():
                w[k] = max(w.get(k, 0.0), float((x - y).abs().nan_to_num(0.0).max()))
                w[k + "_scale"] = max(w.get(k + "_scale", 0.0),
                                      float(y.abs().nan_to_num(0.0).max()))
            return out
        return run

    restore = _wrapped(kern, [v for k, v in FAST_PHASES.items() if k != "y"],
                       lambda nm, fn: around(next(k for k, v in FAST_PHASES.items() if v == nm),
                                             fn))
    try:
        batch, lp_pr, lp_lik, *_ = kern.sweeps(batch, tuning, seed, 1)
    finally:
        restore()
    return dict(max_abs_err=worst, **_lp_check(m, batch, lp_pr + lp_lik))


def _lp_check(m, batch, lp) -> dict:
    lp = lp.double()
    d32 = direct_log_posterior(m, batch, torch.float32).double()
    d64 = direct_log_posterior(m, batch, torch.float64)
    return dict(
        lp_scale=float(d64.abs().max()),
        lp_carried_vs_f32=float((lp - d32).abs().max()),
        lp_f32_vs_f64=float((d32 - d64).abs().max()),
        lp_carried_vs_f64=float((lp - d64).abs().max()),
        birth_minus_death_min_abs=float((batch.birth.double() - batch.death.double())
                                        .abs().min()),
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", choices=("fast", "sequential"), default="fast")
    ap.add_argument("--taxa", type=int, choices=(TAXA, FULL_TAXA, BANDED_TAXA), default=TAXA)
    ap.add_argument("--out", default="profile_sweep.json")
    ap.add_argument("--trace", default=None, help="where to keep the chrome trace")
    ap.add_argument("--fiber-slide", type=float, default=0.0, metavar="P",
                    help="the fiber node-slide phase's probability a sweep (default 0: off)")
    ap.add_argument("--bold-contra", type=float, default=0.0, metavar="P",
                    help="the bold contrary mixture's probability (default 0: off)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sweep needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    from torch.profiler import ProfilerActivity, profile, record_function

    fast = args.sweep == "fast"
    moves = dict(fiber_slide=args.fiber_slide, bold_contra=args.bold_contra)
    rec = dict(card=_card(), sweep=args.sweep, taxa=args.taxa, chains=CHAINS,
               torch=torch.__version__, **moves)
    with tempfile.TemporaryDirectory() as tmp:
        runner, batch, tuning = setup(tmp, fast, args.taxa, moves)
    kern = runner.kern
    rec["kernel"] = type(kern).__name__
    rec["tickets_per_sweep"] = runner.table.n_tickets
    if fast:
        blocks: dict = {}
        for (k, _), steps in kern.range_t.items():
            blocks[str(k)] = blocks.get(str(k), 0) + len(steps)
        rec["range_blocks_by_kind"] = blocks
    t0 = time.perf_counter()
    batch = kern.sweeps(batch, tuning, 100, WARMUP)[0]
    torch.cuda.synchronize()
    rec["warmup_s"] = time.perf_counter() - t0
    times = []
    for i in range(TIMED):
        t0 = time.perf_counter()
        batch = kern.sweeps(batch, tuning, 200 + i, 1)[0]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rec["sweep_s"] = times

    def annotated(nm, fn):
        phase = next(k for k, v in FAST_PHASES.items() if v == nm)

        def run(*a, **k):
            with record_function(phase):
                return fn(*a, **k)
        return run

    restore = _wrapped(kern, list(FAST_PHASES.values()), annotated) if fast else (lambda: None)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("sweep"):
                batch = kern.sweeps(batch, tuning, 300, 1)[0]
                torch.cuda.synchronize()
    finally:
        restore()
    with tempfile.TemporaryDirectory() as tmp:
        trace = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        rec["profiled"] = trace_summary(trace)
    rec["carry"] = (check_carry_fast if fast else check_carry)(runner, batch, tuning, 400)
    with open(args.out, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
