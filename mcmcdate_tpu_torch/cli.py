"""Command-line interface of the PyTorch port: prepare / run / continue /
marginal-likelihood / analyze / simulate.

Port of ``mcmcdate_tpu/cli.py``.  ``run``, ``continue`` and
``marginal-likelihood`` take the JAX CLI's flags except ``--trace-dir``,
plus ``--device`` (default ``cuda``); ``--hamiltonian`` adds the in-cycle
NUTS move, and ``continue`` of a checkpoint saved with it continues with
it.  The optional moves ``--bold-contra``/``--bold-factor`` (the bold
contrary mixture) and ``--fiber-slide`` (the fiber node-slide phase) run in
every FastSweeps sweep, MC3's and the stepping stones' too; ``--fiber-de``
(the fiber differential evolution, at least 4 chains) runs after each
chunk of ``run`` and ``continue`` without ``--mc3``, and elsewhere logs
that it is not applied.  ``run --mc3`` runs MC3
(``engine/mc3.py``: ``--chains`` counts its groups of 4 temperatures), and
``continue`` of a checkpoint whose meta says ``mc3`` resumes as MC3 with
the saved group count (and NUTS where the meta says ``hamiltonian``), as
the JAX CLI does.  With a CUDA device and no card present they fail; they
never carry on on the CPU.
``marginal-likelihood`` runs the stepping-stone sampler
(``engine/stepping_stone.py``) and logs to ``<name>.mlh.log``.
``prepare`` takes ``--device`` too, which only the sparse kind above
``prepare.GLASSO_HOST_MAX`` dims uses (its ADMM runs there).  ``analyze``
post-processes monitor files on the host.  ``simulate`` runs the port's own
NumPy-only fixture generator (``utils/simulate.py``).
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple


def _parse_likelihood_spec(s: str) -> Tuple[str, float]:
    from .ops import mvn

    parts = s.strip().split()
    head = parts[0].lower()
    table = {
        "fullmultivariatenormal": mvn.FULL,
        "full": mvn.FULL,
        "f": mvn.FULL,  # scripts/run single-letter code (scripts/run:134-141)
        "sparsemultivariatenormal": mvn.SPARSE,
        "sparse": mvn.SPARSE,
        "s": mvn.SPARSE,
        # TPU-native block-banded precision (ops/banded.py) — the scaling
        # replacement for the reference's sparse kind; the parameter is
        # the bandwidth (default 128), not a lasso penalty.
        "banded": mvn.BANDED,
        "b": mvn.BANDED,
        "univariatenormal": mvn.UNIVARIATE,
        "univariate": mvn.UNIVARIATE,
        "u": mvn.UNIVARIATE,
        "nolikelihood": mvn.NONE,
        "none": mvn.NONE,
        "n": mvn.NONE,
    }
    if head not in table:
        raise SystemExit(f"Unknown likelihood spec: {s!r}")
    kind = table[head]
    default = 128.0 if kind == mvn.BANDED else 0.1
    rho = float(parts[1]) if len(parts) > 1 else default
    return kind, rho


def _parse_clock(s: str) -> str:
    from .ops import clocks

    table = {m.lower(): m for m in (
        clocks.UNCORRELATED_GAMMA,
        clocks.UNCORRELATED_LOG_NORMAL,
        clocks.UNCORRELATED_WHITE_NOISE,
        clocks.AUTOCORRELATED_GAMMA,
        clocks.AUTOCORRELATED_LOG_NORMAL,
    )}
    # scripts/run two-letter model codes (scripts/run:112-123).
    table.update(
        ug=clocks.UNCORRELATED_GAMMA,
        ul=clocks.UNCORRELATED_LOG_NORMAL,
        uw=clocks.UNCORRELATED_WHITE_NOISE,
        ag=clocks.AUTOCORRELATED_GAMMA,
        al=clocks.AUTOCORRELATED_LOG_NORMAL,
    )
    key = s.strip().lower()
    if key not in table:
        raise SystemExit(
            f"Unknown relaxed molecular clock model: {s!r} "
            f"(choose from {sorted(set(table.values()))})"
        )
    return table[key]


def parse_analysis_conf(path: str) -> dict:
    """Parse the reference's ``analysis.conf`` key="value" files
    (scripts/run:106; e.g. tests/06-leaves-constant-rate/analysis.conf)."""
    out = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            v = v.strip().strip('"').strip("'")
            out[k.strip()] = v
    return out


def _apply_conf(args):
    """Fill unset CLI options from --analysis-conf (CLI flags win)."""
    if not getattr(args, "analysis_conf", None):
        return
    conf = parse_analysis_conf(args.analysis_conf)
    if args.analysis_name is None and "analysis_name" in conf:
        args.analysis_name = conf["analysis_name"]
    if getattr(args, "rooted_tree", None) is None and "rooted_tree" in conf:
        args.rooted_tree = conf["rooted_tree"]
    if getattr(args, "trees", None) is None and "trees" in conf:
        args.trees = conf["trees"]
    if getattr(args, "calibrations", None) is None and "calibrations" in conf:
        kind = "tree" if conf["calibrations"].endswith(".tree") else "csv"
        args.calibrations = f"{kind} {conf['calibrations']}"
    if getattr(args, "constraints", None) is None and conf.get("constraints"):
        args.constraints = conf["constraints"]
    if getattr(args, "braces", None) is None and conf.get("braces"):
        args.braces = conf["braces"]
    # Model keys (extension: the reference passes these as positional codes
    # to scripts/run, e.g. "./run -c ug s r", scripts/run:108-147; conf
    # files may carry them here so a test dir reproduces with no extra
    # flags).  Short codes (ug/ul/uw/al, f/s/u/n) are accepted everywhere.
    if (getattr(args, "likelihood_spec", None) is None
            and conf.get("likelihood_spec")):
        args.likelihood_spec = conf["likelihood_spec"]
    if (getattr(args, "relaxed_molecular_clock", None) is None
            and conf.get("relaxed_molecular_clock")):
        args.relaxed_molecular_clock = conf["relaxed_molecular_clock"]
    # Reference "suffix" key distinguishes results of the same analysis
    # (scripts/analysis.conf sample): append it to the analysis name.
    if conf.get("suffix") and args.analysis_name is not None \
            and not args.analysis_name.endswith("-" + conf["suffix"]):
        args.analysis_name = f"{args.analysis_name}-{conf['suffix']}"
    if args.analysis_name is None:
        raise SystemExit("analysis name missing (flag or analysis.conf)")


def _add_run_args(p: argparse.ArgumentParser):
    p.add_argument("-a", "--analysis-name", metavar="NAME")
    p.add_argument("--analysis-conf", metavar="FILE",
                   help="fill unset options from a reference-style analysis.conf")
    p.add_argument("--preparation-name", metavar="NAME",
                   help="default: value of --analysis-name")
    p.add_argument("--calibrations", metavar='"SPEC FILE"',
                   help='either "csv FILE" or "tree FILE" (mind the quotes)')
    p.add_argument("--ignore-problematic-calibrations", action="store_true")
    p.add_argument("--constraints", metavar="FILE")
    p.add_argument("--ignore-problematic-constraints", action="store_true")
    p.add_argument("--braces", metavar="FILE")
    p.add_argument("--init-from-save", metavar="ANALYSIS_NAME")
    p.add_argument("--profile", action="store_true",
                   help="shrink schedules for profiling")
    p.add_argument("--likelihood-spec", metavar="SPEC",
                   help="full | sparse | univariate | none (reference constructor "
                        "spellings and f/s/u/n codes accepted); default: the "
                        "kind recorded in the .data file")
    p.add_argument("--relaxed-molecular-clock", metavar="MODEL",
                   help="default UncorrelatedGamma; ug/ul/uw/al codes accepted")
    p.add_argument("--seed", type=int, metavar="NUMBER")
    p.add_argument("--chains", type=int, default=4,
                   help="independent chains run as one batch (default 4)")
    p.add_argument("--iterations", type=int,
                   help="override the default iteration count")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"],
                   help="state precision; the CUDA kernels take float32")
    p.add_argument("--device", default="cuda",
                   help="torch device of the chain state (default cuda)")
    p.add_argument("--hamiltonian", action="store_true",
                   help="add the in-cycle NUTS move (once a sweep; continue: implied by a "
                        "checkpoint saved with it)")
    p.add_argument("--mc3", action="store_true",
                   help="use MC3 (parallel tempering) instead of MHG; --chains counts its "
                        "groups of 4 temperatures (continue: implied by an MC3 checkpoint)")
    p.add_argument("--bold-contra", type=float, metavar="P",
                   help="probability that a distance-invariant contrary subtree-scale ticket "
                        "uses a wider kernel (an exact reversible mixture).  Default 0 (off)")
    p.add_argument("--bold-factor", type=float, metavar="F",
                   help="width multiplier of the bold component (default 8)")
    p.add_argument("--fiber-slide", type=float, metavar="P",
                   help="probability per sweep of the fiber node-slide phase: every internal "
                        "node height is redrawn uniformly over its valid interval with the "
                        "touched branch rates rescaled so the likelihood is exactly invariant.  "
                        "Default 0 (off)")
    p.add_argument("--fiber-de", type=float, metavar="N",
                   help="cross-chain fiber differential-evolution rounds per sweep chunk "
                        "(engine/ensemble.py): N >= 1 runs round(N) rounds; 0 < N < 1 gates "
                        "one round by a Bernoulli(N).  Default 0 (off); needs >= 4 chains; "
                        "not applied under --mc3 or marginal-likelihood")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="mcmcdate-tpu-torch",
        description="Bayesian phylogenetic dating on PyTorch and CUDA "
        "(the PyTorch port of mcmcdate_tpu).",
    )
    sub = ap.add_subparsers(dest="mode", required=True)

    p = sub.add_parser("prepare", help="approximate the posterior of branch lengths")
    p.add_argument("-a", "--analysis-name", metavar="NAME")
    p.add_argument("--analysis-conf", metavar="FILE")
    p.add_argument("--rooted-tree", metavar="FILE")
    p.add_argument("--trees", metavar="FILE")
    p.add_argument("--likelihood-spec", metavar="SPEC")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--device", default="cuda",
                   help="torch device of the sparse kind's ADMM, used above "
                        "400 dims only (default cuda)")

    p = sub.add_parser("run", help="run the MCMC sampler")
    _add_run_args(p)

    p = sub.add_parser("continue", help="continue a previous run")
    _add_run_args(p)

    p = sub.add_parser("marginal-likelihood", help="stepping-stone marginal likelihood")
    _add_run_args(p)
    p.add_argument("--no-annealed-init", action="store_true",
                   help="skip the annealed-init cascade (each stone then burns in from "
                        "the naive init in parallel; the reference always anneals)")

    p = sub.add_parser("analyze", help="post-process monitor files "
                       "(scripts/analyze equivalent)")
    p.add_argument("-a", "--analysis-name", required=True, metavar="NAME")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--burn-in", type=float, default=0.25,
                   help="fraction of monitor rows to drop (default 0.25)")
    p.add_argument("--thin", type=int, default=10,
                   help="thinning factor for the params trace (default 10)")
    p.add_argument("--rhat-threshold", type=float, default=1.1,
                   help="node-age R-hat above which per-mode summaries "
                        "are emitted to <an>.ages.modes (default 1.1)")

    p = sub.add_parser("simulate", help="generate a synthetic fixture (extra)")
    p.add_argument("--leaves", type=int, default=6)
    p.add_argument("--trees", type=int, default=600)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rate-var", type=float, default=0.0)
    p.add_argument("--out", default="data")
    return ap


class Tee:
    """Log to stdout and to the per-mode log file (app/Main.hs:545-566)."""

    def __init__(self, path: str):
        self.fh = open(path, "w", buffering=1)

    def __call__(self, *args):
        msg = " ".join(str(a) for a in args)
        print(msg)
        self.fh.write(msg + "\n")

    def close(self):
        self.fh.close()


def _load_model(args, device, dtype, log):
    """getMcmcProps equivalent: load the mean tree, specs and likelihood
    data; assemble the model and the initial state on ``device``."""
    from .io import lhdata
    from .io.specs import (
        load_braces_json,
        load_calibrations_csv,
        load_calibrations_tree,
        load_constraints_csv,
        mean_root_height,
    )
    from .models.dating import DatingModel
    from .models.state import init_state
    from .ops.node_priors import BraceSet, CalibrationSet, ConstraintSet
    from .prepare import data_file, mean_tree_file
    from .tree import FlatTopology, read_one_newick

    prep = args.preparation_name or args.analysis_name
    mean_tree_path = os.path.join(args.out_dir, mean_tree_file(prep))
    log(f"Read mean tree using preparation name: {prep}.")
    tree = read_one_newick(mean_tree_path)
    topo = FlatTopology.from_tree(tree)

    cal = CalibrationSet.empty()
    if args.calibrations:
        parts = args.calibrations.split()
        if len(parts) != 2 or parts[0] not in ("csv", "tree"):
            raise SystemExit(
                f'--calibrations expects "csv FILE" or "tree FILE", got {args.calibrations!r}'
            )
        kind, path = parts
        log(f"Get calibrations using specifications: {kind} {path}.")
        load = load_calibrations_csv if kind == "csv" else load_calibrations_tree
        cal = load(path, tree, topo,
                   ignore_problematic=args.ignore_problematic_calibrations, log=log)
    ht = mean_root_height(cal) or 1.0

    con = ConstraintSet.empty()
    if args.constraints:
        log(f"Get constraints from: {args.constraints}.")
        con = load_constraints_csv(
            args.constraints, tree, topo,
            ignore_problematic=args.ignore_problematic_constraints, log=log,
        )
    br = BraceSet.empty()
    if args.braces:
        log(f"Get braces from: {args.braces}.")
        br = load_braces_json(args.braces, tree, topo, log=log)

    log("Initialize likelihood function.")
    data = lhdata.load_data(os.path.join(args.out_dir, data_file(prep)))
    if args.likelihood_spec is None:
        log(f"Use likelihood specification from data file: {data.kind}.")
    else:
        spec, _ = _parse_likelihood_spec(args.likelihood_spec)
        if data.kind != spec:
            raise SystemExit(
                f"Likelihood specification ({spec}) and data ({data.kind}) do not match."
            )

    clock = _parse_clock(args.relaxed_molecular_clock or "UncorrelatedGamma")
    model = DatingModel(
        topo=topo, likelihood=data, clock=clock, calibrations=cal, constraints=con,
        braces=br, mean_root_height=ht, device=device, dtype=dtype,
    )
    return model, init_state(tree, topo, dtype=dtype, device=device)


def _settings(args):
    from .engine.chains import RunSettings
    from .engine.mh import ITERATIONS, ITERATIONS_PROF, BurnInSettings

    burn = BurnInSettings.profiling() if args.profile else BurnInSettings.default()
    iters = args.iterations or (ITERATIONS_PROF if args.profile else ITERATIONS)
    return RunSettings(
        analysis_name=args.analysis_name,
        burn_in=burn,
        iterations=iters,
        n_chains=args.chains,
        out_dir=args.out_dir,
        seed=args.seed,
        dtype=args.dtype,
        device=args.device,
        bold_contra=args.bold_contra,
        bold_factor=args.bold_factor,
        fiber_slide=args.fiber_slide,
        fiber_de=args.fiber_de,
    )


def _device(name: str):
    """The torch device of ``--device``; a CUDA device with no card fails."""
    from .utils import device as devices

    try:
        return devices.resolve(name)
    except devices.NoCardError:
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(use --device cpu to run on the CPU)") from None


def cmd_prepare(args):
    """Prepare the likelihood data; returns ``prepare``'s result."""
    from .prepare import prepare

    spec, rho = _parse_likelihood_spec(args.likelihood_spec)
    log = Tee(os.path.join(args.out_dir, args.analysis_name + ".prepare.log"))
    try:
        return prepare(args.analysis_name, args.rooted_tree, args.trees, spec,
                       sparse_rho=rho, banded_w=int(rho), out_dir=args.out_dir,
                       device=args.device, log=log)
    finally:
        log.close()


def _device_dtype(args):
    """The device and state type of ``--device`` and ``--dtype``."""
    import torch

    device = _device(args.device)
    dtype = getattr(torch, args.dtype)
    if device.type == "cuda" and dtype != torch.float32:
        raise SystemExit("the CUDA kernels take float32: use --dtype float32 with --device cuda")
    return device, dtype


def cmd_run(args):
    """Run the sampler (MHG, or MC3 with ``--mc3``); returns the chain
    runner."""
    from .engine import checkpoint as ckpt
    from .engine.chains import run_analysis
    from .engine.mc3 import run_mc3

    device, dtype = _device_dtype(args)
    log = Tee(os.path.join(args.out_dir, args.analysis_name + ".run.log"))
    try:
        model, init = _load_model(args, device, dtype, log)
        settings = _settings(args)
        init_from = None
        if args.init_from_save:
            log(f"Loading old state from save: {args.init_from_save}.")
            state0, tuning0, _, meta = ckpt.load(args.init_from_save, in_dir=args.out_dir,
                                                 device=device)
            from .engine.proposals import build_proposal_table

            table = build_proposal_table(model.topo, model.braces,
                                         model.calibrations_available)
            same = meta.get("n_proposals") == table.n_proposals
            log("Using tuning parameters from save." if same
                else "Cycle has changed, start with untuned proposals.")
            init_from = (state0, tuning0 if same else None, same)
        if args.mc3:
            return run_mc3(model, init, settings, hamiltonian=args.hamiltonian, log=log)
        return run_analysis(model, init, settings, init_from=init_from,
                            hamiltonian=args.hamiltonian, log=log)
    finally:
        log.close()


def cmd_continue(args):
    """Continue a saved run (``<name>.mcmc.npz``, written by either
    package): sampling only, monitors appended; an MC3 save continues as
    MC3.  Returns the chain runner.  On a CUDA device the run continues in
    float32 (the kernels' type), on the CPU in the checkpoint's type."""
    import json

    import torch

    from .engine import checkpoint as ckpt
    from .engine.chains import run_analysis
    from .engine.mc3 import N_TEMPS, run_mc3

    device = _device(args.device)
    with open(os.path.join(args.out_dir, ckpt.meta_file(args.analysis_name))) as fh:
        meta = json.load(fh)
    # A run saved with the NUTS move continues with it.
    args.hamiltonian = args.hamiltonian or bool(meta.get("hamiltonian"))
    dtype = torch.float32 if device.type == "cuda" else getattr(torch, meta.get("dtype",
                                                                               "float32"))
    args.dtype = str(dtype).removeprefix("torch.")
    log = Tee(os.path.join(args.out_dir, args.analysis_name + ".continue.log"))
    try:
        model, init = _load_model(args, device, dtype, log)
        settings = _settings(args)
        state, tuning, key, meta = ckpt.load(args.analysis_name, dtype=dtype,
                                             in_dir=args.out_dir, device=device)
        log(f"Continuing from iteration {meta['iteration']}.")
        if meta.get("mc3"):
            # An MC3 analysis continues as MC3 (the reference's mc3Load):
            # the saved batch is groups x temperatures.
            log("Saved chain is an MC3 run; continuing with MC3.")
            settings.n_chains = meta.get("n_groups", state.n_chains // N_TEMPS)
            return run_mc3(model, init, settings, hamiltonian=args.hamiltonian,
                           continue_from=(state, tuning, key, meta["iteration"]), log=log)
        # The saved batch sets the chain count (the trace's columns too).
        settings.n_chains = state.n_chains
        return run_analysis(model, init, settings,
                            continue_from=(state, tuning, key, meta["iteration"]),
                            hamiltonian=args.hamiltonian, log=log)
    finally:
        log.close()


def cmd_marginal_likelihood(args):
    """The stepping-stone marginal likelihood; returns its result."""
    from .engine.stepping_stone import ITERATIONS_ML, run_marginal_likelihood

    device, dtype = _device_dtype(args)
    log = Tee(os.path.join(args.out_dir, args.analysis_name + ".mlh.log"))
    try:
        model, init = _load_model(args, device, dtype, log)
        settings = _settings(args)
        # The reference's default: 4000 iterations a stepping stone.
        if args.iterations is None:
            settings.iterations = 50 if args.profile else ITERATIONS_ML
        return run_marginal_likelihood(model, init, settings, profile=args.profile,
                                       hamiltonian=args.hamiltonian,
                                       annealed_init=not args.no_annealed_init, log=log)
    finally:
        log.close()


def cmd_analyze(args):
    """Post-process one analysis' monitor files: thin the params trace,
    emit ultrametric summary trees + age tables for the time tree,
    per-branch summaries for the rate tree, and Nexus conversions
    (the scripts/analyze workflow, scripts/analyze:32-46)."""
    from . import analyze as A

    an = args.analysis_name
    d = args.out_dir

    def p(name):
        return os.path.join(d, f"{an}.{name}")

    if os.path.exists(p("params.monitor")):
        n = A.thin(p("params.monitor"), p("params.thinned"), args.thin)
        print(f"params trace: kept {n} rows (thin {args.thin})")
    if os.path.exists(p("timetree.monitor")):
        out = A.summarize_trees_ultrametric(
            p("timetree.monitor"), burn_in_fraction=args.burn_in
        )
        print(f"time tree: ultrametric summaries over {out['n']} samples "
              f"-> {an}.timetree.tree.* and {an}.timetree.ages.*")
        A.to_nexus(p("timetree.monitor"), p("timetree.nexus"))
        A.densitree_prep(p("timetree.monitor"), p("timetree.densitree.nex"))
        print("time tree: Nexus + DensiTree prep written")
    if os.path.exists(p("ratetree.monitor")):
        summ = A.summarize_trees(p("ratetree.monitor"),
                                 burn_in_fraction=args.burn_in)
        with open(p("ratetree.tree.mean"), "w") as fh:
            fh.write(summ["mean"] + "\n")
        print(f"rate tree: per-branch mean tree over {summ['n']} samples")
    # Per-mode summaries for monitored node ages whose cross-chain R-hat
    # fails: a blended mean over a multimodal posterior describes neither
    # mode (analyze.mode_report).
    modes = A.mode_report(an, d, rhat_threshold=args.rhat_threshold,
                          burn_in_fraction=args.burn_in)
    if modes:
        print(f"multimodal node ages (R-hat > {args.rhat_threshold:g}): "
              f"{len(modes)} -> {an}.ages.modes")
        for name, rep in modes.items():
            occ = ", ".join(
                f"{m['chains']} chains at {m['mean']:.4g}"
                for m in rep["modes"]
            )
            print(f"  {name} (R-hat {rep['rhat']:.3f}): {occ}")


def cmd_simulate(args):
    from .utils.simulate import simulate, write_fixture

    sim = simulate(n_leaves=args.leaves, n_trees=args.trees, seed=args.seed,
                   rate_var=args.rate_var)
    write_fixture(sim, args.out)
    print(f"Wrote {args.out}/time.tree and {args.out}/trees.nwk "
          f"({args.trees} trees, {args.leaves} leaves).")


def main(argv=None):
    """Parse ``argv`` and run the mode; returns what the mode returns (the
    chain runner for ``run`` and ``continue``, the result for ``prepare``
    and ``marginal-likelihood``)."""
    args = build_parser().parse_args(argv)
    if args.mode in ("prepare", "run", "continue", "marginal-likelihood"):
        _apply_conf(args)
        if args.analysis_name is None:
            raise SystemExit("analysis name missing (flag or analysis.conf)")
        if args.mode == "prepare" and (args.rooted_tree is None or args.trees is None):
            raise SystemExit("prepare requires --rooted-tree and --trees "
                             "(flags or analysis.conf)")
        if args.mode == "prepare" and getattr(args, "likelihood_spec", None) is None:
            raise SystemExit("--likelihood-spec missing "
                             "(flag or analysis.conf likelihood_spec key)")
    if args.mode == "prepare":
        return cmd_prepare(args)
    if args.mode == "run":
        return cmd_run(args)
    if args.mode == "continue":
        return cmd_continue(args)
    if args.mode == "marginal-likelihood":
        return cmd_marginal_likelihood(args)
    if args.mode == "analyze":
        return cmd_analyze(args)
    return cmd_simulate(args)


if __name__ == "__main__":
    main()
