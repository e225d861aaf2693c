"""Command-line interface of the PyTorch port: prepare / run / simulate.

Port of ``mcmcdate_tpu/cli.py``.  ``run`` takes the JAX CLI's flags
except ``--mc3``, ``--hamiltonian``, ``--bold-*``, ``--fiber-*`` and
``--trace-dir``, plus ``--device`` (default ``cuda``).  With a CUDA device
and no card present ``run`` fails; it never carries on on the CPU.
``simulate`` runs the port's own NumPy-only fixture generator (``utils/simulate.py``).
``continue``, ``marginal-likelihood`` and ``analyze`` are not ported yet.
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
                   help="full | univariate | none (reference constructor "
                        "spellings and f/u/n codes accepted); default: the "
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

    p = sub.add_parser("run", help="run the MCMC sampler")
    _add_run_args(p)

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
    )


def _device(name: str):
    """The torch device of ``--device``; a CUDA device with no card fails."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(use --device cpu to run on the CPU)")
    return device


def cmd_prepare(args):
    from .prepare import prepare

    spec, _ = _parse_likelihood_spec(args.likelihood_spec)
    log = Tee(os.path.join(args.out_dir, args.analysis_name + ".prepare.log"))
    try:
        prepare(args.analysis_name, args.rooted_tree, args.trees, spec,
                out_dir=args.out_dir, log=log)
    finally:
        log.close()


def cmd_run(args):
    """Run the sampler; returns the chain runner."""
    import torch

    from .engine import checkpoint as ckpt
    from .engine.chains import run_analysis

    device = _device(args.device)
    dtype = getattr(torch, args.dtype)
    if device.type == "cuda" and dtype != torch.float32:
        raise SystemExit("the CUDA kernels take float32: use --dtype float32 with --device cuda")
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
        return run_analysis(model, init, settings, init_from=init_from, log=log)
    finally:
        log.close()


def cmd_simulate(args):
    from .utils.simulate import simulate, write_fixture

    sim = simulate(n_leaves=args.leaves, n_trees=args.trees, seed=args.seed,
                   rate_var=args.rate_var)
    write_fixture(sim, args.out)
    print(f"Wrote {args.out}/time.tree and {args.out}/trees.nwk "
          f"({args.trees} trees, {args.leaves} leaves).")


def main(argv=None):
    """Parse ``argv`` and run the mode; returns what the mode returns (the
    chain runner for ``run``)."""
    args = build_parser().parse_args(argv)
    if args.mode in ("prepare", "run"):
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
    return cmd_simulate(args)


if __name__ == "__main__":
    main()
