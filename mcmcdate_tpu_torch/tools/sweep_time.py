"""Time the ticket-batched sweep (FastSweeps) of one checkout of the port on
a CUDA card, so that two checkouts can be compared in one call.

Run as a file, from the root of a checkout, on a machine with a card:

    python3 mcmcdate_tpu_torch/tools/sweep_time.py [--root DIR] [--variant V]
        [--taxa N ...] [--fiber-slide P] [--bold-contra P]

It imports ``mcmcdate_tpu_torch`` from ``--root`` (default: the checkout
that holds this file; an unpacked archive of another commit compares that
commit, which need not have this tool: ``profile_sweep.py`` times only the
checkout it belongs to, at 136 taxa), builds the synthetic full-MVN model
and chain batch of each shape in ``--taxa`` (default ``TAXA``) x ``CHAINS``
(``synthetic.build``, seed 0; at ``BANDED_TAXA`` its banded model, "banded
128", as ``chip_smoke.py``'s banded full width), constructs ``FastSweeps``
(timed: it gathers each range block's precision rows), runs ``WARMUP``
sweeps, then times ``TIMED`` single sweeps on the host clock, each ending
in a device sync.  ``--variant
none`` drops the likelihood (the point and range epilogues then take the
decisions), ``--variant sequential`` times the sequential sweep
(``MHKernel``) instead, at 136 taxa only.  ``--fiber-slide P`` and
``--bold-contra P`` turn FastSweeps' optional moves on (the fiber
node-slide phase with probability ``P`` a sweep, the bold mixture with
factor 8); with both at 0, the default, FastSweeps is built as a checkout
without them builds it, so the digests compare the two.  Prints one JSON
line per shape with the card's name and power limit, and ``digest``: a
sha256 of the final chain state's bytes (16 hex digits; equal between two
checkouts when their sweeps are bitwise equal).  Run each checkout in
its own process, in turns (A, B, B, A): host speed varies between calls.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TAXA, CHAINS, WARMUP, TIMED = (136, 1000), 1024, 2, 5
BANDED_TAXA = 5000


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--variant", default="full", choices=("full", "none", "sequential"))
    ap.add_argument("--taxa", type=int, nargs="+", default=list(TAXA),
                    choices=(*TAXA, BANDED_TAXA))
    ap.add_argument("--fiber-slide", type=float, default=0.0, metavar="P")
    ap.add_argument("--bold-contra", type=float, default=0.0, metavar="P")
    args = ap.parse_args(argv)
    moves = {k: v for k, v in (("fiber_slide", args.fiber_slide), ("bold_p", args.bold_contra))
             if v}
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from mcmcdate_tpu_torch import synthetic
    from mcmcdate_tpu_torch.engine import fast_sweep, mh, proposals
    from mcmcdate_tpu_torch.ops import mvn

    if not torch.cuda.is_available():
        raise SystemExit("sweep_time needs a CUDA card")
    if not fast_sweep.__file__.startswith(root):
        raise SystemExit(f"imported {fast_sweep.__file__}, not the checkout at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    out = []
    for taxa in args.taxa[:1] if args.variant == "sequential" else args.taxa:
        model, batch = synthetic.build(taxa, CHAINS, device="cuda",
                                       kind="banded" if taxa == BANDED_TAXA else "full")
        if args.variant == "none":
            model = dataclasses.replace(model, likelihood=mvn.LikelihoodData.none())
        table = proposals.build_proposal_table(model.topo, model.braces, False)
        t0 = time.perf_counter()
        if args.variant == "sequential":
            fs = mh.MHKernel(model, table)
        else:
            fs = fast_sweep.FastSweeps(model, table, **moves)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        tuning = torch.ones((CHAINS, table.n_proposals), device="cuda")
        batch = fs.sweeps(batch, tuning, 1, WARMUP)[0]
        torch.cuda.synchronize()
        times = []
        for i in range(TIMED):
            t0 = time.perf_counter()
            batch = fs.sweeps(batch, tuning, 2 + i, 1)[0]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        h = hashlib.sha256()
        for f in ("birth", "death", "height", "heights", "rate_mean", "rate_var", "rates"):
            h.update(getattr(batch, f).cpu().numpy().tobytes())
        rec = dict(root=root, card=card, variant=args.variant, **moves, taxa=taxa,
                   kind=model.likelihood.kind, chains=CHAINS,
                   tickets_per_sweep=int(table.n_tickets), setup_s=setup_s, sweep_s=times,
                   median_s=statistics.median(times), digest=h.hexdigest()[:16])
        print(json.dumps(rec), flush=True)
        out.append(rec)
        del fs, model, batch
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
