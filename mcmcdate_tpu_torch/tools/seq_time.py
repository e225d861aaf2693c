"""Time the sequential sweep (MHKernel) of one checkout of the port on a
CUDA card, so that two checkouts can be compared in one call.

Run as a file, from the root of a checkout, on a machine with a card:

    python3 mcmcdate_tpu_torch/tools/seq_time.py [--root DIR] [--taxa 136|1000|10000]
        [--prefix N] [--sweeps K] [--chunk] [--heavy H [H ...]]

It imports ``mcmcdate_tpu_torch`` from ``--root`` (default: the checkout
that holds this file; an unpacked archive of another commit times that
commit, which need not have this tool) and builds, at 136 or 1000 taxa,
the synthetic full-MVN model (``synthetic.build``, seed 0) or, at 10,000
taxa, the univariate model of :func:`univariate_model` (seed 0), with
``CHAINS`` chains through ``ChainRunner.init_chains`` (jittered rates,
untuned proposals).  Then:

- ``--prefix N``: the first N tickets of a drawn ticket order, one
  ``MHKernel.ticket_step`` call each (their draws made beforehand), timed
  on the host clock up to a device sync: seconds per ticket and that times
  the tickets of a sweep, an extrapolation, not a sweep;
- ``--sweeps K``: one warm-up sweep, then K sweeps (``MHKernel.sweeps``),
  each timed on the host clock up to a device sync;
- ``--chunk`` (the ticket kernels' checkouts only): the first chunk of a
  drawn ticket order (``ticket_step.CHUNK`` tickets) through T3, timed with
  CUDA events after one untimed pass of each: cut as the sweep cuts it
  (``TicketTable.segments``), as one run, and its light and its heavy
  tickets (``ticket_step.HEAVY``) each as one run, with the time per light
  ticket (us) and per heavy ticket (ms); ``--heavy H ...`` also times the
  chunk as the sweep cuts it with ``HEAVY`` set to each ``H`` (the cut
  between T3's warp-per-chain runs and its CTA-per-chain heavy tickets);
  ``--bins`` times the chunk's light tickets by work (``BINS``), each bin
  as one run through either kernel (us a ticket).

- ``--latency``: the latency of one dependent global load (ns), from a
  single thread chasing a random cyclic permutation (``csrc/probe.cu``) of
  4 MB (L2) and of 1 GB (device memory), for the ticket kernels' latency
  floors.

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHAINS = 1024


def univariate_model(n_taxa: int, seed: int = 0, device="cuda"):
    """``(model, init)``: a random ultrametric tree of ``n_taxa`` leaves
    (``FlatTopology.from_tree``) under a univariate likelihood with means
    U(0.05, 0.5) and variances U(1e-4, 1e-2) from ``seed``, as the JAX
    package's ``tests/test_univariate_10k.py`` builds it; ``init`` the
    tree's one-chain state."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch.models.dating import DatingModel
    from mcmcdate_tpu_torch.models.state import init_state
    from mcmcdate_tpu_torch.ops import mvn
    from mcmcdate_tpu_torch.tree.flat import FlatTopology
    from mcmcdate_tpu_torch.utils.simulate import random_ultrametric_tree

    rng = np.random.default_rng(seed)
    tree = random_ultrametric_tree(rng, n_taxa)
    topo = FlatTopology.from_tree(tree)
    k = topo.n - 2
    data = mvn.LikelihoodData.univariate(rng.uniform(0.05, 0.5, size=k),
                                         rng.uniform(1e-4, 1e-2, size=k))
    model = DatingModel(topo=topo, likelihood=data, device=device, dtype=torch.float32)
    return model, init_state(tree, topo, 1, dtype=torch.float32, device=device)


BINS = (0, 8, 32, 128, 512)


def time_chunk(kern, batch, tuning, cuts=(), bins=False) -> dict:
    """T3 on the first chunk of a drawn order: as the sweep cuts it, as one
    run, and its light and heavy tickets each as one run (ms, launches,
    tickets; us a light ticket, ms a heavy one); then as the sweep cuts it
    with ``HEAVY`` at each of ``cuts``."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch.kernels import ticket_step as TS
    from mcmcdate_tpu_torch.kernels.ticket_step import CHUNK, HEAVY, ticket_scan

    tt, table = kern.tt, kern.table
    gen = torch.Generator(device="cuda").manual_seed(2)
    order = np.asarray(table.tickets)[np.random.default_rng(2).permutation(table.n_tickets)]
    order = order[:CHUNK].astype(np.int32)
    heavy = tt.work[order] > HEAVY
    carry = kern.init_carry(batch)
    out = {}
    runs = [("as_the_sweep", order, True, HEAVY), ("one_run", order, False, HEAVY),
            ("light_only", order[~heavy], False, HEAVY), ("heavy_only", order[heavy], False, HEAVY)]
    runs += [(f"as_the_sweep_heavy_{h}", order, True, h) for h in cuts]
    for name, o, cut, cut_at in runs:
        TS.HEAVY = cut_at
        dr = kern.draws(o, tuning, gen)
        segs = tt.segments(o) if cut else [(0, len(o), True)]
        if not all(run for _, _, run in segs):
            raise SystemExit("--chunk takes a model whose tickets all run in T3 (no full MVN)")
        times = []
        for _ in range(2):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for j0, nj, _ in segs:
                ticket_scan(tt, carry, tuning, dr, j0, nj)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = dict(tickets=len(o), launches=len(segs), ms=times[1],
                         heavy_tickets=int((tt.work[o] > cut_at).sum()))
    light = order[tt.work[order] <= HEAVY]
    groups = [(dict(work=[lo, hi]), light[(tt.work[light] > lo) & (tt.work[light] <= hi)])
              for lo, hi in zip(BINS, BINS[1:] + (HEAVY,))]
    groups += [(dict(kind=int(k)), light[table.kind[light] == k])
               for k in np.unique(table.kind[light])]
    for rec, o in groups if bins else ():
        if not len(o):
            continue
        dr = kern.draws(o, tuning, gen)
        rec.update(tickets=len(o), mean_work=float(tt.work[o].mean()))
        for name, cut_at in (("us_warp", HEAVY), ("us_cta", -1)):
            TS.HEAVY = cut_at
            times = []
            for _ in range(2):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                ticket_scan(tt, carry, tuning, dr, 0, len(o))
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            rec[name] = times[1] / len(o) * 1e3
        out.setdefault("bins", []).append(rec)
    TS.HEAVY = HEAVY
    out["us_per_light_ticket"] = out["light_only"]["ms"] / max(1, len(order[~heavy])) * 1e3
    out["ms_per_heavy_ticket"] = out["heavy_only"]["ms"] / max(1, len(order[heavy]))
    return out


def load_latency() -> dict:
    """ns per dependent load, links in L2 (4 MB) and in device memory (1 GB):
    a cyclic permutation with every link on a 128-byte line of its own."""
    import ctypes

    import torch

    from mcmcdate_tpu_torch.kernels import build

    fn = build.bind("mcmcdate_chase", (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p))
    out, res, steps = torch.zeros(1, dtype=torch.int32, device="cuda"), {}, 100_000
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, nbytes in (("l2", 4 << 20), ("hbm", 1 << 30)):
        lines = nbytes // 128
        perm = torch.randperm(lines, generator=gen, device="cuda", dtype=torch.int64) * 32
        nxt = torch.zeros(lines * 32, dtype=torch.int32, device="cuda")
        nxt[perm] = torch.roll(perm, -1).to(torch.int32)
        times = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            build.check(fn(nxt.data_ptr(), steps, out.data_ptr(), build.stream_ptr("cuda")),
                        "chase kernel")
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / steps * 1e6)
        # L2: the warm passes; device memory: the first (its 100,000 links,
        # 12.8 MB of lines, stay in L2 for the next ones).
        res[f"{name}_ns"] = min(times) if name == "l2" else times[0]
        del perm, nxt
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--taxa", type=int, choices=(136, 1000, 10000), default=10000)
    ap.add_argument("--prefix", type=int, default=0)
    ap.add_argument("--sweeps", type=int, default=0)
    ap.add_argument("--chunk", action="store_true")
    ap.add_argument("--heavy", type=int, nargs="*", default=())
    ap.add_argument("--bins", action="store_true")
    ap.add_argument("--latency", action="store_true")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from mcmcdate_tpu_torch import synthetic
    from mcmcdate_tpu_torch.engine import mh, proposals
    from mcmcdate_tpu_torch.engine.chains import ChainRunner, RunSettings
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    if not torch.cuda.is_available():
        raise SystemExit("seq_time needs a CUDA card")
    if not mh.__file__.startswith(root):
        raise SystemExit(f"imported {mh.__file__}, not the checkout at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    if args.taxa == 10000:
        model, init = univariate_model(args.taxa)
    else:
        model, init = synthetic.build(args.taxa, 1, device="cuda")
    table = proposals.build_proposal_table(model.topo, model.braces, False)
    runner = ChainRunner(model, table, RunSettings("seq_time", n_chains=CHAINS, seed=1,
                                                   device="cuda", fast_sweep=False),
                         log=lambda *a: None)
    kern = runner.kern
    if not isinstance(kern, mh.MHKernel):
        raise SystemExit(f"the runner took {type(kern).__name__}, not the sequential sweep")
    batch, tuning = runner.init_chains(init)
    torch.cuda.synchronize()
    rec = dict(root=root, card=card, taxa=args.taxa, chains=CHAINS,
               likelihood=model.likelihood.kind, tickets_per_sweep=int(table.n_tickets),
               setup_s=time.perf_counter() - t0)
    if args.prefix:
        gen = torch.Generator(device="cuda").manual_seed(1)
        order = np.asarray(table.tickets)[np.random.default_rng(1).permutation(table.n_tickets)]
        order = order[:args.prefix]
        gamma = set(proposals.GAMMA_KINDS)
        draws = [standard_gamma(float(table.par[p]) / tuning[:, p], gen)
                 if int(table.kind[p]) in gamma else torch.rand(CHAINS, generator=gen,
                                                                device="cuda") for p in order]
        u_acc = torch.rand((len(order), CHAINS), generator=gen, device="cuda")
        carry = kern.init_carry(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j, p in enumerate(order):
            kern.ticket_step(carry, tuning, int(p), draws[j], u_acc[j])
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        rec.update(prefix_tickets=len(order), prefix_s=s, s_per_ticket=s / len(order),
                   extrapolated_s_per_sweep=s / len(order) * int(table.n_tickets))
    if args.latency:
        rec["load_latency"] = load_latency()
    if args.chunk:
        rec["chunk"] = time_chunk(kern, batch, tuning, args.heavy, args.bins)
    if args.sweeps:
        batch = kern.sweeps(batch, tuning, 1, 1)[0]
        torch.cuda.synchronize()
        times = []
        for i in range(args.sweeps):
            t0 = time.perf_counter()
            batch = kern.sweeps(batch, tuning, 2 + i, 1)[0]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rec.update(sweep_s=times, median_s=statistics.median(times))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
