"""Time the glob phase of FastSweeps family by family for one checkout of
the port on a CUDA card, so that two checkouts can be compared in one call.

Run as a file, from the root of a checkout, on a machine with a card:

    python3 mcmcdate_tpu_torch/tools/glob_time.py [--root DIR] [--taxa 136 1000]

It imports ``mcmcdate_tpu_torch`` from ``--root`` (default: the checkout
that holds this file; an unpacked archive of another commit, which need not
have this tool), builds the synthetic full-MVN model and chain batch of each
shape x ``CHAINS`` (``synthetic.build``, seed 0) with the sweep's proposal
table, as ``sweep_time.py`` does, runs ``WARMUP`` sweeps, and then profiles
``REPS`` runs of every glob family as ``FastSweeps.glob_phase`` runs it
(its draws, then G1 or, per ticket, G2, the product ``w = delta @ P`` and
G3), each from a copy of the same carry made beforehand, and ``REPS`` whole
glob phases.  Device time comes from the profiler's kernel intervals, by
kernel: G1 ``glob_scan_kernel``, G2 ``glob_dense_prologue_kernel``, G3
``glob_dense_epilogue_kernel``, the product (cuBLAS's gemm kernels) and the
rest (the phase's draws).  Prints one JSON line per shape with the card's name
and power limit: per family its tickets, its device milliseconds by kernel,
and the product's operations (2 C K D per ticket, K the rows the checkout's
product takes: D, or a subtree ticket's support rows where the checkout has
``FastSweeps.glob_product``); the whole phase's device and host
milliseconds; and the megabytes of the subtrees' gathered precision rows
``P[S]`` (``FastSweeps.glob_prows``, where the checkout has them).  Run each checkout in its own process, in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHAINS, WARMUP, REPS = 1024, 2, 3
KINDS = (("G1", "glob_scan_kernel"), ("G2", "glob_dense_prologue_kernel"),
         ("G3", "glob_dense_epilogue_kernel"), ("product", "gemm"))


def _device_ms(torch, fn, copies, reps):
    """Device milliseconds per call of ``fn(carry)`` by kind (``KINDS``,
    then ``other``), from the profiler's kernel, memcpy and memset
    intervals; each call takes the next of ``copies`` (``reps + 1``)."""
    from torch.profiler import ProfilerActivity, profile

    fn(copies[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(copies[1 + i])
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    out = {k: 0.0 for k, _ in KINDS}
    out["other"] = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        kind = next((k for k, pat in KINDS if pat in e["name"].lower()), "other")
        out[kind] += e["dur"] / 1e3 / reps
    if not any(out.values()):
        raise SystemExit("the profiler recorded no device time")
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--taxa", type=int, nargs="+", default=[136, 1000])
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from mcmcdate_tpu_torch import synthetic
    from mcmcdate_tpu_torch.engine import fast_sweep, proposals
    from mcmcdate_tpu_torch.kernels import glob_step as G
    from mcmcdate_tpu_torch.models.state import FIELDS, State
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    if not torch.cuda.is_available():
        raise SystemExit("glob_time needs a CUDA card")
    if not fast_sweep.__file__.startswith(root):
        raise SystemExit(f"imported {fast_sweep.__file__}, not the checkout at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    out = []
    for taxa in args.taxa:
        model, batch = synthetic.build(taxa, CHAINS, device="cuda")
        table = proposals.build_proposal_table(model.topo, model.braces, False)
        fs = fast_sweep.FastSweeps(model, table)
        tuning = torch.ones((CHAINS, table.n_proposals), device="cuda")
        batch = fs.sweeps(batch, tuning, 1, WARMUP)[0]
        carry = fs.init_carry(batch)
        carry.z, carry.q = fs._zq_from_y(model.whitened_residual_internal(carry.batch))
        D = carry.d.shape[1]
        restricted = hasattr(fs, "glob_product")
        gen = torch.Generator(device="cuda").manual_seed(taxa)

        def copies():
            torch.cuda.synchronize()
            return [fast_sweep.FastCarry(
                State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}),
                carry.terms.clone(), carry.d.clone(), carry.z.clone(), carry.q.clone(),
                carry.acc.clone()) for _ in range(REPS + 1)]

        fams = {}
        for tag, fam in fs.glob_fam.items():
            tun = tuning.index_select(1, fam.rows)
            draws = (standard_gamma(fam.sd / tun, gen) if tag in G.GAMMA_TAGS
                     else torch.rand((CHAINS, fam.n), generator=gen, device="cuda"))
            u = torch.rand((CHAINS, fam.n), generator=gen, device="cuda")
            dense = G.FAMILIES[tag].lik == G.DENSE

            def run(c, fam=fam, tun=tun, draws=draws, u=u, dense=dense):
                if not dense:
                    G.glob_scan(fs.glob, fam, c, tun, draws, u)
                    return
                nbad = None
                for s in range(fam.n):
                    if restricted:
                        pro = G.glob_dense_prologue(fs.glob, fam, s, c, tun, draws, nbad)
                        nbad = pro.nbad
                        w = fs.glob_product(fam, s, pro)
                    else:
                        pro = G.glob_dense_prologue(fs.glob, fam, s, c, tun, draws)
                        w = fs._x_P(pro.delta)
                    G.glob_dense_epilogue(fs.glob, fam, s, c, pro, w, u)

            ms = _device_ms(torch, run, copies(), REPS)
            k = [D] * fam.n
            if dense and restricted and tag in getattr(G, "SUBTREE_DENSE", ()):
                k = [int(h - l) for l, h in zip(fam.grp.lo, fam.grp.hi)]
            fams[tag] = dict(tickets=fam.n, ms=ms,
                             product_gflop=(2 * CHAINS * sum(k) * D / 1e9) if dense else 0.0)
        phase = _device_ms(torch, lambda c: fs.glob_phase(c, tuning, gen), copies(), REPS)
        cs = copies()
        t0 = time.perf_counter()
        for c in cs[1:]:
            fs.glob_phase(c, tuning, gen)
        torch.cuda.synchronize()
        rec = dict(root=root, card=card, taxa=taxa, chains=CHAINS, restricted_product=restricted,
                   families=fams, phase_device_ms=phase,
                   phase_host_ms=(time.perf_counter() - t0) / REPS * 1e3,
                   product_tflop=sum(f["product_gflop"] for f in fams.values()) / 1e3,
                   prows_mb=sum(p.numel() * p.element_size()
                                for p in getattr(fs, "glob_prows", {}).values()) / 1e6)
        print(json.dumps(rec), flush=True)
        out.append(rec)
        del fs, model, batch, carry
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
