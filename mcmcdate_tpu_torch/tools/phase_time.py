"""Time one phase of FastSweeps kernel by kernel for one checkout of the
port on a CUDA card, so that two checkouts can be compared in one call.

Run as a file, from the root of a checkout, on a machine with a card:

    python3 mcmcdate_tpu_torch/tools/phase_time.py --phase glob|range|kernels [--root DIR]
        [--taxa 136 1000]

It imports ``mcmcdate_tpu_torch`` from ``--root`` (default: the checkout
that holds this file; an unpacked archive of another commit, which need not
have this tool), builds the synthetic full-MVN model and chain batch of each
shape x ``CHAINS`` (``synthetic.build``, seed 0) with the sweep's proposal
table, as ``sweep_time.py`` does, and runs ``WARMUP`` sweeps.  Device time
comes from the profiler's kernel, memcpy and memset intervals, by kernel.
Prints one JSON line per shape with the card's name and power limit.  Run
each checkout in its own process, in turns (A, B, B, A).

``--phase glob`` profiles ``REPS["glob"]`` runs of every glob family as
``FastSweeps.glob_phase`` runs it (its draws, then G1 or, per ticket, G2,
the product ``w = delta @ P`` and G3), each from a copy of the same carry
made beforehand, and as many whole glob phases.  Kinds: G1
``glob_scan_kernel``, G2 ``glob_dense_prologue_kernel``, G3
``glob_dense_epilogue_kernel``, the product (cuBLAS's gemm kernels) and the
rest (the phase's draws).  Per family its tickets, its device milliseconds
by kind, and the product's operations (2 C K D per ticket, K the rows the
checkout's product takes: D, or a subtree ticket's support rows where the
checkout has ``FastSweeps.glob_product``); the whole phase's device and
host milliseconds; and the megabytes of the subtrees' gathered precision
rows ``P[S]`` (``FastSweeps.glob_prows``, where the checkout has them).

``--phase range`` takes the first block of every likelihood range bucket
of both kinds: it draws the block's proposals and accept uniforms once,
runs K5's prologue, ``range_scan`` and epilogue once through the kernel
wrappers (with the positional arguments that every version of them takes),
and profiles ``REPS["range"]`` calls of the prologue and of the epilogue on
those inputs (``range_lik_prologue_kernel``,
``range_lik_epilogue_kernel``).  Per block its kind, bucket, tickets S, row
slots S RB, real rows R and accepted (chain, ticket) pairs, and the two
kernels' device milliseconds per call (the epilogue also with every ticket
rejected, which writes no row back).

``--phase kernels`` times, per call, K6 ``contra_slide`` on the first
contrary slide step and ``contra_range`` on the first block of each
contrary row bucket (without the bold mixture: every version's call), G3
``glob_dense_epilogue`` on the first ticket of sub_ultra and of var_tree
(after G2 and the product, with the wrappers' positional arguments that
every version since the subtree product takes),
and K4's ``point_lik_prologue`` and ``point_lik_epilogue`` on the first
step of the node slides and of the branch-rate scales (the epilogue on
the decisions and dq of one prologue and ``point_scan``, with the
positional arguments that every version of the two wrappers takes), K1
``prior_terms`` (``prior_terms(model, state)``) and K3 ``accept_select`` on
the pulley and on the first subtree scale of a range class, after T1 and
K2 (``accept_select(tt, carry, tuning, dr, j, pro, dy, d_lik)``, on an
``MHKernel`` of the same model and table), each call on its own copy of the
state it writes.  K1 also runs on the univariate model of ``UNI_TAXA``
taxa x ``CHAINS`` (``seq_time.univariate_model``, after the other shapes),
and its record holds, per relaxed clock, a hash of its terms on a state
made on the host from ``K1_SEED`` with node priors (``bits``: equal hashes
of two checkouts mean bitwise equal terms).  ``flush_ms``: before
each of ``REPS["kernels"]`` calls, a read of ``FLUSH_BYTES`` (several
times the H100's 50 MB L2) evicts the call's inputs, as a sweep's other
work does, so a call cannot read below its bytes bound; ``warm_ms``: the
same calls back to back, without it.  Per kernel also the accepted
(chain, ticket) pairs of one call (K4: of its step), and K4's tickets B
and distance rows per ticket KD.
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
CHAINS, WARMUP = 1024, 2
REPS = {"glob": 3, "range": 20, "kernels": 20}
FLUSH_BYTES = 256 << 20
UNI_TAXA, K1_SEED = 10_000, 3
GLOB_KINDS = (("G1", "glob_scan_kernel"), ("G2", "glob_dense_prologue_kernel"),
              ("G3", "glob_dense_epilogue_kernel"), ("product", "gemm"))


def _device_ms(torch, fn, reps, kinds):
    """Device milliseconds per call of ``fn(i)``, ``i`` = 1 ... ``reps``
    after an untimed ``fn(0)``, by kind: each kernel, memcpy or memset
    interval goes to the first of ``kinds`` (``(kind, pattern)`` pairs) whose
    pattern its lower-cased name holds, else to ``other``.  A profile that
    recorded none of ``kinds`` (the profiler's device trace can come back
    empty) is taken again, up to twice, calling ``fn(1)`` ... again."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(1 + i)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        out = {k: 0.0 for k, _ in kinds}
        out["other"] = 0.0
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
                continue
            kind = next((k for k, pat in kinds if pat in e["name"].lower()), "other")
            out[kind] += e["dur"] / 1e3 / reps
        if any(out[k] for k, _ in kinds):
            return out
    raise SystemExit(f"the profiler recorded none of {[p for _, p in kinds]} three times")


def glob_phase(torch, fs, carry, tuning, gen) -> dict:
    """The glob phase of ``fs`` by family and kind, from copies of
    ``carry``."""
    from mcmcdate_tpu_torch.engine import fast_sweep
    from mcmcdate_tpu_torch.kernels import glob_step as G
    from mcmcdate_tpu_torch.models.state import FIELDS, State
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    reps = REPS["glob"]
    D = carry.d.shape[1]
    restricted = hasattr(fs, "glob_product")

    def copies():
        torch.cuda.synchronize()
        return [fast_sweep.FastCarry(
            State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}),
            carry.terms.clone(), carry.d.clone(), carry.z.clone(), carry.q.clone(),
            carry.acc.clone()) for _ in range(reps + 1)]

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

        cs = copies()
        ms = _device_ms(torch, lambda i: run(cs[i]), reps, GLOB_KINDS)
        k = [D] * fam.n
        if dense and restricted and tag in getattr(G, "SUBTREE_DENSE", ()):
            k = [int(h - l) for l, h in zip(fam.grp.lo, fam.grp.hi)]
        fams[tag] = dict(tickets=fam.n, ms=ms,
                         product_gflop=(2 * CHAINS * sum(k) * D / 1e9) if dense else 0.0)
    cs = copies()
    phase = _device_ms(torch, lambda i: fs.glob_phase(cs[i], tuning, gen), reps, GLOB_KINDS)
    cs = copies()
    t0 = time.perf_counter()
    for c in cs[1:]:
        fs.glob_phase(c, tuning, gen)
    torch.cuda.synchronize()
    return dict(restricted_product=restricted, families=fams, phase_device_ms=phase,
                phase_host_ms=(time.perf_counter() - t0) / reps * 1e3,
                product_tflop=sum(f["product_gflop"] for f in fams.values()) / 1e3,
                prows_mb=sum(p.numel() * p.element_size()
                             for p in getattr(fs, "glob_prows", {}).values()) / 1e6)


def range_phase(torch, fs, carry, tuning, gen) -> dict:
    """K5's prologue and epilogue on the first block of every likelihood
    range bucket of ``fs``, each from a copy of ``carry``."""
    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.kernels import range_step as K
    from mcmcdate_tpu_torch.kernels.range_scan import range_scan
    from mcmcdate_tpu_torch.models.state import FIELDS, State
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    reps = REPS["range"]
    leaf = fs.model.topo.is_leaf_t
    pk, ek = (("k", "range_lik_prologue_kernel"),), (("k", "range_lik_epilogue_kernel"),)
    blocks = []
    for (kind, rb), steps in fs.range_t.items():
        if kind == P.K_SCALE_SUBTREES_CONTRA:
            continue
        sx = steps[0]
        rate = kind == P.K_SCALE_SUBTREE_RATE
        S, RB = sx["own"].shape
        draw = (standard_gamma(sx["sd"] / tuning[:, sx["rows"]], gen) if rate
                else torch.rand((CHAINS, S), generator=gen, device="cuda"))
        u = torch.rand((CHAINS, S), generator=gen, device="cuda")
        state = State(**{f: getattr(carry.batch, f).clone() for f in FIELDS})
        terms, d, z, q, acc = (carry.terms.clone(), carry.d.clone(), carry.z.clone(),
                               carry.q.clone(), carry.acc.clone())
        pargs = (rate, state, terms, d, z, tuning, sx, leaf, fs.model.clock, draw)
        pro = K.range_lik_prologue(*pargs)
        accept, dq = range_scan(pro.g, pro.zg, sx["Q"], pro.coef, pro.d_pr, pro.lmhg, u)
        eargs = (rate, state, terms, d, q, acc, sx, pro, accept, dq)
        none = (*eargs[:8], torch.zeros_like(accept), dq)
        blocks.append(dict(
            kind=kind, bucket=rb, S=S, slots=S * RB, R=int((sx["own"] >= 0).sum()),
            accepted=int(accept.sum()),
            prologue_ms=_device_ms(torch, lambda i: K.range_lik_prologue(*pargs), reps, pk)["k"],
            epilogue_ms=_device_ms(torch, lambda i: K.range_lik_epilogue(*eargs), reps, ek)["k"],
            epilogue_reject_ms=_device_ms(torch, lambda i: K.range_lik_epilogue(*none), reps,
                                          ek)["k"]))
    return dict(reps=reps, blocks=blocks)


def _flush_timer(torch):
    """``timed(call, pattern, copies)``: device ms per call of ``call(x)``,
    ``x`` from ``copies()`` (one per call), with (``flush_ms``) and without
    (``warm_ms``) a read of ``FLUSH_BYTES`` before each."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    flush.fill_(1.0)
    reps = REPS["kernels"]

    def timed(call, pattern, copies):
        out = {}
        for name, flushed in (("flush_ms", True), ("warm_ms", False)):
            cs = copies()

            def fn(i, cs=cs, flushed=flushed):
                if flushed:
                    flush.sum()
                call(cs[i])

            out[name] = _device_ms(torch, fn, reps, (("k", pattern),))["k"]
        return out

    return timed


def _k1_state(torch, model, batch):
    """A state near ``batch`` made on the host from ``K1_SEED``: varied
    scalars and rates per chain, a near-critical chain in seven, a gamma
    shape above 100 in five."""
    import numpy as np

    rng = np.random.default_rng(K1_SEED)
    C, N = batch.heights.shape
    h = batch.heights.cpu().double().numpy() * rng.uniform(0.97, 1.0, (C, 1))
    h[:, 0] = 1.0
    h[:, np.asarray(model.topo.is_leaf, bool)] = 0.0
    birth = rng.uniform(0.2, 3.0, C)
    death = rng.uniform(0.0, 3.0, C)
    death[::7] = birth[::7] + 2e-7
    rate_var = rng.uniform(0.02, 1.5, C)
    rate_var[::5] = 1e-3

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=batch.heights.device)

    return batch.replace(heights=t(h), rates=t(rng.gamma(5.0, 0.2, (C, N))), birth=t(birth),
                         death=t(death), height=t(rng.uniform(0.5, 3.0, C)),
                         rate_mean=t(rng.uniform(0.5, 2.0, C)), rate_var=t(rate_var))


def _node_priors(topo):
    """Two calibrations, a constraint and a brace on inner nodes."""
    import numpy as np

    from mcmcdate_tpu_torch.ops.node_priors import BraceSet, CalibrationSet, ConstraintSet

    inner = [int(i) for i in topo.inner_nodes if i != 0]
    return dict(
        calibrations=CalibrationSet(node=np.asarray([0, inner[0]], np.int32),
                                    lower=np.asarray([1.0, 0.4]),
                                    lower_pm=np.asarray([0.01, 0.02]),
                                    upper=np.asarray([2.0, np.inf]),
                                    upper_pm=np.asarray([0.01, 1.0])),
        constraints=ConstraintSet(young=np.asarray([inner[-1]], np.int32),
                                  old=np.asarray([inner[-2]], np.int32), pm=np.asarray([0.01])),
        braces=BraceSet(node=np.asarray([[inner[2], inner[-3], -1]], np.int32),
                        sd=np.asarray([0.02])))


def k1_bits(model, state) -> dict:
    """Per relaxed clock, the sha256 (16 hex digits) of ``prior_terms`` of
    ``state`` under ``model`` with node priors."""
    import dataclasses
    import hashlib

    from mcmcdate_tpu_torch.kernels.prior_terms import prior_terms
    from mcmcdate_tpu_torch.ops import clocks

    bits = {}
    for clock in clocks.MODELS:
        m = dataclasses.replace(model, clock=clock, **_node_priors(model.topo))
        terms = prior_terms(m, state)
        bits[clock] = hashlib.sha256(terms.cpu().numpy().tobytes()).hexdigest()[:16]
    return bits


def k1_record(torch, model, batch) -> dict:
    """K1 on ``model``: flushed and warm ms a call on a ``_k1_state``, and
    its ``k1_bits``."""
    from mcmcdate_tpu_torch.kernels.prior_terms import prior_terms

    state = _k1_state(torch, model, batch)
    timed = _flush_timer(torch)
    return dict(T=int(sum(model.term_block_sizes)), bits=k1_bits(model, state),
                **timed(lambda s: prior_terms(model, s), "prior_terms_kernel",
                        lambda: [state] * (REPS["kernels"] + 1)))


def k3_rows(tt) -> dict:
    """The rows K3 is timed on: the pulley and the first subtree scale of a
    range class (both end in T1, K2 and K3 under a full MVN)."""
    import numpy as np

    from mcmcdate_tpu_torch.engine import proposals as P

    kind = np.asarray(tt.table.kind)
    return {"pulley": int(np.nonzero(kind == P.K_PULLEY_ULTRA)[0][0]),
            "range": next(q for q in range(len(kind)) if kind[q] == P.K_SCALE_SUBTREE_ULTRA
                          and int(tt.d_class[q]) not in (P.DC_INV, P.DC_FULL, P.DC_GATHER))}


def k3_records(torch, fs, carry, tuning, gen) -> dict:
    """K3 on the pulley and on the first subtree scale of a range class,
    after T1 and K2, each call on a copy of the carry T1 left."""
    from mcmcdate_tpu_torch.engine import mh as M
    from mcmcdate_tpu_torch.engine.mh import Carry
    from mcmcdate_tpu_torch.kernels.accept_select import accept_select
    from mcmcdate_tpu_torch.kernels.ticket_step import TicketDraws, ticket_prologue
    from mcmcdate_tpu_torch.models.state import FIELDS, State
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    tk = M.MHKernel(fs.model, fs.table)
    tt = tk.tt
    timed = _flush_timer(torch)
    out = {}
    for tag, p in k3_rows(tt).items():
        base = tk.init_carry(carry.batch)
        draw = (standard_gamma(float(fs.table.par[p]) / tuning[:, p], gen) if tt.gamma[p]
                else torch.rand(CHAINS, generator=gen, device="cuda"))
        dr = TicketDraws.single(p, draw, torch.rand(CHAINS, generator=gen, device="cuda"))
        pro = ticket_prologue(tt, base, tuning, dr, 0)
        dy, d_lik = tk._k2(base, p, pro)

        def copies(base=base):
            torch.cuda.synchronize()
            return [Carry(State(**{f: getattr(base.batch, f).clone() for f in FIELDS}),
                          base.terms.clone(), base.d.clone(), base.y.clone(), base.acc.clone(),
                          base.nbad.clone()) for _ in range(REPS["kernels"] + 1)]

        def call(c, dr=dr, pro=pro, dy=dy, d_lik=d_lik):
            return accept_select(tt, c, tuning, dr, 0, pro, dy, d_lik)

        out[f"accept_select {tag}"] = dict(
            row=p, d_class=int(tt.d_class[p]), rows=(tt.D if tt.rows(p) is None
                                                       else int(tt.rows(p).numel())),
            accepted=int(call(copies()[0]).sum()), **timed(call, "accept_select_kernel", copies))
    return out


def kernels_phase(torch, fs, carry, tuning, gen) -> dict:
    """K6 ``contra_slide``'s first step, G3 on sub_ultra's and var_tree's
    first tickets, K4's prologue and epilogue on the first step of both
    point kinds, K1 and K3, per call, with and without an L2 flush before
    each."""
    from mcmcdate_tpu_torch.engine import fast_sweep, proposals as P
    from mcmcdate_tpu_torch.kernels import contra_step as K, glob_step as G, point_step as K4
    from mcmcdate_tpu_torch.kernels.point_scan import point_scan
    from mcmcdate_tpu_torch.models.state import FIELDS, State
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    reps = REPS["kernels"]
    timer = _flush_timer(torch)

    def copies():
        torch.cuda.synchronize()
        return [fast_sweep.FastCarry(
            State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}),
            carry.terms.clone(), carry.d.clone(), carry.z.clone(), carry.q.clone(),
            carry.acc.clone()) for _ in range(reps + 1)]

    def timed(call, pattern):
        return timer(call, pattern, copies)

    out = {}
    sx = fs.spec_t[P.K_SLIDE_NODES_CONTRA][0]
    B = sx["rows"].shape[0]
    u_prop = torch.rand((CHAINS, B), generator=gen, device="cuda")
    u_acc = torch.rand((CHAINS, B), generator=gen, device="cuda")
    leaf = fs.model.topo.is_leaf_t

    def slide(c):
        return K.contra_slide(c.batch, c.terms, c.acc, tuning, sx, leaf, fs.model.clock, u_prop,
                              u_acc)

    out["contra_slide"] = dict(tickets=B, accepted=int(slide(copies()[0]).accept.sum()),
                               **timed(slide, "contra_slide_kernel"))
    for (k, rb), blocks in fs.range_t.items():
        if k != P.K_SCALE_SUBTREES_CONTRA:
            continue
        sx_r = blocks[0]
        S = sx_r["rows"].shape[0]
        ur = [torch.rand((CHAINS, S), generator=gen, device="cuda") for _ in range(2)]

        def scale(c, sx_r=sx_r, ur=ur):
            return K.contra_range(c.batch, c.terms, c.acc, tuning, sx_r, leaf, fs.model.clock,
                                  *ur)

        out[f"contra_range {rb}"] = dict(tickets=S, accepted=int(scale(copies()[0]).accept.sum()),
                                         **timed(scale, "contra_range_kernel"))
    for tag in ("sub_ultra", "var_tree"):
        fam = fs.glob_fam[tag]
        tun = tuning.index_select(1, fam.rows)
        draws = (standard_gamma(fam.sd / tun, gen) if tag in G.GAMMA_TAGS
                 else torch.rand((CHAINS, fam.n), generator=gen, device="cuda"))
        u = torch.rand((CHAINS, fam.n), generator=gen, device="cuda")
        pro = G.glob_dense_prologue(fs.glob, fam, 0, copies()[0], tun, draws)
        w = fs.glob_product(fam, 0, pro)

        def epilogue(c, fam=fam, pro=pro, w=w, u=u):
            return G.glob_dense_epilogue(fs.glob, fam, 0, c, pro, w, u)

        rows = int(fam.grp.hi[0] - fam.grp.lo[0]) if tag in G.SUBTREE_DENSE else carry.d.shape[1]
        out[f"glob_dense_epilogue {tag}"] = dict(
            rows=rows, accepted=int(epilogue(copies()[0]).sum()),
            **timed(epilogue, "glob_dense_epilogue_kernel"))
    for kind in (P.K_SLIDE_NODE_ULTRA, P.K_SCALE_BRANCH_RATE):
        branch = kind == P.K_SCALE_BRANCH_RATE
        sx = fs.spec_t[kind][0]
        B, KD = sx["rows"].shape[0], sx["d_rows"].shape[1]
        draw = (standard_gamma(sx["sd"] / tuning[:, sx["rows"]], gen) if branch
                else torch.rand((CHAINS, B), generator=gen, device="cuda"))
        u = torch.rand((CHAINS, B), generator=gen, device="cuda")

        def prologue(c, sx=sx, branch=branch, draw=draw):
            return K4.point_lik_prologue(branch, c.batch, c.terms, c.d, c.z, tuning, sx, leaf,
                                         fs.pos_t, fs.model.clock, draw)

        pro = prologue(copies()[0])
        accept, dq = point_scan(pro.delta, pro.zG, sx["Pblk"], pro.d_pr, pro.lmhg, u)

        def epilogue(c, sx=sx, branch=branch, pro=pro, accept=accept, dq=dq):
            return K4.point_lik_epilogue(branch, c.batch, c.terms, c.d, c.q, c.acc, sx, pro,
                                         accept, dq)

        tag = "branch" if branch else "slide"
        out[f"point_lik_prologue {tag}"] = dict(B=B, KD=KD, accepted=int(accept.sum()),
                                                **timed(prologue, "point_lik_prologue_kernel"))
        out[f"point_lik_epilogue {tag}"] = dict(B=B, KD=KD, accepted=int(accept.sum()),
                                                **timed(epilogue, "point_lik_epilogue_kernel"))
    out["prior_terms"] = k1_record(torch, fs.model, carry.batch)
    out.update(k3_records(torch, fs, carry, tuning, gen))
    return dict(reps=reps, flush_mb=FLUSH_BYTES / 1e6, records=out)


PHASES = {"glob": glob_phase, "range": range_phase, "kernels": kernels_phase}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=sorted(PHASES), required=True)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--taxa", type=int, nargs="+", default=[136, 1000])
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from mcmcdate_tpu_torch import synthetic
    from mcmcdate_tpu_torch.engine import fast_sweep, proposals

    if not torch.cuda.is_available():
        raise SystemExit("phase_time needs a CUDA card")
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
        gen = torch.Generator(device="cuda").manual_seed(taxa)
        rec = dict(root=root, card=card, taxa=taxa, chains=CHAINS, phase=args.phase,
                   **PHASES[args.phase](torch, fs, carry, tuning, gen))
        print(json.dumps(rec), flush=True)
        out.append(rec)
        del fs, model, batch, carry
        torch.cuda.empty_cache()
    if args.phase == "kernels":
        from mcmcdate_tpu_torch.tools.seq_time import univariate_model

        model, init = univariate_model(UNI_TAXA)
        batch = init.replace(**{f: getattr(init, f).expand(CHAINS, *getattr(init, f).shape[1:])
                                .contiguous() for f in ("heights", "rates", "birth", "death",
                                                        "height", "rate_mean", "rate_var")})
        rec = dict(root=root, card=card, taxa=UNI_TAXA, chains=CHAINS, phase=args.phase,
                   model="univariate", records={"prior_terms": k1_record(torch, model, batch)})
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
