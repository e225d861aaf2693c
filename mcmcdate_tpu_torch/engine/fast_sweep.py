"""Ticket-batched sweep (FastSweeps): the default proposal cycle of ``run``.

Port of ``mcmcdate_tpu/engine/fast_sweep.py`` (a sparse precision is
stored dense and runs as full), with its optional moves: the bold contrary
mixture (``bold_p``, ``bold_factor``: with probability ``bold_p`` a
contrary subtree scale of K6's range mode or of G1's sub_contra family
takes a ``bold_factor`` times wider kernel), the fiber node-slide phase
(``fiber_slide``: kernel F1 ``fiber_slide``, once a sweep after the range
phase with that probability) and the in-cycle NUTS move (``sweeps(nuts=)``,
``engine/hmc.py``), which run after the batched phases, as in the JAX
package.
Under the banded likelihood kind every
precision and Cholesky product goes through the block-tridiagonal kernels
B1 ``band_matmul`` and B2 ``band_matmul_t`` (``ops/banded.py``), and no
``[D, D]`` or ``[rows, D]`` tensor is built.  A
sweep executes sets of provably non-interacting proposal tickets as one
vectorised step each: their prior dependencies are disjoint by
construction, and the likelihood couples them only through the carried
``z = P (d - mu)`` and ``q = (d-mu)' P (d-mu)``, for which a sequential
accept scan over each batch applies the exact pairwise corrections (see
the JAX module's docstring).

Phases of a sweep, in the JAX package's order:

1. the tickets the planner cannot batch, through the sequential
   :class:`~.mh.MHKernel` on ``plan.seq_table`` (host-drawn order, ``y``
   carry);
2. the 14 global-move families of :data:`GLOB_ORDER`, each family's draws
   in one or two generator calls: kernel G1 ``glob_scan`` walks a whole
   family whose distances are untouched or scale uniformly, and a ticket of
   the six families whose distances change takes kernels G2
   ``glob_dense_prologue`` and G3 ``glob_dense_epilogue`` around one
   ``delta @ P`` product;
3. the point mega-steps: distance-invariant contrary node slides (kernel
   K6 ``contra_slide``) and the likelihood-coupled node slides and
   branch-rate scales (K4: the kernels ``point_lik_prologue``,
   ``point_scan`` for the accept scan, and ``point_lik_epilogue``);
4. the subtree-range blocks: the ultrametric and rate subtree scales
   (K5: the kernels ``range_lik_prologue``, ``range_scan`` for the Gram
   blocks and the accept scan, and ``range_lik_epilogue``) and the
   distance-invariant contrary subtree scales (K6 ``contra_range``);
5. with ``fiber_slide``, the fiber node-slide (F1 ``fiber_slide``, one
   launch a colour class of :func:`fiber_slide_plan`), which leaves every
   branch distance, so ``d``, ``z``, ``q`` and ``y``, as they are.

The state is ``[chains, param]`` throughout; every P, z and d row access is
a plain index gather and every write-back an ``index_add_`` (the JAX
module's one-hot selector matmuls and transposed range layout are TPU
workarounds).  Every step function takes its random draws as arguments;
:meth:`FastSweeps.sweeps` draws them from ``torch.Generator``s on the
batch's device.  Steps update the carry in place.  Every decision with a
likelihood takes the carry's per-chain likelihood temperature
(``FastCarry.beta``, ``[C]``: the stepping-stone ladder; None: 1), as the
JAX steps take their ``beta``, and every decision its prior temperature
(``FastCarry.beta_prior``: MC3's ladder; None: 1), as they take their
``beta_prior``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..kernels.band_matmul import band_matmul, band_matmul_t
from ..kernels.contra_step import contra_range, contra_slide
from ..kernels.fiber_slide import FiberClass, fiber_slide
from ..kernels.glob_step import (
    DENSE,
    FAMILIES,
    GAMMA_TAGS,
    SUBTREE_DENSE,
    GlobConsts,
    GlobFamily,
    glob_dense_epilogue,
    glob_dense_prologue,
    glob_family_plain,
    glob_scan,
    glob_ticket_plain,
)
from ..kernels.point_scan import pitched, point_scan
from ..kernels.point_step import point_lik_epilogue, point_lik_prologue, point_plan
from ..kernels.range_scan import kernel_layout, range_scan
from ..kernels.range_step import RangeWork, range_lik_epilogue, range_lik_prologue, \
    range_plan
from ..kernels.whiten import whiten
from ..models.dating import DatingModel
from ..models.state import FIELDS, State
from ..ops import banded, mvn
from ..ops.dists import standard_gamma
from ..ops.heights import distances_internal
from ..ops.node_priors import SQRT_2_OVER_PI
from . import proposals as P
from .mh import Carry, MHKernel, chain_beta

BATCH_MAX = 512


# ---------------------------------------------------------------------------
# Host-side planning (copied from the JAX module; NumPy only)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MegaSpec:
    """Stacked static arrays for all mega-steps of one kind.

    Leading axis = mega-step; second = ticket slot (padded to a common B).
    ``valid`` masks pad slots.  ``t_*`` are flat term-vector row indices;
    ``d_rows`` are internal-layout distance rows (-1 where absent).
    Calibration slot j maps to t_rows slot KT-KN+j.  A slide's term rows
    sit where the step's new terms do (``ops.local_terms.slide_terms``):
    the node's birth-death and clock rows, child slot j's birth-death row
    at 2+j and its clock row at 2+KC+j (-1 where the node has fewer
    children than KC), then the calibrations.  The JAX planner packs the
    children's rows to the front instead, which on a multifurcating tree
    puts a node with fewer than KC children's terms in the wrong slots.
    """

    kind: int
    rows: np.ndarray      # int32[M, B] proposal-table row per ticket
    node: np.ndarray      # int32[M, B]
    par: np.ndarray       # int32[M, B]
    ch: np.ndarray        # int32[M, B, KC]
    valid: np.ndarray     # bool[M, B]
    t_rows: np.ndarray    # int32[M, B, KT] touched term rows (-1 pad)
    d_rows: np.ndarray    # int32[M, B, KD] touched distance rows (-1 pad)
    sd: np.ndarray        # f64[M, B] base kernel parameter (sd / shape)
    cal_lo: np.ndarray    # f64[M, B, KN] absolute lower bound (0 if none)
    cal_lo_s: np.ndarray  # f64[M, B, KN] sqrt(2/pi) * lower pm (1 if none)
    cal_hi: np.ndarray    # f64[M, B, KN] absolute upper bound (inf if none)
    cal_hi_s: np.ndarray  # f64[M, B, KN] sqrt(2/pi) * upper pm (1 if none)

    @property
    def n_mega(self) -> int:
        return self.rows.shape[0]

    @property
    def b(self) -> int:
        return self.rows.shape[1]


@dataclass(frozen=True)
class RangeSpec:
    """Stacked sub-blocks of subtree-range tickets (one step = one sub-block
    of tickets with pairwise-disjoint pre-order ranges, each padded to
    ``RB`` rows).  ``own`` holds the covered node rows per ticket slot (-1
    pad); the ``cal_*`` slots hold calibrated nodes inside the range."""

    kind: int
    rows: np.ndarray     # int32[M, S]
    node: np.ndarray     # int32[M, S]
    par: np.ndarray      # int32[M, S]
    valid: np.ndarray    # bool[M, S]
    sd: np.ndarray       # f64[M, S]
    n_inner: np.ndarray  # int32[M, S] inner nodes in subtree
    n_nodes: np.ndarray  # int32[M, S] nodes (branches) in subtree
    own: np.ndarray      # int32[M, S, RB] covered node rows (-1 pad)
    own_par: np.ndarray  # int32[M, S, RB] parent of each covered row
    cal_t_rows: np.ndarray  # int32[M, S, KN] term rows (-1 pad)
    cal_hsrc: np.ndarray    # int32[M, S, KN] node whose height feeds slot
    cal_lo: np.ndarray      # f64[M, S, KN]
    cal_lo_s: np.ndarray    # f64[M, S, KN]
    cal_hi: np.ndarray      # f64[M, S, KN]
    cal_hi_s: np.ndarray    # f64[M, S, KN]

    @property
    def n_blocks(self) -> int:
        return self.rows.shape[0]


@dataclass(frozen=True)
class GlobGroup:
    """Weight-expanded tickets of one global-move family: hyper-parameter
    scales, the contrary global moves and the subtree scales the range
    phase cannot take (root-adjacent, > ``RB_MAX`` rows, or
    constraint/brace-coupled ranges)."""

    tag: str
    rows: np.ndarray      # int32[n] original table row per ticket
    sd: np.ndarray        # float64[n] kernel width parameter
    aux: np.ndarray       # int32[n] SC_* code or subtree node index
    lo: np.ndarray        # int32[n] subtree node range start (pre-order)
    hi: np.ndarray        # int32[n] subtree node range end
    n_inner: np.ndarray   # int32[n] inner nodes in subtree
    n_nodes: np.ndarray   # int32[n] nodes (branches) in subtree
    rj: np.ndarray        # bool[n]  apply the root-branch Jacobian ratio

    @property
    def n_tickets(self) -> int:
        return self.rows.shape[0]


# Group execution order (static composition; any fixed order is a valid
# kernel composition): the glob kernels' family table.
GLOB_ORDER = tuple(FAMILIES)


@dataclass(frozen=True)
class FastPlan:
    specs: Dict[int, MegaSpec]
    range_specs: Dict[tuple, RangeSpec]
    glob_groups: Dict[str, GlobGroup]
    seq_table: P.ProposalTable  # leftover rows for the sequential fallback
    seq_rows: np.ndarray        # mapping: seq-table row -> original row


BATCHED_KINDS = (P.K_SLIDE_NODES_CONTRA, P.K_SLIDE_NODE_ULTRA, P.K_SCALE_BRANCH_RATE)
RANGE_KINDS = (P.K_SCALE_SUBTREE_ULTRA, P.K_SCALE_SUBTREE_RATE, P.K_SCALE_SUBTREES_CONTRA)
# (tickets, rows) per range block: every bucket is a 1024-row grid; larger
# subtrees go to the sub_* global families.
RANGE_BUCKETS = ((64, 16), (16, 64), (4, 256))
RB_MAX = max(rb for _, rb in RANGE_BUCKETS)


def plan_batches(model: DatingModel, table: P.ProposalTable) -> FastPlan:
    """Greedy host-side plan: point kinds colored into mega-steps of at most
    ``BATCH_MAX`` tickets with no parent-child pair and no repeated row;
    range kinds packed size-descending first-fit into bucketed blocks of
    disjoint subtrees; global families grouped; the rest stays sequential.
    Tickets on constraint/brace nodes stay sequential (those terms couple
    other nodes' heights); calibrated nodes batch with per-ticket slots."""
    topo = model.topo
    n = topo.n
    parent = np.asarray(topo.parent)
    children = np.asarray(topo.children)
    kc = children.shape[1]
    pos = np.asarray(topo.internal_pos)

    cal = model.calibrations
    hard_np: set = set()
    if model.constraints.n:
        hard_np.update(int(x) for x in np.asarray(model.constraints.young))
        hard_np.update(int(x) for x in np.asarray(model.constraints.old))
    if model.braces.n:
        hard_np.update(int(x) for x in np.asarray(model.braces.node).ravel() if x >= 0)
    cal_rows_of: Dict[int, List[int]] = {}
    if cal.n:
        for cr, nd_ in enumerate(np.asarray(cal.node)):
            cal_rows_of.setdefault(int(nd_), []).append(cr)
    nodes_off = 4 + 2 * (n + 1)  # term-vector offset of calibration rows

    kind = np.asarray(table.kind)
    node = np.asarray(table.node)
    weight = np.asarray(table.weight)
    root_jac = np.asarray(table.root_jac)
    par_tab = np.asarray(table.par)

    batched_tickets: Dict[int, List[int]] = {k: [] for k in BATCHED_KINDS}
    seq_row_mask = np.ones(len(kind), bool)

    for r in range(len(kind)):
        k = int(kind[r])
        if k not in BATCHED_KINDS:
            continue
        i = int(node[r])
        if root_jac[r]:
            continue  # root-adjacent: sequential
        if k != P.K_SCALE_BRANCH_RATE and i in hard_np:
            continue  # constraint/brace terms couple other nodes
        seq_row_mask[r] = False
        batched_tickets[k].extend([r] * int(weight[r]))

    specs = {}
    for k, tickets in batched_tickets.items():
        if not tickets:
            continue
        # Greedy coloring: two tickets conflict if the same row (weight
        # copies) or their nodes are in a parent-child relation.
        colors: List[List[int]] = []
        color_nodes: List[set] = []
        color_rows: List[set] = []
        for t in tickets:
            i = int(node[t])
            neigh = {i, int(parent[i])} | {int(c) for c in children[i] if c >= 0}
            placed = False
            for ci in range(len(colors)):
                if t in color_rows[ci] or neigh & color_nodes[ci] or len(colors[ci]) >= BATCH_MAX:
                    continue
                colors[ci].append(t)
                color_nodes[ci].add(i)
                color_rows[ci].add(t)
                placed = True
                break
            if not placed:
                colors.append([t])
                color_nodes.append({i})
                color_rows.append({t})
        m = len(colors)
        b = max(len(c) for c in colors)
        if k == P.K_SCALE_BRANCH_RATE:
            kn = 0  # rates only: calibration terms unaffected
        else:
            kn = max((len(cal_rows_of.get(int(node[t]), ())) for t in tickets), default=0)
        kt = 2 * (1 + kc) + kn  # bd + clock rows for node + children + cal
        kd = 1 if k == P.K_SCALE_BRANCH_RATE else 1 + kc
        S = dict(
            rows=np.zeros((m, b), np.int32),
            node=np.zeros((m, b), np.int32),
            par=np.zeros((m, b), np.int32),
            ch=np.full((m, b, kc), -1, np.int32),
            valid=np.zeros((m, b), bool),
            t_rows=np.full((m, b, kt), -1, np.int32),
            d_rows=np.full((m, b, kd), -1, np.int32),
            sd=np.zeros((m, b), np.float64),
            cal_lo=np.zeros((m, b, kn), np.float64),
            cal_lo_s=np.ones((m, b, kn), np.float64),
            cal_hi=np.full((m, b, kn), np.inf, np.float64),
            cal_hi_s=np.ones((m, b, kn), np.float64),
        )
        bd_off = 4
        ck_off = 4 + (n + 1)
        for ci, col in enumerate(colors):
            for s, t in enumerate(col):
                i = int(node[t])
                S["rows"][ci, s] = t
                S["node"][ci, s] = i
                S["par"][ci, s] = int(parent[i])
                S["valid"][ci, s] = True
                S["sd"][ci, s] = par_tab[t]
                cs = [int(c) for c in children[i] if c >= 0]
                for j, c in enumerate(cs):
                    S["ch"][ci, s, j] = c
                if k == P.K_SCALE_BRANCH_RATE:
                    S["t_rows"][ci, s, 0] = ck_off + i
                    S["d_rows"][ci, s, 0] = pos[i]
                else:
                    S["t_rows"][ci, s, :2] = (bd_off + i, ck_off + i)
                    for j, c in enumerate(cs):
                        S["t_rows"][ci, s, 2 + j] = bd_off + c
                        S["t_rows"][ci, s, 2 + kc + j] = ck_off + c
                    for j, cr in enumerate(cal_rows_of.get(i, ())):
                        S["t_rows"][ci, s, 2 * (1 + kc) + j] = nodes_off + cr
                        S["cal_lo"][ci, s, j] = cal.lower[cr]
                        S["cal_lo_s"][ci, s, j] = SQRT_2_OVER_PI * cal.lower_pm[cr]
                        S["cal_hi"][ci, s, j] = cal.upper[cr]
                        S["cal_hi_s"][ci, s, j] = SQRT_2_OVER_PI * cal.upper_pm[cr]
                    if k == P.K_SLIDE_NODE_ULTRA:
                        dl = sorted({int(pos[i])} | {int(pos[c]) for c in cs})
                        S["d_rows"][ci, s, : len(dl)] = dl
        specs[k] = MegaSpec(kind=k, **S)

    # --- range kinds: subtree scales batched as disjoint-range sub-blocks.
    subtree_end = np.asarray(topo.subtree_end)
    n_inner_sub = np.asarray(topo.n_inner_subtree)
    n_nodes_sub = np.asarray(topo.n_nodes_subtree)
    range_tickets: Dict[int, List[int]] = {k: [] for k in RANGE_KINDS}
    for r in range(len(kind)):
        k = int(kind[r])
        if k not in RANGE_KINDS:
            continue
        i = int(node[r])
        size = int(subtree_end[i]) - i
        if root_jac[r] or size > RB_MAX:
            continue
        if k != P.K_SCALE_SUBTREE_RATE:
            # Height-changing kinds: constraint/brace nodes inside the range
            # stay sequential; calibrated nodes use the per-ticket slots.
            if any(i <= x < subtree_end[i] for x in hard_np):
                continue
        seq_row_mask[r] = False
        range_tickets[k].extend([r] * int(weight[r]))

    range_specs = {}
    for k, all_tickets in range_tickets.items():
        prev_rb = 0
        for subr, rb in RANGE_BUCKETS:
            tickets = [t for t in all_tickets
                       if prev_rb < int(subtree_end[node[t]]) - int(node[t]) <= rb]
            prev_rb = rb
            if not tickets:
                continue
            # First-fit over size-descending tickets: a block needs
            # pairwise-disjoint ranges and distinct table rows.
            tickets = sorted(tickets, key=lambda t: int(node[t]) - int(subtree_end[node[t]]))
            blocks: List[List[int]] = []
            block_mask: List[np.ndarray] = []
            block_rows: List[set] = []
            for t in tickets:
                i = int(node[t])
                lo, hi = i, int(subtree_end[i])
                placed = False
                for bi in range(len(blocks)):
                    if (len(blocks[bi]) >= subr or t in block_rows[bi]
                            or block_mask[bi][lo:hi].any()):
                        continue
                    blocks[bi].append(t)
                    block_mask[bi][lo:hi] = True
                    block_rows[bi].add(t)
                    placed = True
                    break
                if not placed:
                    blocks.append([t])
                    msk = np.zeros(n, bool)
                    msk[lo:hi] = True
                    block_mask.append(msk)
                    block_rows.append({t})
            m = len(blocks)
            if k == P.K_SCALE_SUBTREE_RATE:
                kn = 0
            else:
                kn = max((sum(len(cal_rows_of.get(x, ()))
                              for x in range(int(node[t]), int(subtree_end[node[t]])))
                          for t in tickets), default=0)
            S = dict(
                rows=np.zeros((m, subr), np.int32),
                node=np.zeros((m, subr), np.int32),
                par=np.zeros((m, subr), np.int32),
                valid=np.zeros((m, subr), bool),
                sd=np.zeros((m, subr), np.float64),
                n_inner=np.ones((m, subr), np.int32),
                n_nodes=np.ones((m, subr), np.int32),
                own=np.full((m, subr, rb), -1, np.int32),
                own_par=np.zeros((m, subr, rb), np.int32),
                cal_t_rows=np.full((m, subr, kn), -1, np.int32),
                cal_hsrc=np.zeros((m, subr, kn), np.int32),
                cal_lo=np.zeros((m, subr, kn), np.float64),
                cal_lo_s=np.ones((m, subr, kn), np.float64),
                cal_hi=np.full((m, subr, kn), np.inf, np.float64),
                cal_hi_s=np.ones((m, subr, kn), np.float64),
            )
            for bi, blk in enumerate(blocks):
                for s, t in enumerate(blk):
                    i = int(node[t])
                    lo, hi = i, int(subtree_end[i])
                    S["rows"][bi, s] = t
                    S["node"][bi, s] = i
                    S["par"][bi, s] = int(parent[i])
                    S["valid"][bi, s] = True
                    S["sd"][bi, s] = par_tab[t]
                    S["n_inner"][bi, s] = n_inner_sub[i]
                    S["n_nodes"][bi, s] = n_nodes_sub[i]
                    S["own"][bi, s, : hi - lo] = np.arange(lo, hi)
                    S["own_par"][bi, s, : hi - lo] = parent[lo:hi]
                    if kn:
                        slot = 0
                        for x in range(lo, hi):
                            for cr in cal_rows_of.get(x, ()):
                                S["cal_t_rows"][bi, s, slot] = nodes_off + cr
                                S["cal_hsrc"][bi, s, slot] = x
                                S["cal_lo"][bi, s, slot] = cal.lower[cr]
                                S["cal_lo_s"][bi, s, slot] = SQRT_2_OVER_PI * cal.lower_pm[cr]
                                S["cal_hi"][bi, s, slot] = cal.upper[cr]
                                S["cal_hi_s"][bi, s, slot] = SQRT_2_OVER_PI * cal.upper_pm[cr]
                                slot += 1
            range_specs[(k, rb)] = RangeSpec(kind=k, **S)

    # --- global-move families: everything here leaves the sequential phase.
    glob_lists: Dict[str, List[int]] = {t: [] for t in GLOB_ORDER}
    sub_tag = {P.K_SCALE_SUBTREE_ULTRA: "sub_ultra",
               P.K_SCALE_SUBTREE_RATE: "sub_rate",
               P.K_SCALE_SUBTREES_CONTRA: "sub_contra"}
    kind_tag = {P.K_SCALE_HEIGHT_RATEMEAN_CONTRA: "hm_contra",
                P.K_SCALE_NORM_RATE_TREE_CONTRA: "norm_contra",
                P.K_SCALE_NORM_HEIGHT_RATE_TREE_CONTRA: "normh_contra",
                P.K_SCALE_VAR_RATE_TREE: "var_tree",
                P.K_SCALE_VAR_RATE_TREE_AUTOCORR: "var_auto",
                P.K_SCALE_RATES_TIME_TREE_CONTRA: "rates_time",
                P.K_SLIDE_ROOT_CONTRA: "slide_root"}
    sc_tag = {P.SC_BIRTH: "bd_scale", P.SC_DEATH: "bd_scale",
              P.SC_BIRTH_DEATH: "bd_scale", P.SC_BIRTH_DEATH_CONTRA: "bd_scale",
              P.SC_RATE_MEAN: "rate_mean", P.SC_RATE_VAR: "rate_var",
              P.SC_HEIGHT: "height"}
    aux_tab = np.asarray(table.aux)
    for r in range(len(kind)):
        if not seq_row_mask[r]:
            continue
        k = int(kind[r])
        if k == P.K_SCALE_SCALAR:
            tag = sc_tag.get(int(aux_tab[r]))
        else:
            tag = kind_tag.get(k, sub_tag.get(k))
        if tag is None:
            continue
        seq_row_mask[r] = False
        glob_lists[tag].extend([r] * int(weight[r]))
    glob_groups: Dict[str, GlobGroup] = {}
    for tag in GLOB_ORDER:
        ts = glob_lists[tag]
        if not ts:
            continue
        m = len(ts)
        G = dict(
            rows=np.zeros(m, np.int32), sd=np.zeros(m, np.float64),
            aux=np.zeros(m, np.int32), lo=np.zeros(m, np.int32),
            hi=np.zeros(m, np.int32), n_inner=np.ones(m, np.int32),
            n_nodes=np.ones(m, np.int32), rj=np.zeros(m, bool),
        )
        for s, t in enumerate(ts):
            G["rows"][s] = t
            G["sd"][s] = par_tab[t]
            G["rj"][s] = bool(root_jac[t])
            if int(kind[t]) == P.K_SCALE_SCALAR:
                G["aux"][s] = aux_tab[t]
            else:
                i = int(node[t])
                G["aux"][s] = i
                if int(kind[t]) in sub_tag:
                    G["lo"][s] = i
                    G["hi"][s] = subtree_end[i]
                    G["n_inner"][s] = n_inner_sub[i]
                    G["n_nodes"][s] = n_nodes_sub[i]
        glob_groups[tag] = GlobGroup(tag=tag, **G)

    seq_rows = np.nonzero(seq_row_mask)[0].astype(np.int32)
    seq_table = _subset_table(table, seq_rows)
    return FastPlan(specs=specs, range_specs=range_specs, glob_groups=glob_groups,
                    seq_table=seq_table, seq_rows=seq_rows)


def _subset_table(table: P.ProposalTable, rows: np.ndarray) -> P.ProposalTable:
    weight = np.asarray(table.weight)[rows]
    tickets = np.concatenate(
        [np.full(w, p, np.int32) for p, w in enumerate(weight)]
    ) if len(rows) else np.zeros(0, np.int32)

    def sub(a):
        return None if a is None else np.asarray(a)[rows]

    return P.ProposalTable(
        kind=sub(table.kind), node=sub(table.node), aux=sub(table.aux), par=sub(table.par),
        weight=weight, dim=sub(table.dim), root_jac=sub(table.root_jac),
        names=tuple(table.names[r] for r in rows), tickets=tickets,
        d_class=sub(table.d_class), d_lo=sub(table.d_lo), didx=sub(table.didx),
        prior_class=sub(table.prior_class),
    )


def fiber_slide_plan(model: DatingModel) -> List[dict]:
    """The fiber node-slide's colour classes (the JAX
    ``FastSweeps._fiber_slide_plan``, ``engine/fast_sweep.py:1922``): the
    internal non-root nodes, coloured greedily (most conflicts first) so
    that no two nodes of a class are tree-adjacent or share a constraint or
    a brace, and per class its nodes ``idx``, their parents ``par`` and
    children ``ch`` ``[m, KC]`` (-1 pad), the children flattened (``ch_row``,
    ``ch_col``, ``ch_idx``) and the term ``owner`` map over ``[4 | N+1 | N+1 |
    nn]``: the class node whose move changes each term, ``m`` for none."""
    topo = model.topo
    N = topo.n
    parent = np.asarray(topo.parent)
    is_leaf = np.asarray(topo.is_leaf)
    movable = [i for i in range(1, N) if not is_leaf[i]]
    mov = set(movable)
    adj = {i: set() for i in movable}

    def edge(a, b):
        if a in mov and b in mov and a != b:
            adj[a].add(b)
            adj[b].add(a)

    for i in movable:
        edge(i, int(parent[i]))
    con, br, cal = model.constraints, model.braces, model.calibrations
    if con.n:
        for yy, oo in zip(np.asarray(con.young), np.asarray(con.old)):
            edge(int(yy), int(oo))
    if br.n:
        for row in np.asarray(br.node):
            real = [int(x) for x in row if x >= 0]
            for a in range(len(real)):
                for b in range(a + 1, len(real)):
                    edge(real[a], real[b])
    color: Dict[int, int] = {}
    for i in sorted(movable, key=lambda i: -len(adj[i])):
        used = {color[j] for j in adj[i] if j in color}
        c = 0
        while c in used:
            c += 1
        color[i] = c
    n_colors = 1 + max(color.values(), default=-1)
    T = 4 + 2 * (N + 1) + (cal.n + con.n + br.n)
    children = np.asarray(topo.children)
    classes = []
    for c in range(n_colors):
        idx = np.asarray(sorted(i for i in movable if color[i] == c), np.int32)
        m = len(idx)
        pos = {int(v): j for j, v in enumerate(idx)}
        owner = np.full(T, m, np.int32)
        # Birth-death term i depends on (h_i, h_parent(i)), clock term i on
        # (r_i, its branch's time): both move iff i or its parent moves.
        for i in range(1, N):
            own = pos.get(i, pos.get(int(parent[i])))
            if own is not None:
                owner[4 + i] = own
                owner[4 + (N + 1) + i] = own
        off = 4 + 2 * (N + 1)
        for nd in np.asarray(cal.node) if cal.n else ():
            if int(nd) in pos:
                owner[off] = pos[int(nd)]
            off += 1
        if con.n:
            for yy, oo in zip(np.asarray(con.young), np.asarray(con.old)):
                own = pos.get(int(yy), pos.get(int(oo)))
                if own is not None:
                    owner[off] = own
                off += 1
        for row in np.asarray(br.node) if br.n else ():
            for x in row:
                if int(x) in pos:
                    owner[off] = pos[int(x)]
                    break
            off += 1
        ch = children[idx]  # [m, KC], -1 padding
        pj, pc = np.nonzero(ch >= 0)
        classes.append(dict(idx=idx, par=parent[idx].astype(np.int32), ch=ch.astype(np.int32),
                            ch_row=pj.astype(np.int32), ch_col=pc.astype(np.int32),
                            ch_idx=ch[pj, pc].astype(np.int32), owner=owner))
    return classes


# ---------------------------------------------------------------------------
# Device steps
# ---------------------------------------------------------------------------


UNIVARIATE_DENSE_MAX = 4096  # dims; above this the diagonal kind stays sequential


@dataclass
class FastCarry:
    """What the batched phases carry per chain and update in place: the
    state, the prior terms ``[C, T]``, the internal-layout distances ``d``
    ``[C, D]``, ``z = P (d - mu)`` ``[C, D]`` (``[C, 0]`` without a
    likelihood), ``q = (d-mu)' P (d-mu)`` ``[C]``, the accept counts
    ``[C, P]``, and the likelihood and prior temperatures ``beta`` and
    ``beta_prior`` ``[C]`` of every decision (None: 1)."""

    batch: State
    terms: torch.Tensor
    d: torch.Tensor
    z: torch.Tensor
    q: torch.Tensor
    acc: torch.Tensor
    beta: Optional[torch.Tensor] = None
    beta_prior: Optional[torch.Tensor] = None


def spec_tensors(spec, device, dtype) -> dict:
    """A plan spec's arrays on ``device``: integer fields int32, float
    fields in ``dtype``, masks bool."""
    out = {}
    for f in dataclasses.fields(spec):
        if f.name in ("kind", "tag"):
            continue
        a = np.asarray(getattr(spec, f.name))
        if a.dtype == bool:
            out[f.name] = torch.as_tensor(a, device=device)
        elif np.issubdtype(a.dtype, np.integer):
            out[f.name] = torch.as_tensor(a.astype(np.int32), device=device)
        else:
            out[f.name] = torch.as_tensor(a, dtype=dtype, device=device)
    return out


def step_tensors(spec, device, dtype) -> List[dict]:
    """Per-step tensors of a :class:`MegaSpec` or :class:`RangeSpec`,
    trimmed to the step's valid slots (they come first) and, for range
    blocks, to the rows its tickets use: pad slots and rows never accept
    and contribute exact zeros, so the trim changes no result and spares
    the gathers and the scan their padding."""
    full = spec_tensors(spec, device, dtype)
    valid = np.asarray(spec.valid)
    out = []
    for m in range(valid.shape[0]):
        n = int(valid[m].sum())
        sx = {k: v[m, :n].contiguous() for k, v in full.items()}
        if "own" in sx:
            rb = int((np.asarray(spec.own[m, :n]) >= 0).sum(-1).max())
            sx["own"] = sx["own"][:, :rb].contiguous()
            sx["own_par"] = sx["own_par"][:, :rb].contiguous()
        out.append(sx)
    return out


def env_default(value: Optional[float], name: str, default: float) -> float:
    """``value``, or where None the environment variable ``name`` (else
    ``default``)."""
    return float(os.environ.get(name, default)) if value is None else float(value)


class FastSweeps:
    """Drop-in alternative to ``MHKernel.sweeps`` using the batched plan,
    for the full and sparse (its dense precision, as full), banded (its
    block-tridiagonal ``P3`` and ``L3``), univariate (as a dense diagonal,
    up to ``UNIVARIATE_DENSE_MAX`` dims) and none likelihood kinds.
    ``bold_p`` and ``bold_factor`` set the bold contrary mixture (off at
    0), ``fiber_slide`` the fiber phase's probability a sweep (off at 0);
    None takes ``MCMCDATE_BOLD_P``, ``MCMCDATE_BOLD_FACTOR`` and
    ``MCMCDATE_FIBER_SLIDE`` (else 0, 8 and 0), as the JAX constructor
    does."""

    def __init__(self, model: DatingModel, table: P.ProposalTable,
                 bold_p: Optional[float] = None, bold_factor: Optional[float] = None,
                 fiber_slide: Optional[float] = None):
        kind = model.likelihood.kind
        self.model = model
        # The optional moves (the JAX constructor's, fast_sweep.py:733-749):
        # the arguments win, the MCMCDATE_* variables are the fallbacks.
        self.bold_p = env_default(bold_p, "MCMCDATE_BOLD_P", 0.0)
        self.bold_factor = env_default(bold_factor, "MCMCDATE_BOLD_FACTOR", 8.0)
        self.fiber_slide_p = env_default(fiber_slide, "MCMCDATE_FIBER_SLIDE", 0.0)
        self.table = table
        self.plan = plan_batches(model, table)
        self.seq_kern = MHKernel(model, self.plan.seq_table)
        self.use_lik = kind != mvn.NONE
        self.banded = kind == mvn.BANDED
        self.dim = model.likelihood.dim
        dev, dt = model.device, model.dtype
        self.P = self.L = None
        self._scatter = {}  # the banded z update's zero [C, D] buffer, by shape
        if self.banded:
            # The precision's symmetric band (its Q and Pblk entries) and
            # the block forms of P and L, all O(D w).
            pband = banded.pband_from_chol_upper(model.likelihood.band_chol)
            self.L3 = model.band_L3_internal_t
            self.nb, _, self.wb, _ = self.L3.shape
            self.P3 = torch.as_tensor(banded.blocks_from_sym_band(pband, self.wb), dtype=dt,
                                      device=dev)
            self.pband = torch.as_tensor(pband, dtype=dt, device=dev)
        elif kind == mvn.UNIVARIATE:
            if self.dim > UNIVARIATE_DENSE_MAX:
                raise ValueError(
                    f"FastSweeps univariate path materializes a diagonal {self.dim}^2 "
                    f"precision; use the sequential kernel above {UNIVARIATE_DENSE_MAX} dims")
            inv_sd = np.asarray(model.inv_sd_internal, np.float64)
            prec, chol = np.diag(inv_sd * inv_sd), np.diag(inv_sd)
        elif self.use_lik:
            perm = model.topo.ref_to_internal_perm
            prec, chol = model.likelihood.precision[np.ix_(perm, perm)], model.chol_internal
        if self.use_lik:
            # Constants of the closed-form uniform distance scalings
            # (rate-mean / absolute-height scales): with d' = u d,
            # z' = u z + (u-1) P mu and dq = (u^2-1) q + 2u(u-1) mu'z + (u-1)^2 mu'P mu.
            mu64 = np.asarray(model.mu_internal, np.float64)
            if self.banded:
                pmu = banded.sym_band_matvec(pband, mu64)
            else:
                pmu = np.asarray(prec, np.float64) @ mu64
                self.P = torch.as_tensor(np.asarray(prec, np.float64), dtype=dt, device=dev)
                self.L = torch.as_tensor(np.asarray(chol, np.float64), dtype=dt, device=dev)
            self.mu = model.mu_internal_t
            self.Pmu = torch.as_tensor(pmu, dtype=dt, device=dev)
            self.mPm = float(mu64 @ pmu)
        topo = model.topo
        self.pos_t = torch.as_tensor(np.asarray(topo.internal_pos, np.int32), device=dev)
        self.is_leaf_t = topo.is_leaf_t
        self.spec_t = {k: step_tensors(s, dev, dt) for k, s in self.plan.specs.items()}
        for k, steps in self.spec_t.items():
            if k != P.K_SLIDE_NODES_CONTRA:
                for sx in steps:
                    self._point_rows(sx)
        self.range_t = {k: step_tensors(s, dev, dt) for k, s in self.plan.range_specs.items()}
        for (k, _), steps in self.range_t.items():
            if k != P.K_SCALE_SUBTREES_CONTRA:
                for sx in steps:
                    self._range_rows(sx)
                # One set of K5 outputs on the card per (kind, row bucket),
                # which its blocks write in turn.
                work = RangeWork(k == P.K_SCALE_SUBTREE_RATE, self.use_lik, steps)
                for sx in steps:
                    sx["work"] = work
        # A rate group's gamma shapes depend on the tuning alone, which a
        # sweep does not change: the group gathers them in one launch.
        self.range_gamma = {
            key: (torch.cat([sx["rows"] for sx in steps]), torch.cat([sx["sd"] for sx in steps]))
            for key, steps in self.range_t.items() if key[0] == P.K_SCALE_SUBTREE_RATE}
        # The same for the branch-rate scales' point steps.
        self.point_gamma = {
            k: (torch.cat([sx["rows"] for sx in steps]), torch.cat([sx["sd"] for sx in steps]))
            for k, steps in self.spec_t.items() if k == P.K_SCALE_BRANCH_RATE}
        child_list = [int(c) for c in topo.children[0] if c >= 0]
        self.glob = GlobConsts(
            model=model, use_lik=self.use_lik, P=self.P,
            mu=self.mu if self.use_lik else None, Pmu=self.Pmu if self.use_lik else None,
            mPm=self.mPm if self.use_lik else 0.0, child_list=child_list,
            n_inner_total=int((~np.asarray(topo.is_leaf)).sum()),
            sc_codes=dict(birth=P.SC_BIRTH, death=P.SC_DEATH, bd=P.SC_BIRTH_DEATH,
                          bdc=P.SC_BIRTH_DEATH_CONTRA),
            dist_idx=torch.as_tensor(np.asarray(topo.internal_dist_index, np.int32), device=dev),
            root_ch=torch.as_tensor(np.asarray(child_list, np.int32), device=dev),
            pos=np.asarray(topo.internal_pos, np.int64),
            product=self._x_P if self.banded else None)
        # Bound once: a subtree family's support rows, which G3 reads.
        self.glob_fam = {tag: GlobFamily.of(grp, dev, dt, pos=self.glob.pos)
                         for tag, grp in self.plan.glob_groups.items()}
        # The fiber node-slide's colour classes on the device (F1's plan).
        self.fiber_classes = []
        if self.fiber_slide_p > 0:
            T = sum(model.term_block_sizes)
            self.fiber_classes = [FiberClass.of(c, T, dev) for c in fiber_slide_plan(model)]
        # The precision rows P[S] of each subtree that a sub_ultra or
        # sub_rate ticket scales, gathered once (the two families share
        # their subtrees): at 1000 taxa (synthetic.build) 13 subtrees of
        # 7,861 rows in all, 63 MB in float32 beside P's 16 MB.  Under the
        # banded kind, instead, the output blocks of each ticket's product.
        self.glob_prows = {}
        self.glob_win = {}
        if self.banded:
            for tag in SUBTREE_DENSE & set(self.glob_fam):
                grp = self.plan.glob_groups[tag]
                self.glob_win[tag] = [self._block_window(self.glob.support(lo, hi))
                                      for lo, hi in zip(grp.lo.tolist(), grp.hi.tolist())]
        elif self.use_lik:
            for tag in SUBTREE_DENSE & set(self.glob_fam):
                grp = self.plan.glob_groups[tag]
                for lo, hi in zip(grp.lo.tolist(), grp.hi.tolist()):
                    if lo not in self.glob_prows:
                        rows = torch.as_tensor(self.glob.support(lo, hi), device=dev)
                        self.glob_prows[lo] = self.P.index_select(0, rows)

    def _range_rows(self, sx: dict):
        """The distance rows of a likelihood range block, ``d_flat`` ``[S
        RB]`` (0 on pad rows), and with a likelihood the block's precision
        rows ``Prow = P[d_flat]`` ``[S RB, D]`` and ``Q = Prow[:, d_flat]``
        (zero on pad rows and columns).  They depend on the plan alone, so
        each block gathers them once, here: the 452 blocks of the synthetic
        1000-taxon model hold 0.59 GB of ``Q`` and 1.86 GB of ``Prow`` in
        float32 (trimmed to their rows), against 16 MB for ``P``.  ``Q`` is
        kept in :func:`~..kernels.range_scan.kernel_layout`.  Under the
        banded kind ``Q`` comes from the band and there is no ``Prow``: the
        block's ``z`` update is a band product (:meth:`_z_add`).  Also the
        block's row plan for K5's prologue and epilogue kernels (``rplan``,
        ``tplan``: :func:`~..kernels.range_step.range_plan`)."""
        own_ok = sx["own"] >= 0
        sx["d_flat"] = torch.where(own_ok, self.pos_t[torch.clamp(sx["own"], min=0)],
                                   0).reshape(-1).contiguous()
        sx["rplan"], sx["tplan"] = range_plan(sx)
        if self.use_lik:
            ok = own_ok.reshape(-1).to(self.model.dtype)
            if self.banded:
                self._band_rows(sx, ok)
                sx["Q"] = kernel_layout(self._prec_sub(sx["d_flat"]) * ok[:, None] * ok[None, :])
                return
            prow = self.P[sx["d_flat"]] * ok[:, None]
            sx["Prow"] = prow
            sx["Q"] = kernel_layout(prow[:, sx["d_flat"]] * ok[None, :])

    def _point_rows(self, sx: dict):
        """The distance rows of a likelihood point step, ``d_flat`` ``[B KD]``
        (0 on pad rows), and with a likelihood the step's precision rows
        ``Prow = P[d_flat]`` ``[B KD, D]`` and ``Pblk = Prow[:, d_flat]``
        ``[B KD, B KD]`` (zero on pad rows and columns; its rows on a
        16-byte pitch for K4), gathered once, as :meth:`_range_rows` does
        for the range blocks.  Also the step's plan records for K4's
        prologue kernel (``kplan``: :func:`~..kernels.point_step.point_plan`)."""
        d_ok = sx["d_rows"] >= 0
        sx["d_flat"] = torch.clamp(sx["d_rows"], min=0).reshape(-1).contiguous()
        sx["kplan"] = point_plan(sx, self.pos_t, self.is_leaf_t)
        if self.use_lik:
            ok = d_ok.reshape(-1).to(self.model.dtype)
            if self.banded:
                self._band_rows(sx, ok)
                sx["Pblk"] = pitched(self._prec_sub(sx["d_flat"]) * ok[:, None] * ok[None, :])
                return
            prow = self.P[sx["d_flat"]] * ok[:, None]
            sx["Prow"] = prow
            sx["Pblk"] = pitched(prow[:, sx["d_flat"]] * ok[None, :])

    # -- the banded kind's gathers and windows ---------------------------

    def _prec_sub(self, rows):
        """``P[rows][:, rows]`` from the precision's band (banded kind):
        ``P[a, b] = pband[min(a, b), |a - b|]`` within the bandwidth, 0
        outside."""
        a, b = rows.long()[:, None], rows.long()[None, :]
        off = (b - a).abs()
        w = self.pband.shape[1] - 1
        return torch.where(off <= w, self.pband[torch.minimum(a, b), off.clamp(max=w)], 0.0)

    def _block_window(self, rows, upper=False) -> tuple:
        """The output blocks a band product can move from an input that is
        zero off ``rows`` (host ints): :func:`~..ops.banded.block_window`."""
        rows = np.asarray(rows)
        if not len(rows):
            return (0, 0)
        return banded.block_window(int(rows.min()), int(rows.max()) + 1, self.wb, self.nb,
                                   upper)

    def _band_rows(self, sx: dict, ok):
        """A banded step's ``z`` update data: its rows as int64
        (``d_flat64``, for the scatter buffer's reset) and the output blocks
        its rows reach (``zwin``)."""
        sx["d_flat64"] = sx["d_flat"].long()
        sx["zwin"] = self._block_window(sx["d_flat"][ok > 0].cpu().numpy())

    def _z_add(self, z, dacc, sx: dict):
        """``z += dacc @ P[d_flat]`` of a point step or range block: one
        product with the step's precision rows, or under the banded kind
        ``dacc`` scattered to its rows (pad rows add zero) and one B1
        product added to ``z`` on the blocks they reach."""
        if not self.banded:
            z.addmm_(dacc, sx["Prow"])
            return
        buf = self._scatter.get(z.shape)
        if buf is None:
            buf = self._scatter[z.shape] = torch.zeros_like(z)
        buf.index_add_(1, sx["d_flat"], dacc)
        band_matmul(buf, self.P3, window=sx["zwin"], into=z)
        buf.index_fill_(1, sx["d_flat64"], 0.0)

    # -- precision/Cholesky right-multiplications -----------------------

    def _x_P(self, X):
        """``X @ P_internal`` (B1 under the banded kind)."""
        if self.banded:
            return band_matmul(X.contiguous(), self.P3)[0]
        return X @ self.P

    def _x_Lt(self, X):
        """``X @ L.T`` with ``P_internal = L L'`` (B2 under the banded kind)."""
        if self.banded:
            return band_matmul_t(X.contiguous(), self.L3, upper=True)[0]
        return X @ self.L.T

    # -- carried-quantity conversions ----------------------------------

    def _zq_from_y(self, y):
        if not self.use_lik:
            return y.new_zeros((y.shape[0], 0)), y.new_zeros(y.shape[0])
        return self._x_Lt(y), torch.sum(y * y, dim=-1)

    def _y_from_d(self, d):
        """Whitened residual ``(d - mu) L``: kernel K2 for the full kind, B1
        for the banded one, elementwise for the univariate one."""
        m = self.model
        if not self.use_lik:
            return d.new_zeros((d.shape[0], 0))
        if self.banded:
            return band_matmul(d, self.L3, sub=self.mu, upper=True)[0]
        if m.likelihood.kind == mvn.UNIVARIATE:
            return (d - m.mu_internal_t) * m.inv_sd_internal_t
        y, _ = whiten(d, m.chol_internal_t, sub=m.mu_internal_t)
        return y

    # -- global-move families ------------------------------------------

    def glob_step(self, tag: str, carry: FastCarry, tune, sx: dict, draw, u_acc):
        """One ticket of the global-move family ``tag`` on every chain (the
        one-ticket plain step, in place; accepts are not counted).

        ``sx`` holds the ticket's host values (``sd``, ``aux``, ``lo``,
        ``hi``, ``n_inner``, ``n_nodes``, ``rj``), ``tune`` its tuning
        ``[C]``, ``draw`` the kernel's standard-gamma variate or uniform
        ``[C]`` and ``u_acc`` the accept uniforms ``[C]``.  The ratio takes
        only the term blocks the move can change (from one evaluation of the
        proposed state); ``d/z/q`` are updated in closed
        form (uniform distance scalings), not at all (distance-invariant
        moves) or through one ``delta @ P`` product.  Returns the accept
        mask."""
        return glob_ticket_plain(self.glob, tag, carry, tune, sx, draw, u_acc).accept

    def glob_family_plain(self, tag: str, carry: FastCarry, tun, draws, u_acc, given=None):
        """The plain scan of family ``tag``: :meth:`glob_step` over its
        tickets in order, each counted in ``carry.acc``; ``tun``, ``draws``
        and ``u_acc`` are ``[C, n]``.  Returns a
        :class:`~..kernels.glob_step.GlobOut` ``[C, n]`` (see
        :func:`~..kernels.glob_step.glob_family_plain` for ``given``)."""
        return glob_family_plain(self.glob, self.glob_fam[tag], carry, tun, draws, u_acc, given)

    def glob_product(self, fam, s: int, pro):
        """``w = delta @ P`` of ticket ``s`` of dense family ``fam`` (None
        without a likelihood): ``delta_S @ P[S]`` over a subtree ticket's
        support rows, where ``delta`` is zero elsewhere; under the banded
        kind B1 over the blocks those rows reach (zero elsewhere)."""
        if not self.use_lik:
            return None
        if pro.delta_s is None:
            return self._x_P(pro.delta)
        if self.banded:
            return band_matmul(pro.delta, self.P3, window=self.glob_win[fam.tag][s])[0]
        return pro.delta_s @ self.glob_prows[int(fam.grp.lo[s])]

    # -- point mega-steps -------------------------------------------------

    def contra_slide_step(self, carry: FastCarry, tuning, sx: dict, u_prop, u_acc):
        """One mega-step of distance-invariant contrary node slides
        (slideNodesAtContrarily), all tickets at once: kernel K6.  Returns
        the ``[C, B]`` accept mask."""
        m = self.model
        return contra_slide(carry.batch, carry.terms, carry.acc, tuning, sx, m.topo.is_leaf_t,
                            m.clock, u_prop, u_acc, carry.beta_prior).accept

    def point_lik_step(self, kind: int, carry: FastCarry, tuning, sx: dict, draw, u_acc):
        """One mega-step of likelihood-coupled node slides or branch-rate
        scales, with the exact sequential-correction accept scan: the
        prologue kernel draws the proposals and evaluates their terms and
        distance deltas, K4 (``point_scan``) runs the accept scan, the
        epilogue kernel writes the accepted tickets back, and one product
        updates ``z`` (:meth:`_z_add`).  ``Pblk`` and ``Prow`` are the
        step's own (built with the plan).  Without a likelihood the prologue
        and the epilogue run alone, the epilogue taking the decisions.  ``draw`` is the
        truncated-normal uniform or standard-gamma variate ``[C, B]``.
        Returns the ``[C, B]`` accept mask."""
        m = self.model
        branch = kind == P.K_SCALE_BRANCH_RATE
        args = (branch, carry.batch, carry.terms, carry.d)
        if not self.use_lik:
            pro = point_lik_prologue(*args, None, tuning, sx, self.is_leaf_t, self.pos_t, m.clock,
                                     draw)
            return point_lik_epilogue(*args, carry.q, carry.acc, sx, pro, None, None, u_acc,
                                      carry.beta_prior)[0]
        pro = point_lik_prologue(*args, carry.z, tuning, sx, self.is_leaf_t, self.pos_t, m.clock,
                                 draw)
        accept, dq = point_scan(pro.delta, pro.zG, sx["Pblk"], pro.d_pr, pro.lmhg, u_acc,
                                carry.beta, carry.beta_prior)
        accept, dacc = point_lik_epilogue(*args, carry.q, carry.acc, sx, pro, accept, dq)
        self._z_add(carry.z, dacc, sx)
        return accept

    # -- subtree-range blocks ---------------------------------------------

    def range_contra_step(self, carry: FastCarry, tuning, sx: dict, u_prop, u_acc,
                          u_bold=None):
        """One block of distance-invariant contrary subtree scales
        (scaleSubTreesAtContrarily), all tickets at once: kernel K6's range
        mode, with the bold mixture's uniforms ``u_bold`` ``[C, S]`` (None:
        off).  Returns the ``[C, S]`` accept mask."""
        m = self.model
        return contra_range(carry.batch, carry.terms, carry.acc, tuning, sx, m.topo.is_leaf_t,
                            m.clock, u_prop, u_acc, carry.beta_prior,
                            **self._bold_args(u_bold)).accept

    def _bold_args(self, u_bold) -> dict:
        """The bold mixture's arguments of K6's range mode and G1 (none
        without its uniforms)."""
        if u_bold is None:
            return {}
        return dict(u_bold=u_bold, bold_p=self.bold_p, bold_factor=self.bold_factor)

    def range_lik_step(self, kind: int, carry: FastCarry, tuning, sx: dict, draw, u_acc):
        """One block of likelihood-coupled subtree scales, ultrametric
        (Ultrametric.hs:126-188) or rate (Unconstrained.hs:95-137).  Each
        ticket's distance delta is rank-1, ``delta_b = (f_b - 1) g_b``: the
        prologue kernel draws the proposals and evaluates their terms, K5
        (``range_scan``) forms the Gram blocks ``g_a' Q_ab g_b`` and runs the
        accept scan, the epilogue kernel writes the accepted tickets back,
        and one product updates ``z`` (:meth:`_z_add`).  ``Q`` and ``Prow``
        are the block's own (built with the plan).  Without a likelihood the
        prologue and the epilogue run alone, the epilogue taking the
        decisions.  On the
        card both kernels write into the block's (kind, row bucket)
        :class:`~..kernels.range_step.RangeWork` (``sx["work"]``).  Returns
        the ``[C, S]`` accept mask; on the card, without a likelihood, it
        is that work's buffer, valid until the bucket's next block."""
        m = self.model
        rate = kind == P.K_SCALE_SUBTREE_RATE
        args = (rate, carry.batch, carry.terms, carry.d)
        if not self.use_lik:
            pro = range_lik_prologue(*args, None, tuning, sx, m.topo.is_leaf_t, m.clock, draw)
            return range_lik_epilogue(*args, carry.q, carry.acc, sx, pro, None, None, u_acc,
                                      carry.beta_prior)[0]
        pro = range_lik_prologue(*args, carry.z, tuning, sx, m.topo.is_leaf_t, m.clock, draw)
        accept, dq = range_scan(pro.g, pro.zg, sx["Q"], pro.coef, pro.d_pr, pro.lmhg, u_acc,
                                carry.beta, carry.beta_prior)
        accept, dacc = range_lik_epilogue(*args, carry.q, carry.acc, sx, pro, accept, dq)
        self._z_add(carry.z, dacc, sx)
        return accept

    # -- the sweep -----------------------------------------------------

    def init_carry(self, batch: State) -> FastCarry:
        """Carried quantities of a fresh batch (a copy: sweeps update it in
        place); ``z``/``q`` are filled at the start of each batched phase."""
        m = self.model
        batch = State(**{k: getattr(batch, k).clone() for k in FIELDS})
        C = batch.n_chains
        z = batch.heights.new_zeros((C, self.dim if self.use_lik else 0))
        acc = torch.zeros((C, self.table.n_proposals), dtype=torch.int32,
                          device=batch.heights.device)
        return FastCarry(batch, m.log_prior_terms(batch), distances_internal(batch, m.topo), z,
                         batch.height.new_zeros(C), acc)

    def sweep_once(self, carry: FastCarry, y, tuning, host_gen, gen, slide_acc=None):
        """One sweep of every phase on ``carry`` (in place) with the
        whitened residual ``y`` at its start; returns ``y`` at its end.  With
        ``fiber_slide``, the fiber phase adds its accepts to ``slide_acc``
        (an int32 ``[1]``, or None), which is set to -1 where its coin
        skipped it."""
        self.seq_phase(carry, y, tuning, host_gen, gen)
        carry.z, carry.q = self._zq_from_y(y)
        self.glob_phase(carry, tuning, gen)
        self.point_phase(carry, tuning, gen)
        self.range_phase(carry, tuning, gen)
        y = self._y_from_d(carry.d)
        if self.fiber_slide_p > 0:
            ran = self.fiber_phase(carry, gen, host_gen, slide_acc)
            if not ran and slide_acc is not None:
                slide_acc.fill_(-1)
        return y

    @staticmethod
    def _rand(carry: FastCarry, gen, *shape):
        return torch.rand(shape, generator=gen, dtype=carry.d.dtype, device=carry.d.device)

    def seq_phase(self, carry: FastCarry, y, tuning, host_gen, gen):
        """The tickets the planner cannot batch, through the sequential
        kernel in a host-drawn order (``y`` carry, updated in place)."""
        plan = self.plan
        if not len(plan.seq_table.tickets):
            return
        m = self.model
        C, dev = carry.d.shape[0], carry.d.device
        rows_t = torch.as_tensor(plan.seq_rows.astype(np.int64), device=dev)
        seq = Carry(carry.batch, carry.terms, carry.d if self.use_lik else None,
                    y if self.use_lik else None,
                    torch.zeros((C, plan.seq_table.n_proposals), dtype=torch.int32, device=dev),
                    beta=carry.beta, beta_prior=carry.beta_prior)
        self.seq_kern.sweep_once(seq, tuning[:, rows_t], host_gen, gen)
        carry.acc.index_add_(1, rows_t, seq.acc)
        if not self.use_lik:
            carry.d.copy_(distances_internal(carry.batch, m.topo))

    def glob_phase(self, carry: FastCarry, tuning, gen):
        """The global-move families in :data:`GLOB_ORDER`.  A family's draws
        come first, ``[C, n]`` in one or two generator calls (a sweep does
        not change the tuning; with the bold mixture on, sub_contra's bold
        uniforms in a third): kernel G1 then walks the whole family, or
        each ticket of a dense family takes G2, ``delta @ P`` (over a
        subtree ticket's support rows, :meth:`glob_product`) and G3."""
        C = carry.d.shape[0]
        for tag, fam in self.glob_fam.items():
            tun = tuning.index_select(1, fam.rows)
            if tag in GAMMA_TAGS:
                draws = standard_gamma(fam.sd / tun, gen)
            else:
                draws = self._rand(carry, gen, C, fam.n)
            u_acc = self._rand(carry, gen, C, fam.n)
            if FAMILIES[tag].lik != DENSE:
                u_bold = (self._rand(carry, gen, C, fam.n)
                          if tag == "sub_contra" and self.bold_p > 0 else None)
                glob_scan(self.glob, fam, carry, tun, draws, u_acc, **self._bold_args(u_bold))
                continue
            nbad = None
            for s in range(fam.n):
                pro = glob_dense_prologue(self.glob, fam, s, carry, tun, draws, nbad)
                nbad = pro.nbad
                glob_dense_epilogue(self.glob, fam, s, carry, pro,
                                    self.glob_product(fam, s, pro), u_acc)

    def point_phase(self, carry: FastCarry, tuning, gen):
        """The point mega-steps: contrary slides (K6), then the
        likelihood-coupled slides and branch-rate scales (K4)."""
        C = carry.d.shape[0]
        for k, steps in self.spec_t.items():
            if k == P.K_SCALE_BRANCH_RATE:
                rows, sd = self.point_gamma[k]
                shape = sd / tuning.index_select(1, rows)
            off = 0
            for sx in steps:
                B = sx["rows"].shape[0]
                if k == P.K_SLIDE_NODES_CONTRA:
                    self.contra_slide_step(carry, tuning, sx, self._rand(carry, gen, C, B),
                                           self._rand(carry, gen, C, B))
                    continue
                if k == P.K_SCALE_BRANCH_RATE:
                    draw = standard_gamma(shape[:, off:off + B], gen)
                else:
                    draw = self._rand(carry, gen, C, B)
                off += B
                self.point_lik_step(k, carry, tuning, sx, draw, self._rand(carry, gen, C, B))

    def range_phase(self, carry: FastCarry, tuning, gen):
        """The subtree-range blocks in the plan's order: ultrametric and rate
        subtree scales (K5), then contrary subtree scales."""
        C = carry.d.shape[0]
        for key, steps in self.range_t.items():
            k = key[0]
            if k == P.K_SCALE_SUBTREE_RATE:
                rows, sd = self.range_gamma[key]
                shape = sd / tuning.index_select(1, rows)
            off = 0
            for sx in steps:
                S = sx["rows"].shape[0]
                if k == P.K_SCALE_SUBTREES_CONTRA:
                    u_prop, u_acc = self._rand(carry, gen, C, S), self._rand(carry, gen, C, S)
                    u_bold = self._rand(carry, gen, C, S) if self.bold_p > 0 else None
                    self.range_contra_step(carry, tuning, sx, u_prop, u_acc, u_bold)
                    continue
                if k == P.K_SCALE_SUBTREE_RATE:
                    draw = standard_gamma(shape[:, off:off + S], gen)
                else:
                    draw = self._rand(carry, gen, C, S)
                off += S
                self.range_lik_step(k, carry, tuning, sx, draw, self._rand(carry, gen, C, S))

    def fiber_phase(self, carry: FastCarry, gen, host_gen, count=None) -> bool:
        """The fiber node-slide phase (the JAX ``one_sweep``'s,
        ``fast_sweep.py:2278-2292``): with probability ``fiber_slide`` (a
        coin from the host generator, independent of the state), F1 on each
        colour class in turn, each node's height redrawn uniformly between
        its oldest child and its parent (draws ``[C, m]`` in ``[1e-6, 1)``)
        with its stem and child rates rescaled, accepted on the class's owned
        prior terms at the chains' prior temperature.  Every branch distance
        stays, so ``d``, ``z`` and ``q`` do.  The accepts go to ``count``
        (int32 ``[1]``).  Returns whether the phase ran (the JAX package
        runs it and discards it instead: the same distribution)."""
        p = self.fiber_slide_p
        if p < 1 and not bool(torch.rand((), generator=host_gen, dtype=torch.float64) < p):
            return False
        C = carry.d.shape[0]
        for cls in self.fiber_classes:
            u = torch.empty((C, cls.m), dtype=carry.d.dtype, device=carry.d.device)
            u.uniform_(1e-6, 1.0, generator=gen)
            fiber_slide(self.model, carry.batch, carry.terms, cls, u,
                        self._rand(carry, gen, C, cls.m), carry.beta_prior, count)
        return True

    @property
    def fiber_nodes(self) -> int:
        """Nodes the fiber phase moves (every internal non-root node)."""
        return sum(cls.m for cls in self.fiber_classes)

    def lp_of(self, carry: FastCarry, y):
        """Per-chain log prior and log likelihood from the carried terms
        and whitened residual."""
        lp_pr = torch.sum(carry.terms, dim=-1)
        if not self.use_lik:
            return lp_pr, torch.zeros_like(lp_pr)
        return lp_pr, self.model.log_lik_const - 0.5 * torch.sum(y * y, dim=-1)

    def nuts_phase(self, carry: FastCarry, nuts, gen):
        """The in-cycle NUTS move after the batched phases (``nuts`` a
        :class:`~.hmc.NutsInCycle`, every chain at its temperatures), then
        the carried terms (K1) and distances rebuilt from the moved state.
        Returns the acceptance statistics ``[C]``."""
        astat = nuts(carry.batch, gen, beta_lik=carry.beta, beta_prior=carry.beta_prior)
        carry.terms = self.model.log_prior_terms(carry.batch)
        carry.d = distances_internal(carry.batch, self.model.topo)
        return astat

    def sweeps(self, batch: State, tuning, seed: int, n: int,
               collect: Optional[Callable] = None, beta=None, nuts=None, beta_prior=None):
        """Same contract as ``MHKernel.sweeps``: ``n`` sweeps of the chain
        batch, ``seed`` seeding the sequential phase's ticket order (host)
        and every draw (on the batch's device), ``beta`` and ``beta_prior``
        (each a number or ``[C]``, None: 1) tempering the likelihood and the
        prior in every phase's decisions (the JAX ``sweeps``'
        ``beta_prior``, ``engine/fast_sweep.py:2122``).  Returns ``(batch,
        lp_pr, lp_lik, acc, tot, outs)``, and with ``nuts`` (a
        :class:`~.hmc.NutsInCycle`: the in-cycle NUTS move after each
        sweep's batched phases and the fiber phase) the move's acceptance
        statistics ``[n, C]`` after them, and with ``fiber_slide`` the fiber
        phase's acceptance of each sweep ``[n]`` (NaN where its coin skipped
        it) after those, as the JAX ``sweeps`` (``:2319-2330``)."""
        device = batch.heights.device
        host_gen = torch.Generator().manual_seed(seed)
        gen = torch.Generator(device=device).manual_seed(seed)
        carry = self.init_carry(batch)
        carry.beta = chain_beta(beta, batch.n_chains, batch.heights.dtype, device)
        # None stays None: the kernels read a cached ones vector, the plain
        # versions skip the product.
        carry.beta_prior = (None if beta_prior is None else
                            chain_beta(beta_prior, batch.n_chains, batch.heights.dtype, device))
        y = self.model.whitened_residual_internal(carry.batch)
        C = batch.n_chains
        outs, astats = [], []
        slide = self.fiber_slide_p > 0
        slide_acc = torch.zeros((n, 1), dtype=torch.int32, device=device) if slide else None
        for s in range(n):
            y = self.sweep_once(carry, y, tuning, host_gen, gen, slide_acc[s] if slide else None)
            if nuts is not None:
                astats.append(self.nuts_phase(carry, nuts, gen))
                y = self._y_from_d(carry.d)
            if collect is not None:
                outs.append(collect(carry.batch, *self.lp_of(carry, y)))
        tot = (torch.as_tensor(self.table.weight, dtype=torch.int32, device=device) * n
               ).expand(C, -1)
        ret = (carry.batch, *self.lp_of(carry, y), carry.acc, tot, outs)
        if nuts is not None:
            ret = ret + (torch.stack(astats),)
        if slide:
            k = slide_acc[:, 0]
            ret = ret + (torch.where(k >= 0, k.double() / max(C * self.fiber_nodes, 1),
                                     math.nan),)
        return ret
