"""The sequential sweep's ticket kernels: T1 ``ticket_prologue`` and T3
``ticket_scan`` (with K3 ``accept_select``, the ticket epilogue, in
``accept_select.py``).

They replace the XLA-compiled ``MHKernel._ticket_step`` of the JAX package
(``mcmcdate_tpu/engine/mh.py:52-210``: the 17 proposal kernels ``_k_*`` and
``make_kernel_switch`` of ``engine/proposals.py:388-706``, the prior terms,
distances and root-branch Jacobian of a ticket) and the scan of a sweep's
tickets (``lax.scan(step, c, perm)``, ``engine/mh.py:269-271``).  A ticket
runs one proposal row on every chain; the chains are independent, and a
chain's tickets are serial (each proposes from the state the one before
left), so every kernel runs one CTA per chain.

- ``ticket_prologue`` (kernel ``ticket_prologue_kernel``): one ticket from
  its injected draw (a uniform, or a standard gamma of shape
  ``par / tune``): the proposal, written into the carried state in place
  with the old values kept in scratch; the prior terms the row can change
  (:meth:`TicketTable.tix`: whole term blocks for the global moves, the
  touched nodes' birth-death, clock and node-prior entries for the local
  ones, so a local ticket costs O(1) and not K1's O(N)); ``d_pr`` under
  ``sum_valid``'s NaN rule; the JAX package's invalid rule over the whole
  new term vector, from the carried count of bad terms (``nbad``: a
  chain whose untouched carried term is NaN or -inf rejects); ``lmhg``;
  ``lj``, the root-branch Jacobian ratio of ``root_jac`` rows; and the new
  distances ``d_new`` and ``delta = d_new - d`` on the row's likelihood
  class rows (:meth:`TicketTable.rows`).
- K3 ``accept_select`` takes the likelihood delta (K2's under a full MVN,
  ``delta * inv_sd`` on the class rows under the univariate kind), decides
  and writes back only what the ticket touched, or restores the old
  values.
- ``ticket_scan`` (kernel ``ticket_scan_kernel``): a run of consecutive
  tickets in one launch, each chain's CTA applying the prologue's, the
  likelihood's and K3's device functions ticket after ticket.  A run holds
  every ticket whose likelihood update is local: all of them with no
  likelihood or under the univariate kind, and under a full MVN the
  ``DC_INV`` and ``DC_GATHER`` tickets (``dy = delta[rows] @ L[rows, :]``,
  at most KG rows of ``L``).  A full-MVN ``DC_FULL`` or ``DC_B*`` ticket
  goes T1, K2, K3 (:meth:`TicketTable.breaks`).

Every wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors (float32), or raises; it counts its launches in
``<wrapper>.launches``.  The plain versions evaluate a proposal with the
port's ``_k_*`` kernels and its terms with ``DatingModel.log_prior_terms``
(kernel K1 on the card), whose device code the kernels share
(``csrc/prior_terms.cuh``); the kernels' proposals come from G2's
``propose`` (``csrc/glob_moves.cuh``) and the slides', the pulley's and
the braced slides' device code in ``csrc/ticket_step.cuh``, with CUDA's
normal CDF and its inverse, so a truncated-normal proposal may differ from
PyTorch's in its last bits: the plain versions take ``given`` proposals so
that a check can replay the kernels' own.

On the H100 a local ticket is bound by latency: a chain walks its tickets
one after the other, a few dependent loads, a truncated-normal or gamma
proposal and a few double-precision birth-death terms each; a global one
by its O(N) term blocks.  See ``csrc/ticket_step.cuh``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..engine import proposals as props
from ..models.state import FIELDS
from ..ops import clocks, mvn
from ..ops.heights import distances_internal, log_jacobian_root_branch
from ..ops.local_terms import is_bad, sum_valid
from . import build
from .glob_step import FAMILIES

# Proposal modes of the kernels: G2's families in glob_step.FAMILIES' order,
# then the moves of this file's own device code.
_G = {tag: i for i, tag in enumerate(FAMILIES)}
SLIDE_ULTRA, SLIDE_CONTRA, PULLEY, BRACED_ULTRA, BRACED_CONTRA = range(len(_G), len(_G) + 5)
# Likelihood kinds.
LIK_NONE, LIK_DIAG, LIK_FULL = range(3)
# State fields a row changes (the glob kernels' bits), and the node-local
# variants: heights or rates at the row's node set only.
F_HEIGHTS, F_RATES, F_BIRTH, F_DEATH, F_HEIGHT, F_RATE_MEAN, F_RATE_VAR = (1, 2, 4, 8, 16, 32,
                                                                           64)
F_HLOC, F_RLOC = 128, 256
# Term blocks: scalars, birth-death, clock, node priors.
B_SC, B_BD, B_CK, B_ND = 1, 2, 4, 8
CHUNK = 16384  # tickets whose draws are made at once
BRACE_MAX = 16  # nodes a brace may hold (kBraceMax of csrc/ticket_step.cuh)
# A ticket whose work (terms evaluated, nodes written, distance rows) passes
# this runs in a T3 launch of its own: inside one run, such tickets made a
# 16,384-ticket chunk at 10,000 taxa take twice as long as its light and
# heavy tickets apart (PERF.md; ``tools/seq_time.py --chunk``).
HEAVY = 2000


def _kind_row(kind: int, aux: int) -> tuple:
    """``(mode, fields, local)`` of a proposal kind: the kernels' proposal
    mode, the state fields it changes and whether its terms are node-local
    (else whole blocks)."""
    P = props
    if kind == P.K_SCALE_SCALAR:
        if aux == P.SC_RATE_MEAN:
            return _G["rate_mean"], F_RATE_MEAN, False
        if aux == P.SC_RATE_VAR:
            return _G["rate_var"], F_RATE_VAR, False
        if aux == P.SC_HEIGHT:
            return _G["height"], F_HEIGHT, False
        f = {P.SC_BIRTH: F_BIRTH, P.SC_DEATH: F_DEATH}.get(aux, F_BIRTH | F_DEATH)
        return _G["bd_scale"], f, False
    return {
        P.K_SCALE_HEIGHT_RATEMEAN_CONTRA: (_G["hm_contra"], F_HEIGHT | F_RATE_MEAN, False),
        P.K_SLIDE_NODE_ULTRA: (SLIDE_ULTRA, F_HLOC, True),
        P.K_SCALE_SUBTREE_ULTRA: (_G["sub_ultra"], F_HLOC, True),
        P.K_PULLEY_ULTRA: (PULLEY, F_HEIGHTS, False),
        P.K_SCALE_BRANCH_RATE: (_G["sub_rate"], F_RLOC, True),
        P.K_SCALE_SUBTREE_RATE: (_G["sub_rate"], F_RLOC, True),
        P.K_SCALE_NORM_RATE_TREE_CONTRA: (_G["norm_contra"], F_RATE_MEAN | F_RATES, False),
        P.K_SCALE_VAR_RATE_TREE: (_G["var_tree"], F_RATE_VAR | F_RATES, False),
        P.K_SCALE_VAR_RATE_TREE_AUTOCORR: (_G["var_auto"], F_RATE_VAR | F_RATES, False),
        P.K_SLIDE_NODES_CONTRA: (SLIDE_CONTRA, F_HLOC | F_RLOC, True),
        P.K_SCALE_SUBTREES_CONTRA: (_G["sub_contra"], F_HLOC | F_RLOC, True),
        P.K_SLIDE_ROOT_CONTRA: (_G["slide_root"], F_HEIGHT | F_HEIGHTS | F_RATES, False),
        P.K_SCALE_NORM_HEIGHT_RATE_TREE_CONTRA: (_G["normh_contra"], F_HEIGHT | F_RATES, False),
        P.K_SCALE_RATES_TIME_TREE_CONTRA: (_G["rates_time"], F_HEIGHTS | F_BIRTH | F_RATE_MEAN,
                                           False),
        P.K_SLIDE_BRACED_ULTRA: (BRACED_ULTRA, F_HLOC, True),
        P.K_SLIDE_BRACED_CONTRA: (BRACED_CONTRA, F_HLOC | F_RLOC, True),
    }[kind]


class TicketTable:
    """The proposal table as the ticket kernels read it, built once per
    ``MHKernel``: per row the kernels' proposal mode and its integer
    parameters, the state fields it changes, the term blocks it changes
    whole (``tblocks``) and, for the node-local kinds, the explicit term
    entries (``t_off``/``t_idx``, CSR) and the node set whose heights or
    rates it writes (``n_off``/``n_idx``); the likelihood class of every
    row; and the same on the model's device (``dev``)."""

    def __init__(self, model, table: props.ProposalTable):
        self.model = model
        self.table = table
        topo = model.topo
        N, Pn = topo.n, table.n_proposals
        kind = model.likelihood.kind
        if kind in (mvn.SPARSE, mvn.BANDED):
            raise NotImplementedError(mvn.NOT_PORTED.format(kind))
        self.lik = {mvn.NONE: LIK_NONE, mvn.UNIVARIATE: LIK_DIAG}.get(kind, LIK_FULL)
        self.D = model.likelihood.dim if self.lik else 0
        self.N = N
        self.T = sum(model.term_block_sizes)
        self.d_class = (np.full(Pn, props.DC_FULL, np.int32) if table.d_class is None
                        else np.asarray(table.d_class, np.int32))
        self.d_lo = (np.ones(Pn, np.int32) if table.d_lo is None
                     else np.asarray(table.d_lo, np.int32))
        self.didx = (np.full((Pn, 1), self.D, np.int32) if table.didx is None
                     else np.asarray(table.didx, np.int32))
        self.gamma = np.isin(table.kind, sorted(props.GAMMA_KINDS))

        off_bd, off_ck = 4, 4 + N + 1
        off_nd = off_ck + N + 1
        cal, con, br = model.calibrations, model.constraints, model.braces
        if br.n and np.asarray(br.node).shape[1] > BRACE_MAX:
            raise ValueError(f"the ticket kernels take braces of at most {BRACE_MAX} nodes")
        # The nodes each node-prior term reads.
        nd_nodes = ([[int(x)] for x in np.asarray(cal.node).reshape(-1)[:cal.n]]
                    + [[int(y), int(o)] for y, o in zip(np.asarray(con.young)[:con.n],
                                                       np.asarray(con.old)[:con.n])]
                    + [[int(x) for x in row if x >= 0] for row in np.asarray(br.node)[:br.n]])
        ch = np.asarray(topo.children)
        end = np.asarray(topo.subtree_end)
        n_in = np.asarray(topo.n_inner_subtree)
        n_all = np.asarray(topo.n_nodes_subtree)

        def kids(i):
            return [int(c) for c in ch[i] if c >= 0]

        cols = {k: np.zeros(Pn, np.int32) for k in ("mode", "fields", "tblocks", "aux", "lo", "hi",
                                                      "n_inner", "n_nodes", "lo2", "hi2", "n2")}
        cols["node"] = np.asarray(table.node, np.int32)
        t_lists, n_lists = [], []
        for p in range(Pn):
            k, node, aux = int(table.kind[p]), int(table.node[p]), int(table.aux[p])
            mode, fields, local = _kind_row(k, aux)
            pc = props.PC_ALL if table.prior_class is None else int(table.prior_class[p])
            sc, bd, ck, nd = props.PC_BLOCKS[pc]
            if table.prior_class is None:
                local = False
            lo = hi = n_inner = n_nodes = lo2 = hi2 = n2 = 0
            nodes, moved = [], []  # the node set; the nodes whose heights move
            if k in (props.K_SLIDE_NODE_ULTRA, props.K_SLIDE_NODES_CONTRA):
                nodes, moved = [node] + kids(node), [node]
            elif k in (props.K_SCALE_SUBTREE_ULTRA, props.K_SCALE_SUBTREES_CONTRA,
                       props.K_SCALE_SUBTREE_RATE, props.K_SCALE_BRANCH_RATE):
                lo = node
                hi = node + 1 if k == props.K_SCALE_BRANCH_RATE else int(end[node])
                n_inner = int(n_in[node])
                n_nodes = 1 if k == props.K_SCALE_BRANCH_RATE else int(n_all[node])
                nodes = list(range(lo, hi))
                moved = [] if k in (props.K_SCALE_SUBTREE_RATE, props.K_SCALE_BRANCH_RATE) \
                    else nodes
            elif k in (props.K_SLIDE_BRACED_ULTRA, props.K_SLIDE_BRACED_CONTRA):
                moved = [int(x) for x in np.asarray(br.node)[aux] if x >= 0]
                nodes = sorted(set(moved) | {c for x in moved for c in kids(x)})
            elif k == props.K_PULLEY_ULTRA:
                l, r = topo.root_children
                lo, hi, n_inner = l, int(end[l]), int(n_in[l])
                lo2, hi2, n2 = r, int(end[r]), int(n_in[r])
            if k in (props.K_SCALE_SUBTREE_ULTRA, props.K_SCALE_SUBTREES_CONTRA):
                aux = node
            tb = 0
            t_loc = []
            if local:
                na = np.asarray(nodes, np.int64)
                if bd:
                    t_loc.append(off_bd + na)
                if ck:
                    t_loc.append(off_ck + na)
                if nd and moved:
                    mv = set(moved)
                    t_loc.append(np.asarray([off_nd + q for q, xs in enumerate(nd_nodes)
                                             if mv.intersection(xs)], np.int64))
            else:
                tb = (B_SC if sc else 0) | (B_BD if bd else 0) | (B_CK if ck else 0) \
                    | (B_ND if nd else 0)
                nodes = []
            t_lists.append(np.concatenate(t_loc) if t_loc else np.zeros(0, np.int64))
            n_lists.append(np.asarray(nodes, np.int64))
            for key, v in (("mode", mode), ("fields", fields), ("tblocks", tb), ("aux", aux),
                           ("lo", lo), ("hi", hi), ("n_inner", n_inner), ("n_nodes", n_nodes),
                           ("lo2", lo2), ("hi2", hi2), ("n2", n2)):
                cols[key][p] = v
        self.cols = cols
        self.t_off = np.concatenate([[0], np.cumsum([len(x) for x in t_lists])]).astype(np.int32)
        self.t_idx = (np.concatenate(t_lists) if t_lists else np.zeros(0)).astype(np.int32)
        self.n_off = np.concatenate([[0], np.cumsum([len(x) for x in n_lists])]).astype(np.int32)
        self.n_idx = (np.concatenate(n_lists) if n_lists else np.zeros(0)).astype(np.int32)
        self.blocks = [(0, 4, B_SC), (off_bd, off_ck, B_BD), (off_ck, off_nd, B_CK),
                       (off_nd, self.T, B_ND)]
        tb, fl = cols["tblocks"], cols["fields"]
        n_rows = np.select([self.d_class == props.DC_FULL, self.d_class == props.DC_GATHER]
                           + [self.d_class == dc for dc in props.D_BUCKETS],
                           [self.D, self.didx.shape[1]]
                           + [1 + b for b in props.D_BUCKETS.values()], 0)
        self.work = (sum(((tb & bit) > 0) * (b - a) for a, b, bit in self.blocks)
                     + np.diff(self.t_off) + N * ((fl & (F_HEIGHTS | F_RATES)) > 0)
                     + np.diff(self.n_off) + (n_rows if self.lik else 0))
        self._tix, self._rows = {}, {}

    # -- per-row index sets (host, cached as device tensors) -------------

    def tix(self, p: int) -> torch.Tensor:
        """The term entries row ``p`` can change (int64, on the model's
        device): its whole blocks, then its explicit entries."""
        if p not in self._tix:
            tb = int(self.cols["tblocks"][p])
            parts = [np.arange(a, b) for a, b, bit in self.blocks if tb & bit]
            parts.append(self.t_idx[self.t_off[p]:self.t_off[p + 1]])
            self._tix[p] = torch.as_tensor(np.concatenate(parts).astype(np.int64),
                                           device=self.model.device)
        return self._tix[p]

    def rows(self, p: int) -> Optional[torch.Tensor]:
        """The distance rows of row ``p``'s likelihood class (int64 on the
        model's device; None: every row; empty for ``DC_INV`` or without a
        likelihood)."""
        if p not in self._rows:
            dc, D = int(self.d_class[p]), self.D
            if not self.lik or dc == props.DC_INV:
                r = np.zeros(0, np.int64)
            elif dc == props.DC_FULL:
                r = None
            elif dc == props.DC_GATHER:
                r = self.didx[p][self.didx[p] < D]
            else:
                lo = int(self.d_lo[p])
                r = np.asarray([0] + list(range(lo, min(lo + props.D_BUCKETS[dc], D))))
            self._rows[p] = None if r is None else torch.as_tensor(
                r.astype(np.int64), device=self.model.device)
        return self._rows[p]

    def breaks(self, p: int) -> bool:
        """Whether row ``p`` leaves a run: a full-MVN ticket whose ``dy``
        takes K2 (``DC_FULL`` and the ranges)."""
        return self.lik == LIK_FULL and int(self.d_class[p]) not in (props.DC_INV,
                                                                     props.DC_GATHER)

    def segments(self, order) -> list:
        """The drawn order ``[n]`` cut into ``(j0, nj, run)``: T3 launches
        (``run`` True), each a maximal run of light tickets that do not
        break or one heavy ticket (``work`` above ``HEAVY``) alone, and each
        breaking ticket alone (T1, K2, K3)."""
        out, j0 = [], 0
        order = np.asarray(order)
        brk = [self.breaks(int(p)) for p in order]
        heavy = self.work[order] > HEAVY
        for j, b in enumerate(brk):
            if b or heavy[j]:
                if j > j0:
                    out.append((j0, j - j0, True))
                out.append((j, 1, not b))
                j0 = j + 1
        if len(brk) > j0:
            out.append((j0, len(brk) - j0, True))
        return out

    @functools.cached_property
    def dev(self) -> dict:
        """The kernels' static arrays on the model's device (int32, uint8,
        float32), the model's prior arrays included."""
        m = self.model
        dv = m.device

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dv)

        ka = m.prior_kernel_arrays
        out = {k: i32(v) for k, v in self.cols.items()}
        t = self.table
        out.update(
            sd=torch.as_tensor(np.asarray(t.par, np.float32), device=dv),
            rj=torch.as_tensor(np.asarray(t.root_jac, np.uint8), device=dv),
            d_class=i32(self.d_class), d_lo=i32(self.d_lo), didx=i32(self.didx),
            t_off=i32(self.t_off), t_idx=i32(self.t_idx), n_off=i32(self.n_off),
            n_idx=i32(self.n_idx), children=i32(m.topo.children),
            root_ch=i32(m.topo.root_children), dist_idx=i32(m.topo.internal_dist_index),
            parent=ka["parent"], is_leaf=ka["is_leaf"],
        )
        if self.lik == LIK_DIAG:
            out["inv_sd"] = m.inv_sd_internal_t.float().contiguous()
        elif self.lik == LIK_FULL:
            out["L"] = m.chol_internal_t.float().contiguous()
        return out


class TicketDraws(NamedTuple):
    """The draws of ``n`` consecutive tickets of the drawn order: the table
    rows ``order_host`` (and on the card as int32, ``order``; None for a
    single ticket), the proposals' draws ``u`` ``[C, n]`` (uniforms, or every
    ticket's draw where ``g`` is None), the gamma tickets' standard-gamma
    draws ``g`` ``[C, ng]`` at the columns ``gidx_host`` ``[n]`` (-1 for a
    uniform ticket; on the card ``gidx``) and the accept uniforms ``u_acc``
    ``[C, n]``."""

    order_host: np.ndarray
    order: Optional[torch.Tensor]
    u: torch.Tensor
    g: Optional[torch.Tensor]
    gidx_host: Optional[np.ndarray]
    gidx: Optional[torch.Tensor]
    u_acc: torch.Tensor

    @property
    def n(self) -> int:
        return len(self.order_host)

    def draw(self, j: int) -> torch.Tensor:
        """Ticket ``j``'s draw ``[C]``."""
        if self.g is None or self.gidx_host[j] < 0:
            return self.u[:, j]
        return self.g[:, int(self.gidx_host[j])]

    @staticmethod
    def single(pidx: int, draw, u_acc) -> "TicketDraws":
        """One ticket of row ``pidx`` with its draws ``[C]``."""
        return TicketDraws(np.asarray([pidx], np.int32), None, draw.reshape(-1, 1).contiguous(),
                           None, None, None, u_acc.reshape(-1, 1).contiguous())


class TicketPro(NamedTuple):
    """What the prologue computes per chain for one ticket.  ``state`` is
    the proposed state (plain version; the kernel writes it into the carry
    in place, None); ``tn`` ``[C, T]`` the new terms, ``d_new`` and
    ``delta`` ``[C, D]``, meaningful at the row's term entries and class
    rows; ``[C]``: ``lmhg``, ``lj``, ``d_pr``, ``invalid``, the proposal
    ``prop`` (the truncated-normal value, the gamma factor, or the braced
    slides' and the pulley's shift), var_tree's rate ``mean`` (None
    elsewhere) and the plain version's ``dx_dp`` (see
    ``proposals.Replay``)."""

    state: Optional[object]
    lmhg: torch.Tensor
    lj: torch.Tensor
    d_pr: torch.Tensor
    invalid: torch.Tensor
    prop: torch.Tensor
    mean: Optional[torch.Tensor]
    tn: torch.Tensor
    d_new: Optional[torch.Tensor]
    delta: Optional[torch.Tensor]
    dx_dp: Optional[torch.Tensor] = None


def count_bad(terms) -> torch.Tensor:
    """Per chain, the number of NaN or -inf terms (int32 ``[C]``)."""
    return (torch.nan_to_num(terms, nan=-math.inf, posinf=0.0, neginf=-math.inf) == -math.inf
            ).sum(-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def ticket_prologue_plain(tt: TicketTable, carry, tuning, pidx: int, draw, given=None,
                          given_mean=None) -> TicketPro:
    """Plain version of :func:`ticket_prologue` for one ticket of row
    ``pidx`` (``draw`` ``[C]``); the carry is read, not changed.  ``given``
    and ``given_mean`` replace the proposal and var_tree's rate mean drawn
    from ``draw`` (see ``proposals.Replay``)."""
    m, t = tt.model, tt.table
    p = int(pidx)
    rep = props.Replay(draw, given, given_mean)
    state_new, lmhg = props.KERNELS[int(t.kind[p])](
        carry.batch, rep, tuning[:, p], int(t.node[p]), int(t.aux[p]), float(t.par[p]), m.topo,
        m.braces)
    tn = m.log_prior_terms(state_new)
    tix = tt.tix(p)
    new, old = tn[:, tix], carry.terms[:, tix]
    d_pr = sum_valid(new - old)
    invalid = (is_bad(new).sum(-1) > 0) | (carry.nbad > is_bad(old).sum(-1))
    d_new = delta = None
    rows = tt.rows(p)
    if rows is None or rows.numel():
        d_new = distances_internal(state_new, m.topo)
        delta = d_new - carry.d
    lj = torch.zeros_like(d_pr)
    if t.root_jac[p]:
        lj = (log_jacobian_root_branch(state_new, m.topo)
              - log_jacobian_root_branch(carry.batch, m.topo))
    return TicketPro(state_new, lmhg, lj, d_pr, invalid, rep.prop, rep.mean, tn, d_new, delta,
                     rep.dx_dp)


def gather_lik_plain(tt: TicketTable, carry, pidx: int, pro: TicketPro):
    """Under a full MVN, a ``DC_GATHER`` ticket's ``(dy, d_lik)``:
    ``dy = delta[rows] @ L[rows, :]``, ``d_lik = -0.5 sum dy (2 y + dy)``
    (what ``ticket_scan`` computes in the chain's CTA)."""
    rows = tt.rows(pidx)
    L = tt.model.chol_internal_t
    dy = pro.delta[:, rows] @ L[rows, :]
    return dy, -0.5 * torch.sum(dy * (2.0 * carry.y + dy), dim=-1)


class ScanOut(NamedTuple):
    """Per chain and ticket of a run ``[C, n]``: the decisions and the
    proposals; the plain version also gives each ticket's log acceptance
    ratio, var_tree's rate means (None elsewhere) and the proposals'
    ``dx_dp`` (0 for gamma tickets)."""

    accept: torch.Tensor
    prop: torch.Tensor
    log_alpha: Optional[torch.Tensor] = None
    mean: Optional[torch.Tensor] = None
    dx_dp: Optional[torch.Tensor] = None


def ticket_scan_plain(tt: TicketTable, carry, tuning, dr: TicketDraws, j0: int, nj: int,
                      given=None) -> ScanOut:
    """Plain version of :func:`ticket_scan`: tickets ``j0 .. j0+nj`` of
    ``dr`` one after the other, each its prologue, its likelihood delta
    (:func:`gather_lik_plain` under a full MVN) and K3's plain epilogue, in
    place.  ``given`` may hold ``[C, nj]`` proposals (``prop``) and rate
    means (``mean``, NaN where none) to replay."""
    from .accept_select import accept_select_plain

    C = carry.terms.shape[0]
    acc, prop, la, mean, dxdp = [], [], [], [], []
    for s in range(nj):
        j = j0 + s
        p = int(dr.order_host[j])
        gp = gm = None
        if given is not None:
            gp = given["prop"][:, s].contiguous()
            if given.get("mean") is not None and not bool(torch.isnan(given["mean"][:, s]).all()):
                gm = given["mean"][:, s].contiguous()
        pro = ticket_prologue_plain(tt, carry, tuning, p, dr.draw(j), gp, gm)
        dy = d_lik = None
        if tt.lik == LIK_FULL and int(tt.d_class[p]) == props.DC_GATHER:
            dy, d_lik = gather_lik_plain(tt, carry, p, pro)
        a, log_alpha = accept_select_plain(tt, carry, p, pro, dr.u_acc[:, j], dy=dy,
                                           d_lik=d_lik)
        acc.append(a)
        prop.append(pro.prop)
        la.append(log_alpha)
        nan = torch.full((C,), math.nan, dtype=carry.terms.dtype, device=carry.terms.device)
        mean.append(nan if pro.mean is None else pro.mean)
        dxdp.append(torch.zeros_like(nan) if pro.dx_dp is None else pro.dx_dp)
    return ScanOut(*(torch.stack(x, 1) for x in (acc, prop, la, mean, dxdp)))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_PTRS = ("parent", "is_leaf", "children", "cal_node", "cal_lower", "cal_lower_pm", "cal_upper",
         "cal_upper_pm", "con_young", "con_old", "con_pm", "br_node", "br_sd", "root_ch",
         "dist_idx", "inv_sd", "L",
         "heights", "rates", "birth", "death", "height", "rate_mean", "rate_var", "terms", "d",
         "y", "acc", "nbad",
         "mode", "fields", "tblocks", "node", "aux", "lo", "hi", "n_inner", "n_nodes", "lo2", "hi2",
         "n2", "sd", "rj", "d_class", "d_lo", "didx", "t_off", "t_idx", "n_off", "n_idx",
         "tuning", "order", "draw", "gdraw", "gidx", "u_acc",
         "hs", "rs", "ss", "tn", "dn", "dl", "dys", "lmhg", "lj", "d_pr", "invalid", "sprop",
         "smean", "dy_in", "dlik_in", "accept_out", "prop_out", "mean_out", "la_out")
_ROW_PTRS = _PTRS[_PTRS.index("mode"):_PTRS.index("tuning")]
_INTS = ("N", "C", "T", "D", "P", "n", "ng", "j0", "nj", "row", "KC", "KG", "lik",
         "clock_model", "n_cal", "n_con", "n_br", "br_width", "root_right", "n_inner_total",
         "sc_birth", "sc_death", "sc_bd", "sc_bdc")
_FLOATS = ("mean_root_height", "rho")


class _TicketArgs(ctypes.Structure):
    """``TicketArgs`` of ``csrc/ticket_step.cuh``, field by field."""

    _fields_ = ([(k, ctypes.c_void_p) for k in _PTRS] + [(k, ctypes.c_int) for k in _INTS]
                + [(k, ctypes.c_float) for k in _FLOATS])


@functools.lru_cache(maxsize=None)
def _check_layout() -> None:
    if build.bind("mcmcdate_ticket_args_size", ())() != ctypes.sizeof(_TicketArgs):
        raise RuntimeError("ticket_step: the kernel's argument layout does not match the "
                           "wrapper's")


def launch(name: str, args: dict, device) -> None:
    """Launch ``mcmcdate_<name>_f32`` with ``args`` (tensors as their
    device pointers)."""
    _check_layout()
    st = _TicketArgs(**{k: (v.data_ptr() if isinstance(v, torch.Tensor) else v)
                        for k, v in args.items() if v is not None})
    fn = build.bind(f"mcmcdate_{name}_f32", (ctypes.c_void_p, ctypes.c_void_p))
    build.check(fn(ctypes.addressof(st), build.stream_ptr(device)), f"{name} kernel")


class TicketScratch:
    """Per-chain scratch of the ticket kernels on the card, allocated once
    per shape: the old heights, rates and scalars of the proposed ticket
    (``hs``, ``rs`` ``[C, N]``, ``ss`` ``[C, 5]``), its new terms ``tn``
    ``[C, T]``, its new distances, deltas and ``dy`` (``dn``, ``dl``, ``dys``
    ``[C, D]``) and T1's per-chain results for K3."""

    def __init__(self, C, N, T, D, device):
        def f(*shape):
            return torch.empty(shape, dtype=torch.float32, device=device)

        self.hs, self.rs, self.ss, self.tn = f(C, N), f(C, N), f(C, 5), f(C, T)
        self.dn, self.dl, self.dys = f(C, max(D, 1)), f(C, max(D, 1)), f(C, max(D, 1))
        self.lmhg, self.lj, self.d_pr = f(C), f(C), f(C)
        self.invalid = torch.empty(C, dtype=torch.bool, device=device)  # written as bytes 0 / 1
        self.prop, self.mean = f(C), f(C)

    def args(self) -> dict:
        return dict(hs=self.hs, rs=self.rs, ss=self.ss, tn=self.tn, dn=self.dn, dl=self.dl,
                    dys=self.dys, lmhg=self.lmhg, lj=self.lj, d_pr=self.d_pr,
                    invalid=self.invalid, sprop=self.prop, smean=self.mean)


def scratch(tt: TicketTable, C: int) -> TicketScratch:
    """The table's scratch for ``C`` chains (allocated at first use)."""
    sc = tt.__dict__.get("_scratch")
    if sc is None or sc.hs.shape[0] != C:
        sc = tt.__dict__["_scratch"] = TicketScratch(C, tt.N, tt.T, tt.D, tt.model.device)
    return sc


def kernel_args(tt: TicketTable, carry, tuning, dr: TicketDraws) -> dict:
    """The arguments common to T1, K3 and T3, after checking the tensors."""
    m = tt.model
    b = carry.batch
    f32 = [(k, getattr(b, k)) for k in FIELDS] + [("terms", carry.terms), ("tuning", tuning),
                                                 ("draw", dr.u), ("u_acc", dr.u_acc)]
    if dr.g is not None:
        f32.append(("gdraw", dr.g))
    if tt.lik:
        f32 += [("d", carry.d), ("y", carry.y)]
    for name, t in f32:
        build.require_cuda(t, name, torch.float32)
    for name, t in (("acc", carry.acc), ("nbad", carry.nbad)):
        build.require_cuda(t, name, torch.int32)
    for name, t in (("order", dr.order), ("gidx", dr.gidx)):
        if t is not None:
            build.require_cuda(t, name, torch.int32)
    C, N = b.heights.shape
    if tuning.shape != (C, tt.table.n_proposals):
        raise ValueError(f"tuning must be [{C}, {tt.table.n_proposals}]")
    ka = m.prior_kernel_arrays
    dv = tt.dev
    args = dict(zip(_PTRS[3:8], ka["cal"]), **dict(zip(_PTRS[8:11], ka["con"])),
                **dict(zip(_PTRS[11:13], ka["br"])))
    args.update({k: dv[k] for k in _PTRS[:3] + _PTRS[13:15] + _ROW_PTRS})
    args.update(inv_sd=dv.get("inv_sd"), L=dv.get("L"))
    args.update({k: getattr(b, k) for k in FIELDS})
    sc_codes = dict(sc_birth=props.SC_BIRTH, sc_death=props.SC_DEATH, sc_bd=props.SC_BIRTH_DEATH,
                    sc_bdc=props.SC_BIRTH_DEATH_CONTRA)
    args.update(
        terms=carry.terms, d=carry.d, y=carry.y, acc=carry.acc, nbad=carry.nbad, tuning=tuning,
        order=dr.order, draw=dr.u, gdraw=dr.g, gidx=dr.gidx, u_acc=dr.u_acc,
        N=N, C=C, T=tt.T, D=tt.D, P=tt.table.n_proposals, n=dr.n,
        ng=0 if dr.g is None else dr.g.shape[1], row=int(dr.order_host[0]),
        KC=int(np.asarray(m.topo.children).shape[1]), KG=int(tt.didx.shape[1]), lik=tt.lik,
        clock_model=clocks.MODELS.index(m.clock), n_cal=m.calibrations.n,
        n_con=m.constraints.n, n_br=m.braces.n, br_width=ka["br_width"],
        root_right=int(m.topo.root_children[1]),
        n_inner_total=int((~np.asarray(m.topo.is_leaf)).sum()), **sc_codes,
        mean_root_height=float(m.mean_root_height), rho=1.0)
    args.update(scratch(tt, C).args())
    return args


def ticket_prologue(tt: TicketTable, carry, tuning, dr: TicketDraws, j: int = 0,
                    given=None, given_mean=None) -> TicketPro:
    """Ticket ``j`` of ``dr`` on every chain: its proposal, terms,
    distances and ratio terms (a :class:`TicketPro`).  The plain version
    (CPU tensors) reads the carry; kernel T1 (CUDA tensors, float32) writes
    the proposal into the carry in place and keeps the old values for K3,
    which must follow before any other ticket kernel.  ``given`` and
    ``given_mean`` are the plain version's (see
    :func:`ticket_prologue_plain`)."""
    p = int(dr.order_host[j])
    if carry.terms.device.type == "cpu":
        return ticket_prologue_plain(tt, carry, tuning, p, dr.draw(j), given, given_mean)
    sc = scratch(tt, carry.terms.shape[0])
    args = kernel_args(tt, carry, tuning, dr)
    args.update(j0=j, nj=1, row=p)
    launch("ticket_prologue", args, carry.terms.device)
    ticket_prologue.launches += 1
    return TicketPro(None, sc.lmhg, sc.lj, sc.d_pr, sc.invalid, sc.prop,
                     sc.mean if tt.cols["mode"][p] == _G["var_tree"] else None, sc.tn,
                     sc.dn if tt.lik else None, sc.dl if tt.lik else None)


def ticket_scan(tt: TicketTable, carry, tuning, dr: TicketDraws, j0: int, nj: int,
                out: bool = False) -> Optional[ScanOut]:
    """Tickets ``j0 .. j0+nj`` of ``dr`` (a run: no ticket of it
    :meth:`~TicketTable.breaks`) one after the other on every chain, in
    place.  With ``out``, returns their decisions and proposals (and
    var_tree's rate means) ``[C, nj]``.  The plain version
    (:func:`ticket_scan_plain`) runs for CPU tensors, kernel T3 for CUDA
    tensors (float32)."""
    if carry.terms.device.type == "cpu":
        res = ticket_scan_plain(tt, carry, tuning, dr, j0, nj)
        return res if out else None
    if any(tt.breaks(int(p)) for p in dr.order_host[j0:j0 + nj]):
        raise ValueError("ticket_scan: the run holds a ticket whose dy needs K2")
    if dr.order is None:
        raise ValueError("ticket_scan needs the run's order on the card")
    args = kernel_args(tt, carry, tuning, dr)
    C = carry.terms.shape[0]
    res = None
    if out:
        dv = carry.terms.device
        res = ScanOut(torch.empty((C, dr.n), dtype=torch.uint8, device=dv),
                      torch.empty((C, dr.n), dtype=torch.float32, device=dv),
                      mean=torch.full((C, dr.n), math.nan, dtype=torch.float32, device=dv))
        args.update(accept_out=res.accept, prop_out=res.prop, mean_out=res.mean)
    args.update(j0=j0, nj=nj)
    launch("ticket_scan", args, carry.terms.device)
    ticket_scan.launches += 1
    if res is None:
        return None
    sl = slice(j0, j0 + nj)
    return ScanOut(res.accept[:, sl].bool(), res.prop[:, sl], mean=res.mean[:, sl])


ticket_prologue.launches = 0
ticket_scan.launches = 0
