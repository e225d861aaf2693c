"""The global-move families of FastSweeps: G1 ``glob_scan``, G2
``glob_dense_prologue`` and G3 ``glob_dense_epilogue``.

They replace the XLA-compiled ``FastSweeps._glob_step`` of the JAX package
(``mcmcdate_tpu/engine/fast_sweep.py:878-1219``), scanned once per family
(``:2171-2186``): the hyper-parameter scales, the contrary global moves and
the subtree scales the range phase cannot take, 14 families in
:data:`FAMILIES`' order.  Each ticket proposes from the state the previous
one left, so a family's tickets are serial within a chain; the chains are
independent.

- ``glob_scan`` (kernel ``glob_scan_kernel``): the eight families whose
  distances are untouched or scale uniformly (``d' = u d``, with ``z`` and
  ``q`` in closed form), one launch for the whole family: one CTA per chain
  walks its tickets with the chain's arrays on chip (shared memory as far
  as a budget allows); sub_contra evaluates only its subtree's range.
- ``glob_dense_prologue`` and ``glob_dense_epilogue`` (kernels
  ``glob_dense_prologue_kernel``, ``glob_dense_epilogue_kernel``): a
  ticket of the six families whose distances change arbitrarily: the
  prologue proposes, evaluates the term blocks and ``delta = d_new - d``;
  the caller forms ``w = delta @ P`` (one large product, left to
  ``torch.matmul`` as the JAX package leaves it to XLA); the epilogue takes
  ``dq = sum delta (2 z + w)``, decides and writes back.  Every decision
  is ``log alpha = beta_prior d_pr - (beta dq) / 2 + lmhg + lj`` with the
  chain's likelihood and prior temperatures ``beta`` and ``beta_prior``
  (``carry.beta``, ``carry.beta_prior``, ``[C]``; None: 1), the JAX step's
  ``fast_sweep.py:1194-1195``.  A subtree ticket
  (sub_ultra, sub_rate) changes only its subtree's distances, its support
  rows ``S`` (:meth:`GlobConsts.support`): its prologue evaluates only
  those and also gives ``delta_S = delta[:, S]``, so that the product
  can be ``delta_S @ P[S]``, and its epilogue sums ``dq`` and writes ``d``
  on them alone (``GlobFamily.srow`` says where they are).

Every wrapper runs the plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors (float32), or raises; it counts its launches in
``<wrapper>.launches``.  The plain versions (``glob_*_plain``) are the
one-ticket step of FastSweeps, looped over a family's tickets by
:func:`glob_family_plain`; they evaluate the proposed state's terms with
``DatingModel.log_prior_terms`` (kernel K1 on the card), whose device code
the kernels share (``csrc/prior_terms.cuh``), so the kernels' heights,
rates and terms equal the plain scan's bitwise at the same proposals.  The
kernels' truncated-normal proposals use CUDA's normal CDF and its inverse
and may differ from PyTorch's in their last bits, and var_tree's rate mean
is a sum in another order: the plain versions take ``given`` proposals and
means so that a check can replay the kernels' own.

On the H100 they are bound by the term blocks' special functions (the
birth-death block in double) and, before them, by the host: the plain
ticket is about 140 launches.  G1 is one launch per family and a dense
ticket three (G2, the product, G3); see ``csrc/glob_step.cu``.  The
invalid rule of a range-restricted kernel (a NaN or -inf anywhere in the
family's new blocks) takes the chain's count of bad old entries: G1 counts
them at its start, a subtree family's first G2 launch into ``nbad``, which
the next tickets' G2 read and G3 zeroes on accept.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..models.state import State
from ..ops import clocks
from ..ops.dists import bold_tune, gamma_scale_lq, gamma_scale_sample, \
    truncated_normal_draw, truncated_normal_lq
from ..ops.heights import distances_internal
from ..ops.local_terms import NEG_INF, is_bad, sum_valid
from . import build

NONE, UNIFORM, DENSE = 0, 1, 2  # how a family moves d, z and q
# The dense families whose tickets move one subtree's distances only.
SUBTREE_DENSE = frozenset({"sub_ultra", "sub_rate"})


class Family(NamedTuple):
    fields: tuple  # State fields the family changes
    blocks: tuple  # term blocks it can change: sc (4), bd (N+1), ck (N+1), nd (nn)
    lik: int       # NONE, UNIFORM or DENSE


# The families in the sweep's order (FastSweeps' GLOB_ORDER; a family's
# kernel code is its index).  An empty nd block (no node priors) adds
# nothing, so nd is listed wherever the family can move a node prior.
FAMILIES = {
    "bd_scale": Family(("birth", "death"), ("sc", "bd"), NONE),
    "rate_mean": Family(("rate_mean",), ("sc",), UNIFORM),
    "rate_var": Family(("rate_var",), ("sc", "ck"), NONE),
    "height": Family(("height",), ("nd",), UNIFORM),
    "hm_contra": Family(("height", "rate_mean"), ("sc", "nd"), NONE),
    "norm_contra": Family(("rate_mean", "rates"), ("sc", "ck"), NONE),
    "normh_contra": Family(("height", "rates"), ("ck", "nd"), NONE),
    "var_tree": Family(("rate_var", "rates"), ("sc", "ck"), DENSE),
    "var_auto": Family(("rate_var", "rates"), ("sc", "ck"), DENSE),
    "rates_time": Family(("heights", "birth", "rate_mean"), ("sc", "bd", "ck", "nd"), DENSE),
    "slide_root": Family(("height", "heights", "rates"), ("bd", "ck", "nd"), DENSE),
    "sub_contra": Family(("heights", "rates"), ("bd", "ck", "nd"), NONE),
    "sub_ultra": Family(("heights",), ("bd", "ck", "nd"), DENSE),
    "sub_rate": Family(("rates",), ("ck",), DENSE),
}
# The families whose draw is a standard-gamma variate (the others draw a
# truncated-normal uniform).
GAMMA_TAGS = frozenset({"bd_scale", "rate_mean", "rate_var", "height", "hm_contra",
                        "norm_contra", "normh_contra", "var_tree", "var_auto", "sub_rate"})
_FIELD_BITS = {"heights": 1, "rates": 2, "birth": 4, "death": 8, "height": 16,
               "rate_mean": 32, "rate_var": 64}
_BLOCK_BITS = {"sc": 1, "bd": 2, "ck": 4, "nd": 8}
_SCALARS = ("birth", "death", "height", "rate_mean", "rate_var")


@dataclass
class GlobConsts:
    """What every family needs of the model, built once with FastSweeps:
    the model, the likelihood's constants (``P``, ``mu``, ``P mu`` and
    ``mu' P mu``, None without a likelihood; ``P`` None and the
    ``product`` ``delta -> delta @ P`` under the banded kind), the root's
    children, the number of inner nodes, the scalar kernel's ``SC_*`` codes
    and, on the model's device, the arrays the kernels read."""

    model: Any
    use_lik: bool
    P: Optional[torch.Tensor]
    mu: Optional[torch.Tensor]
    Pmu: Optional[torch.Tensor]
    mPm: float
    child_list: list
    n_inner_total: int
    sc_codes: dict  # birth, death, bd, bdc
    dist_idx: torch.Tensor  # int32 [D]
    root_ch: torch.Tensor   # int32 [K]
    pos: np.ndarray         # int [N]: each node's internal distance row (root -1)
    # ``delta -> delta @ P`` where ``P`` is not held dense (the banded kind's
    # B1 product); None: ``delta @ P``.
    product: Optional[Any] = None

    def support(self, lo: int, hi: int) -> np.ndarray:
        """The distance rows of the subtree of pre-order nodes ``[lo, hi)``:
        its nodes' rows in node order, ascending (row 0 stands for the root
        child the subtree may hang from).  A ticket that moves only the
        subtree's heights or rates changes only these rows."""
        return self.pos[lo:hi]


@dataclass
class GlobFamily:
    """One family's tickets: the plan's host arrays (``grp``, a
    ``GlobGroup``) and the same on the device (int32, float32 ``sd``, bool
    ``rj``)."""

    tag: str
    grp: Any
    rows: torch.Tensor
    sd: torch.Tensor
    aux: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    n_inner: torch.Tensor
    n_nodes: torch.Tensor
    rj: torch.Tensor
    # A subtree family's support rows, int32 [n, 2] (None elsewhere): ticket
    # s's first node's distance row, then the first of the others' rows,
    # which follow one another (``hi - lo - 1`` rows from the second start).
    srow: Optional[torch.Tensor]

    @classmethod
    def of(cls, grp, device, dtype, pos) -> "GlobFamily":
        """The family on ``device``; ``pos``, each node's internal distance
        row (``GlobConsts.pos``), gives a subtree family its ``srow``."""
        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=device)

        srow = i32(_support_starts(grp, pos)) if grp.tag in SUBTREE_DENSE else None
        return cls(grp.tag, grp, i32(grp.rows), torch.as_tensor(grp.sd, dtype=dtype, device=device),
                   i32(grp.aux), i32(grp.lo), i32(grp.hi), i32(grp.n_inner), i32(grp.n_nodes),
                   torch.as_tensor(np.asarray(grp.rj, bool), device=device), srow)

    @property
    def n(self) -> int:
        return self.grp.n_tickets

    def ticket(self, s: int) -> dict:
        """Ticket ``s``'s host values, as the one-ticket plain step takes them."""
        g = self.grp
        return dict(sd=float(g.sd[s]), aux=int(g.aux[s]), lo=int(g.lo[s]), hi=int(g.hi[s]),
                    n_inner=int(g.n_inner[s]), n_nodes=int(g.n_nodes[s]), rj=bool(g.rj[s]))


def _support_starts(grp, pos) -> np.ndarray:
    """``[n, 2]``: each subtree ticket's first support row (its first node's,
    row 0 where that node is a root child) and the first row of the
    others', which the pre-order layout puts in a row (checked)."""
    out = np.zeros((grp.n_tickets, 2), np.int64)
    for s, (lo, hi) in enumerate(zip(grp.lo.tolist(), grp.hi.tolist())):
        rows = np.asarray(pos[lo:hi], np.int64)
        if rows[0] < 0 or np.any(np.diff(rows[1:]) != 1):
            raise ValueError(f"{grp.tag} ticket {s}: support rows {rows.tolist()} are not a row "
                             f"and one run")
        out[s] = rows[0], rows[1] if len(rows) > 1 else 0
    return out


class GlobOut(NamedTuple):
    """Per chain and ticket (``[C, n]``, or ``[C]`` for one ticket): the
    accept mask and the proposal (the gamma factor, or the truncated-normal
    value); the plain versions also give each ticket's log acceptance ratio
    and var_tree's rate mean (None elsewhere), both at the replayed state,
    and the proposal's sensitivity ``dx_dp``."""

    accept: torch.Tensor
    prop: torch.Tensor
    log_alpha: Optional[torch.Tensor] = None
    mean: Optional[torch.Tensor] = None
    # The truncated-normal proposal's dx/dp = s / phi(z) at the CDF value p
    # it inverts (None for the gamma families): two float32 evaluations of
    # the same draw differ by a few ulps of p times this.
    dx_dp: Optional[torch.Tensor] = None


class GlobDense(NamedTuple):
    """What the dense prologue computes per chain: the proposed state (only
    the family's fields are meaningful; its scalars also as ``scalars``
    ``[C, 5]``: birth, death, height, rate_mean, rate_var), the proposed
    state's terms ``[C, T]`` (only the family's blocks are meaningful; from
    kernel G2, a subtree ticket's nodes and bd and ck entries only on its
    range ``[lo, hi)``),
    ``d_new`` and ``delta = d_new - d`` ``[C, D]``, and ``[C]``: lmhg (with
    the rates' positivity of var_tree and var_auto), the root-branch
    Jacobian ``lj``, the prior delta ``d_pr``, ``invalid`` (a new term NaN
    or -inf), the proposal and var_tree's rate mean."""

    state: State
    scalars: torch.Tensor
    terms: torch.Tensor
    d_new: torch.Tensor
    delta: torch.Tensor
    lmhg: torch.Tensor
    lj: torch.Tensor
    d_pr: torch.Tensor
    invalid: torch.Tensor
    prop: torch.Tensor
    mean: torch.Tensor
    dx_dp: Optional[torch.Tensor] = None  # the plain version's (see GlobOut)
    # A subtree ticket's delta on its support rows, [C, hi - lo] (None for
    # the whole-distance families).
    delta_s: Optional[torch.Tensor] = None
    # G2 on the card, subtree families: each chain's count of NaN or -inf
    # entries in the family's birth-death and clock blocks, int32 [C], to be
    # handed to the family's next ticket.
    nbad: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _spans(tag: str, model) -> list:
    N = model.topo.n
    nn = model.calibrations.n + model.constraints.n + model.braces.n
    o_bd, o_ck, o_nd = 4, 4 + (N + 1), 4 + 2 * (N + 1)
    at = {"sc": (0, 4), "bd": (o_bd, o_ck), "ck": (o_ck, o_nd), "nd": (o_nd, o_nd + nn)}
    return [at[b] for b in FAMILIES[tag].blocks]


def _propose(gc: GlobConsts, tag, batch, tune, sx, draw, given):
    """The proposed state of one ticket on every chain:
    ``(bnew, lmhg, prop, u, mean, dx_dp)`` with ``u`` the gamma factor (None
    for the truncated-normal families), ``prop``/``mean`` the proposal and
    var_tree's rate mean from ``draw`` at ``batch`` and ``dx_dp`` the
    truncated-normal proposal's sensitivity to its CDF value (None for the
    gamma families); the state is built from ``given["prop"]``/
    ``given["mean"]`` where given."""
    topo = gc.model.topo
    N = topo.n
    n_br = N - 1
    h, r = batch.heights, batch.rates
    non_root = topo.non_root_t
    child_list = gc.child_list
    sd = float(sx["sd"])
    g_prop = None if given is None else given.get("prop")
    g_mean = None if given is None else given.get("mean")
    u = mean = dx_dp = None

    def tn(mean_, a, b):
        nonlocal dx_dp
        x = truncated_normal_draw(draw, mean_, sd, tune, a, b)
        # x = mean + s ndtri(p): dx/dp = s / phi((x - mean) / s).
        s = tune * sd
        z = (x - mean_) / s
        dx_dp = s * math.sqrt(2.0 * math.pi) * torch.exp(0.5 * z * z)
        xs = x if g_prop is None else g_prop
        return x, xs, truncated_normal_lq(mean_, sd, tune, a, b, xs)

    if tag in GAMMA_TAGS:
        prop = gamma_scale_sample(draw, sd, tune)[0]
        u = prop if g_prop is None else g_prop
        base, logu = gamma_scale_lq(u, sd, tune)
    if tag == "bd_scale":
        aux = int(sx["aux"])
        sc = gc.sc_codes
        is_joint, is_con = aux == sc["bd"], aux == sc["bdc"]
        coef = 2.0 if is_joint else 0.0 if is_con else 1.0
        lmhg = base + coef * logu
        b_fac = u if aux == sc["birth"] or is_joint or is_con else 1.0
        d_fac = u if aux == sc["death"] or is_joint else (1.0 / u if is_con else 1.0)
        bnew = batch.replace(birth=batch.birth * b_fac, death=batch.death * d_fac)
    elif tag == "rate_mean":
        lmhg = base + logu
        bnew = batch.replace(rate_mean=batch.rate_mean * u)
    elif tag == "rate_var":
        lmhg = base + logu
        bnew = batch.replace(rate_var=batch.rate_var * u)
    elif tag == "height":
        lmhg = base + logu
        bnew = batch.replace(height=batch.height * u)
    elif tag == "hm_contra":
        lmhg = base
        bnew = batch.replace(height=batch.height * u, rate_mean=batch.rate_mean / u)
    elif tag in ("norm_contra", "normh_contra"):
        # Distances (incl. the root branch) are exactly invariant: the
        # divided scalar cancels rates * u.
        lmhg = base + (n_br - 1) * logu
        rates = torch.where(non_root, r * u[:, None], r)
        if tag == "norm_contra":
            bnew = batch.replace(rate_mean=batch.rate_mean / u, rates=rates)
        else:
            bnew = batch.replace(height=batch.height / u, rates=rates)
    elif tag in ("var_tree", "var_auto"):
        if tag == "var_tree":
            mean = torch.sum(torch.where(non_root, r, 0.0), dim=-1) / n_br
            m_ = mean if g_mean is None else g_mean
            rates_new = (r - m_[:, None]) * u[:, None] + m_[:, None]
            exp_ = n_br + 1
        else:
            mu_r = batch.rate_mean[:, None]
            rates_new = mu_r + u[:, None] * (r - mu_r)
            exp_ = n_br + 2
        ok = torch.all(torch.where(non_root, rates_new > 0, True), dim=-1)
        lmhg = torch.where(ok, base + exp_ * logu, NEG_INF)
        rates = torch.where(non_root, rates_new, r)
        bnew = batch.replace(rate_var=batch.rate_var * u * u, rates=rates)
    elif tag == "rates_time":
        h_mc = h[:, child_list].amax(dim=1)
        prop, h_new, lq = tn(h_mc, 0.0, h[:, 0])
        xi = h_new / h_mc
        h2 = torch.cat([h[:, :1], h[:, 1:] * xi[:, None]], dim=1)
        # (inner - 1) non-root heights scale by xi, minus the sampled
        # coordinate, minus 2 for birth and rate_mean divided by xi.
        lmhg = lq + (gc.n_inner_total - 1 - 1 - 2) * torch.log(xi)
        bnew = batch.replace(heights=h2, birth=batch.birth / xi,
                             rate_mean=batch.rate_mean / xi)
    elif tag == "slide_root":
        ht = batch.height
        hch = h[:, child_list]
        ht_oldest = ht * hch.amax(dim=1)
        prop, ht_new, lq = tn(ht, ht_oldest, math.inf)
        u_ = ht_new / ht
        scale_mask = (~topo.is_leaf_t) & (torch.arange(N, device=h.device) != 0)
        h2 = torch.where(scale_mask[None, :], h / u_[:, None], h)
        xi = (1.0 - hch) / (u_[:, None] - hch)
        rates = r.clone()
        rates[:, child_list] = r[:, child_list] * xi
        lmhg = lq - (gc.n_inner_total - 1) * torch.log(u_) + torch.sum(torch.log(xi), dim=-1)
        bnew = batch.replace(height=ht_new, heights=h2, rates=rates)
    elif tag in ("sub_ultra", "sub_contra"):
        i, lo, hi_e = int(sx["aux"]), int(sx["lo"]), int(sx["hi"])
        hi_h = h[:, i]
        hp = h[:, int(topo.parent[i])]
        prop, hnew, lq = tn(hi_h, 0.0, hp)
        xi = hnew / hi_h
        h2 = h.clone()
        h2[:, lo:hi_e] = h[:, lo:hi_e] * xi[:, None]
        if tag == "sub_ultra":
            lmhg = lq + (int(sx["n_inner"]) - 1) * torch.log(xi)
            bnew = batch.replace(heights=h2)
        else:
            # Exactly distance invariant: xi_stem compensates the stem and
            # xi cancels inside.
            xi_stem = (hp - hi_h) / (hp - hnew)
            rates = r.clone()
            rates[:, i + 1:hi_e] = r[:, i + 1:hi_e] / xi[:, None]
            rates[:, i] = r[:, i] * xi_stem
            lmhg = (lq + (int(sx["n_inner"]) - int(sx["n_nodes"])) * torch.log(xi)
                    + torch.log(xi_stem))
            bnew = batch.replace(heights=h2, rates=rates)
    elif tag == "sub_rate":
        lo, hi_e = int(sx["lo"]), int(sx["hi"])
        rates = r.clone()
        rates[:, lo:hi_e] = r[:, lo:hi_e] * u[:, None]
        lmhg = base + int(sx["n_nodes"]) * logu
        bnew = batch.replace(rates=rates)
    else:
        raise ValueError(tag)
    return bnew, lmhg, prop, u, mean, dx_dp


def _terms(gc: GlobConsts, tag, bnew, terms):
    """All term blocks of the proposed state in one evaluation (kernel K1
    on the card); only the family's blocks enter ``(d_pr, invalid)``."""
    full = gc.model.log_prior_terms(bnew)
    d_pr = 0.0
    invalid = False
    for lo, hi in _spans(tag, gc.model):
        nb = full[:, lo:hi]
        d_pr = d_pr + sum_valid(nb - terms[:, lo:hi])
        invalid = invalid | torch.any(is_bad(nb), dim=-1)
    return full, d_pr, invalid


def _decide(d_pr, dq, lmhg, lj, invalid, u_acc, beta=None, beta_prior=None):
    """``log alpha = beta_prior d_pr - (beta dq) / 2 + lmhg + lj`` (either
    temperature None: untempered) and the decision."""
    if beta_prior is not None:
        d_pr = beta_prior * d_pr
    log_alpha = d_pr - 0.5 * (dq if beta is None else beta * dq) + lmhg + lj
    log_alpha = torch.where(invalid | torch.isnan(log_alpha), NEG_INF, log_alpha)
    return torch.log(u_acc) < log_alpha, log_alpha


def _select(gc: GlobConsts, tag, carry, bnew, full, accept, row):
    """Writes the accepted chains' new terms (the family's blocks) and
    state fields into ``carry`` and counts the accepts at table row
    ``row`` (None: not counted)."""
    a = accept[:, None]
    for lo, hi in _spans(tag, gc.model):
        old = carry.terms[:, lo:hi]
        old.copy_(torch.where(a, full[:, lo:hi], old))
    batch = carry.batch
    for f in FAMILIES[tag].fields:
        cur = getattr(batch, f)
        cur.copy_(torch.where(a if cur.dim() == 2 else accept, getattr(bnew, f), cur))
    if row is not None:
        carry.acc[:, row] += accept.to(carry.acc.dtype)


def glob_scan_ticket_plain(gc: GlobConsts, tag, carry, tune, sx, draw, u_acc, row=None,
                           given=None) -> GlobOut:
    """One ticket of a family whose ``d/z/q`` are untouched (``NONE``) or
    scale uniformly (``UNIFORM``: rate_mean, height), in place: ``tune``,
    ``draw`` and ``u_acc`` are ``[C]``, ``sx`` the ticket's host values
    (:meth:`GlobFamily.ticket`)."""
    bnew, lmhg, prop, u, mean, dx_dp = _propose(gc, tag, carry.batch, tune, sx, draw, given)
    full, d_pr, invalid = _terms(gc, tag, bnew, carry.terms)
    d, z, q = carry.d, carry.z, carry.q
    dq = torch.zeros_like(q)
    lj = 0.0
    uniform = FAMILIES[tag].lik == UNIFORM
    if uniform:
        # d' = u d, z' = u z + (u-1) P mu and dq = (u^2-1) q + 2u(u-1) mu'z
        # + (u-1)^2 mu'P mu.
        d_new = u[:, None] * d
        if gc.use_lik:
            s = torch.sum(gc.mu * z, dim=-1)
            um1 = u - 1.0
            dq = (u * u - 1.0) * q + 2.0 * u * um1 * s + um1 * um1 * gc.mPm
            z_new = u[:, None] * z + um1[:, None] * gc.Pmu[None, :]
        if sx["rj"]:
            # Root-branch Jacobian ratio; the merged root-adjacent entry is
            # internal row 0.
            lj = torch.log(d[:, 0]) - torch.log(d_new[:, 0])
    accept, log_alpha = _decide(d_pr, dq, lmhg, lj, invalid, u_acc, carry.beta,
                                carry.beta_prior)
    _select(gc, tag, carry, bnew, full, accept, row)
    if uniform:
        a = accept[:, None]
        d.copy_(torch.where(a, d_new, d))
        if gc.use_lik:
            z.copy_(torch.where(a, z_new, z))
            q.copy_(torch.where(accept, q + dq, q))
    return GlobOut(accept, prop, log_alpha, mean, dx_dp)


def glob_dense_prologue_plain(gc: GlobConsts, tag, carry, tune, sx, draw,
                              given=None) -> GlobDense:
    """Plain version of :func:`glob_dense_prologue` for one ticket
    (``tune`` and ``draw`` ``[C]``, ``sx`` its host values)."""
    bnew, lmhg, prop, _, mean, dx_dp = _propose(gc, tag, carry.batch, tune, sx, draw, given)
    full, d_pr, invalid = _terms(gc, tag, bnew, carry.terms)
    d = carry.d
    d_new = distances_internal(bnew, gc.model.topo)
    lj = torch.zeros_like(d_pr)
    if sx["rj"]:
        lj = torch.log(d[:, 0]) - torch.log(d_new[:, 0])
    scalars = torch.stack([getattr(bnew, f) for f in _SCALARS], dim=1)
    delta = d_new - d
    delta_s = None
    if tag in SUBTREE_DENSE:
        rows = torch.as_tensor(gc.support(int(sx["lo"]), int(sx["hi"])), device=d.device)
        delta_s = delta.index_select(1, rows)
    return GlobDense(bnew, scalars, full, d_new, delta, lmhg, lj, d_pr, invalid, prop,
                     mean if mean is not None else torch.zeros_like(d_pr), dx_dp, delta_s)


def glob_dense_epilogue_plain(gc: GlobConsts, tag, carry, pro: GlobDense, w, u_acc, row=None):
    """Plain version of :func:`glob_dense_epilogue` for one ticket: ``w =
    pro.delta @ P`` (None without a likelihood).  Returns ``(accept,
    log_alpha)``."""
    d, z, q = carry.d, carry.z, carry.q
    if gc.use_lik:
        dq = torch.sum(pro.delta * (2.0 * z + w), dim=-1)
    else:
        dq = torch.zeros_like(q)
    accept, log_alpha = _decide(pro.d_pr, dq, pro.lmhg, pro.lj, pro.invalid, u_acc,
                                carry.beta, carry.beta_prior)
    _select(gc, tag, carry, pro.state, pro.terms, accept, row)
    a = accept[:, None]
    d.copy_(torch.where(a, pro.d_new, d))
    if gc.use_lik:
        z.copy_(torch.where(a, z + w, z))
        q.copy_(torch.where(accept, q + dq, q))
    return accept, log_alpha


def glob_ticket_plain(gc: GlobConsts, tag, carry, tune, sx, draw, u_acc, row=None,
                      given=None) -> GlobOut:
    """One ticket of family ``tag`` on every chain, in place (the one-ticket
    plain step): a dense family's prologue, ``delta @ P`` and epilogue, or
    the scan families' step."""
    if FAMILIES[tag].lik != DENSE:
        return glob_scan_ticket_plain(gc, tag, carry, tune, sx, draw, u_acc, row, given)
    pro = glob_dense_prologue_plain(gc, tag, carry, tune, sx, draw, given)
    w = None
    if gc.use_lik:
        w = pro.delta @ gc.P if gc.product is None else gc.product(pro.delta)
    accept, log_alpha = glob_dense_epilogue_plain(gc, tag, carry, pro, w, u_acc, row)
    return GlobOut(accept, pro.prop, log_alpha, pro.mean if tag == "var_tree" else None,
                   pro.dx_dp)


def glob_family_plain(gc: GlobConsts, fam: GlobFamily, carry, tun, draws, u_acc,
                      given=None) -> GlobOut:
    """The plain scan of a whole family: :func:`glob_ticket_plain` over its
    tickets in order, each counted at its table row.  ``tun``, ``draws`` and
    ``u_acc`` are ``[C, n]`` (ticket s in column s); ``given`` may hold
    ``[C, n]`` proposals (``prop``) and var_tree rate means (``mean``) to
    use in place of those drawn.  Returns a :class:`GlobOut` ``[C, n]``."""
    outs = []
    for s in range(fam.n):
        g = None if given is None else {k: v[:, s].contiguous() for k, v in given.items()
                                        if v is not None}
        outs.append(glob_ticket_plain(gc, fam.tag, carry, tun[:, s], fam.ticket(s),
                                      draws[:, s], u_acc[:, s], int(fam.grp.rows[s]), g))
    def stacked(k):
        return None if getattr(outs[0], k) is None else torch.stack([getattr(o, k) for o in outs], 1)

    return GlobOut(*map(stacked, GlobOut._fields))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_PTRS = ("parent", "is_leaf", "cal_node", "cal_lower", "cal_lower_pm", "cal_upper",
         "cal_upper_pm", "con_young", "con_old", "con_pm", "br_node", "br_sd",
         "heights", "rates", "birth", "death", "height", "rate_mean", "rate_var", "terms", "d",
         "z", "q", "acc", "mu", "pmu", "dist_idx", "root_ch",
         "rows", "sd", "aux", "lo", "hi", "n_inner", "n_nodes", "rj", "srow", "tun", "draw",
         "u_acc",
         "accept", "prop", "mean", "h_new", "r_new", "s_new", "t_new", "d_new", "delta",
         "delta_s", "lmhg", "lj", "d_pr", "invalid", "nbad", "w", "beta",
         "beta_prior", "u_bold")
_INTS = ("N", "C", "T", "D", "P", "n", "s", "family", "blocks", "fields", "use_lik",
         "clock_model", "n_cal", "n_con", "n_br", "br_width", "n_root_ch", "root_right",
         "n_inner_total", "sc_birth", "sc_death", "sc_bd", "sc_bdc", "smem_budget",
         "count_bad")
_FLOATS = ("mean_root_height", "rho", "mPm", "bold_p", "bold_factor")


class _GlobArgs(ctypes.Structure):
    """``GlobArgs`` of ``csrc/glob_step.cu``, field by field."""

    _fields_ = ([(k, ctypes.c_void_p) for k in _PTRS] + [(k, ctypes.c_int) for k in _INTS]
                + [(k, ctypes.c_float) for k in _FLOATS])


_CODES = {tag: i for i, tag in enumerate(FAMILIES)}


@functools.lru_cache(maxsize=None)
def _check_layout() -> None:
    if build.bind("mcmcdate_glob_args_size", ())() != ctypes.sizeof(_GlobArgs):
        raise RuntimeError("glob_step: the kernel's argument layout does not match the wrapper's")


def _struct(args: dict) -> _GlobArgs:
    _check_layout()
    return _GlobArgs(**{k: (v.data_ptr() if isinstance(v, torch.Tensor) else v)
                        for k, v in args.items()})


def _launch(name: str, args: dict, device) -> None:
    st = _struct(args)
    fn = build.bind(f"mcmcdate_{name}_f32", (ctypes.c_void_p, ctypes.c_void_p))
    build.check(fn(ctypes.addressof(st), build.stream_ptr(device)), f"{name} kernel")


def _args(gc: GlobConsts, fam: GlobFamily, carry, tun, draws, u_acc) -> dict:
    """The kernel arguments common to G1–G3, after checking the tensors
    (the bold mixture off: G1's wrapper sets it)."""
    model = gc.model
    batch = carry.batch
    f32 = [("heights", batch.heights), ("rates", batch.rates), ("terms", carry.terms),
           ("d", carry.d), ("q", carry.q), ("sd", fam.sd)]
    f32 += [(k, getattr(batch, k)) for k in _SCALARS]
    f32 += [(k, v) for k, v in (("tun", tun), ("draw", draws), ("u_acc", u_acc)) if v is not None]
    if gc.use_lik:
        f32 += [("z", carry.z), ("mu", gc.mu), ("pmu", gc.Pmu)]
    for name, t in f32:
        build.require_cuda(t, name, torch.float32)
    for name in ("rows", "aux", "lo", "hi", "n_inner", "n_nodes"):
        build.require_cuda(getattr(fam, name), name, torch.int32)
    build.require_cuda(fam.rj, "rj", torch.bool)  # read as bytes 0 / 1
    build.require_cuda(carry.acc, "acc", torch.int32)
    ka = model.prior_kernel_arrays
    C, N = batch.heights.shape
    fam_spec = FAMILIES[fam.tag]
    args = dict(zip(_PTRS[2:7], ka["cal"]), **dict(zip(_PTRS[7:10], ka["con"])),
                **dict(zip(_PTRS[10:12], ka["br"])))
    args.update(
        parent=ka["parent"], is_leaf=ka["is_leaf"], heights=batch.heights, rates=batch.rates,
        **{k: getattr(batch, k) for k in _SCALARS}, terms=carry.terms, d=carry.d, q=carry.q, acc=carry.acc, dist_idx=gc.dist_idx,
        root_ch=gc.root_ch, rows=fam.rows, sd=fam.sd, aux=fam.aux, lo=fam.lo, hi=fam.hi,
        n_inner=fam.n_inner, n_nodes=fam.n_nodes, rj=fam.rj, tun=tun, draw=draws, u_acc=u_acc,
        N=N, C=C, T=carry.terms.shape[1], D=carry.d.shape[1], P=carry.acc.shape[1], n=fam.n,
        family=_CODES[fam.tag], blocks=sum(_BLOCK_BITS[b] for b in fam_spec.blocks),
        fields=sum(_FIELD_BITS[f] for f in fam_spec.fields), use_lik=int(gc.use_lik),
        clock_model=clocks.MODELS.index(model.clock), n_cal=model.calibrations.n,
        n_con=model.constraints.n, n_br=model.braces.n, br_width=ka["br_width"],
        n_root_ch=gc.root_ch.shape[0], root_right=int(model.topo.root_children[1]),
        n_inner_total=gc.n_inner_total, sc_birth=gc.sc_codes["birth"],
        sc_death=gc.sc_codes["death"], sc_bd=gc.sc_codes["bd"], sc_bdc=gc.sc_codes["bdc"],
        mean_root_height=float(model.mean_root_height), rho=1.0, mPm=float(gc.mPm),
        bold_p=0.0, bold_factor=1.0,
        beta=build.beta_arg(carry.beta, C, carry.d.device),
        beta_prior=build.beta_arg(carry.beta_prior, C, carry.d.device))
    if gc.use_lik:
        args.update(z=carry.z, mu=gc.mu, pmu=gc.Pmu)
    return {k: v for k, v in args.items() if v is not None}


def _node_scratch(fam_spec, C, N, device):
    def buf(field):
        return torch.empty((C, N), dtype=torch.float32, device=device) \
            if field in fam_spec.fields else None
    return buf("heights"), buf("rates")


# G1's chain arrays in the order they claim shared memory (csrc/glob_step.cu
# Array): heights, old bd and ck terms, new bd and ck terms, old and new nd
# terms, rates, d, z.
SCAN_ARRAYS = ("heights", "bd", "ck", "bd_new", "ck_new", "nd", "nd_new", "rates", "d", "z")


def _scan_args(gc: GlobConsts, fam: GlobFamily, carry, tun, draws, u_acc,
               smem_budget: Optional[int]) -> dict:
    """G1's arguments; ``t_new`` holds the new terms that shared memory
    does not (-1: the kernel's default budget)."""
    args = _args(gc, fam, carry, tun, draws, u_acc)
    C = carry.d.shape[0]
    dev = carry.d.device
    args.update(accept=torch.empty((C, fam.n), dtype=torch.bool, device=dev),
                prop=torch.empty((C, fam.n), dtype=torch.float32, device=dev),
                t_new=torch.empty_like(carry.terms),
                smem_budget=-1 if smem_budget is None else int(smem_budget))
    return args


def glob_scan_smem(gc: GlobConsts, fam: GlobFamily, carry, smem_budget=None) -> tuple:
    """``(bytes, arrays)``: the shared memory kernel G1 takes per chain for
    ``fam`` on this carry (CUDA tensors) and the names of the chain arrays
    it holds there (the others stay in global memory), under
    ``smem_budget`` bytes or, where None, the default budget that lets
    ``ceil(C / SMs)`` CTAs share an SM."""
    C = carry.d.shape[0]
    tk = torch.empty((C, fam.n), dtype=torch.float32, device=carry.d.device)
    st = _struct(_scan_args(gc, fam, carry, tk, tk, tk, smem_budget))
    mask = ctypes.c_int(0)
    fn = build.bind("mcmcdate_glob_scan_smem", (ctypes.c_void_p, ctypes.c_void_p))
    nbytes = fn(ctypes.addressof(st), ctypes.byref(mask))
    return nbytes, tuple(a for i, a in enumerate(SCAN_ARRAYS) if mask.value >> i & 1)


def glob_scan(gc: GlobConsts, fam: GlobFamily, carry, tun, draws, u_acc,
              smem_budget: Optional[int] = None, u_bold=None, bold_p: float = 0.0,
              bold_factor: float = 8.0) -> GlobOut:
    """All tickets of a family whose ``d/z/q`` are untouched or scale
    uniformly, in order, on every chain, in place (``carry``: a FastCarry;
    ``tun``, ``draws``, ``u_acc`` ``[C, n]``).  Returns a :class:`GlobOut`
    ``[C, n]``.  The plain version (:func:`glob_family_plain`) runs for CPU
    tensors, kernel G1 for CUDA tensors (float32).  ``smem_budget`` caps the
    shared memory G1 takes per chain (0: every array in global memory; see
    :func:`glob_scan_smem`).  ``u_bold`` ``[C, n]`` (sub_contra only; None:
    off) applies the bold mixture (``ops.dists.bold_tune``)."""
    if FAMILIES[fam.tag].lik == DENSE:
        raise ValueError(f"glob_scan: {fam.tag} moves the distances densely")
    if u_bold is not None and fam.tag != "sub_contra":
        raise ValueError(f"glob_scan: the bold mixture is sub_contra's, not {fam.tag}'s")
    if carry.d.device.type == "cpu":
        return glob_family_plain(gc, fam, carry, bold_tune(tun, u_bold, bold_p, bold_factor),
                                 draws, u_acc)
    args = _scan_args(gc, fam, carry, tun, draws, u_acc, smem_budget)
    if u_bold is not None:
        build.require_cuda(u_bold, "u_bold", torch.float32)
        if u_bold.shape != u_acc.shape:
            raise ValueError(f"glob_scan: u_bold of {tuple(u_bold.shape)}, expected "
                             f"{tuple(u_acc.shape)}")
        args.update(u_bold=u_bold, bold_p=float(bold_p), bold_factor=float(bold_factor))
    _launch("glob_scan", args, carry.d.device)
    glob_scan.launches += 1
    glob_scan.launches_bold += u_bold is not None
    return GlobOut(args["accept"], args["prop"])


def glob_dense_prologue(gc: GlobConsts, fam: GlobFamily, s: int, carry, tun, draws,
                        nbad=None) -> GlobDense:
    """Ticket ``s`` of a dense family (var_tree, var_auto, rates_time,
    slide_root, sub_ultra, sub_rate) on every chain: the proposal from
    ``draws[:, s]`` and its :class:`GlobDense`.  The carry is read, not
    changed.  The plain version runs for CPU tensors, kernel G2 for CUDA
    tensors (float32).  ``nbad``: the previous ticket's ``GlobDense.nbad``
    of the same family (None: G2 counts the bad entries afresh)."""
    if carry.d.device.type == "cpu":
        return glob_dense_prologue_plain(gc, fam.tag, carry, tun[:, s], fam.ticket(s),
                                         draws[:, s])
    args = _args(gc, fam, carry, tun, draws, None)
    batch = carry.batch
    C, N = batch.heights.shape
    dev = carry.d.device
    fam_spec = FAMILIES[fam.tag]
    h_new, r_new = _node_scratch(fam_spec, C, N, dev)

    def vec():
        return torch.empty(C, dtype=torch.float32, device=dev)

    scalars = torch.empty((C, 5), dtype=torch.float32, device=dev)
    state = State(heights=batch.heights if h_new is None else h_new,
                  rates=batch.rates if r_new is None else r_new,
                  **{k: scalars[:, i] for i, k in enumerate(_SCALARS)})
    delta_s = count_bad = None
    if fam.tag in SUBTREE_DENSE:
        delta_s = torch.empty((C, int(fam.grp.hi[s]) - int(fam.grp.lo[s])), dtype=torch.float32,
                              device=dev)
        count_bad = nbad is None
        if count_bad:
            nbad = torch.empty(C, dtype=torch.int32, device=dev)
        build.require_cuda(nbad, "nbad", torch.int32)
    out = GlobDense(state, scalars, torch.empty_like(carry.terms), torch.empty_like(carry.d),
                    torch.empty_like(carry.d), vec(), vec(), vec(),
                    torch.empty(C, dtype=torch.bool, device=dev), vec(), vec(),
                    delta_s=delta_s, nbad=nbad if fam.tag in SUBTREE_DENSE else None)
    args.update(s=s, h_new=h_new, r_new=r_new, s_new=scalars, t_new=out.terms, d_new=out.d_new,
                delta=out.delta, delta_s=delta_s, lmhg=out.lmhg, lj=out.lj, d_pr=out.d_pr,
                invalid=out.invalid, nbad=out.nbad, count_bad=int(bool(count_bad)),
                prop=out.prop, mean=out.mean)
    _launch("glob_dense_prologue", {k: v for k, v in args.items() if v is not None}, dev)
    glob_dense_prologue.launches += 1
    return out


def glob_dense_epilogue(gc: GlobConsts, fam: GlobFamily, s: int, carry, pro: GlobDense, w,
                        u_acc) -> torch.Tensor:
    """The decision and write-back of ticket ``s`` of a dense family on
    every chain, in place: ``pro`` from :func:`glob_dense_prologue`, ``w =
    pro.delta @ P`` (None without a likelihood), ``u_acc`` ``[C, n]``.
    Returns the accept mask ``[C]``.  The plain version runs for CPU
    tensors, kernel G3 for CUDA tensors (float32)."""
    if carry.d.device.type == "cpu":
        return glob_dense_epilogue_plain(gc, fam.tag, carry, pro, w, u_acc[:, s],
                                         int(fam.grp.rows[s]))[0]
    args = _args(gc, fam, carry, None, None, u_acc)
    fields = FAMILIES[fam.tag].fields
    for name, t in (("scalars", pro.scalars), ("t_new", pro.terms), ("d_new", pro.d_new),
                    ("delta", pro.delta), ("lmhg", pro.lmhg), ("lj", pro.lj),
                    ("d_pr", pro.d_pr)) + ((("w", w),) if gc.use_lik else ()):
        build.require_cuda(t, name, torch.float32)
    build.require_cuda(pro.invalid, "invalid", torch.bool)
    for f in ("heights", "rates"):
        if f in fields:
            build.require_cuda(getattr(pro.state, f), f"{f} (proposed)", torch.float32)
    C = carry.d.shape[0]
    accept = torch.empty(C, dtype=torch.bool, device=carry.d.device)
    if pro.nbad is not None:
        build.require_cuda(pro.nbad, "nbad", torch.int32)
    if fam.tag in SUBTREE_DENSE:
        # dq and d over the support rows: delta_S and where they are.
        build.require_cuda(fam.srow, "srow", torch.int32)
        build.require_cuda(pro.delta_s, "delta_s", torch.float32)
    args.update(s=s, s_new=pro.scalars, t_new=pro.terms, d_new=pro.d_new, delta=pro.delta,
                lmhg=pro.lmhg, lj=pro.lj, d_pr=pro.d_pr, invalid=pro.invalid, accept=accept,
                nbad=pro.nbad, srow=fam.srow, delta_s=pro.delta_s,
                w=w if gc.use_lik else None,
                h_new=pro.state.heights if "heights" in fields else None,
                r_new=pro.state.rates if "rates" in fields else None)
    _launch("glob_dense_epilogue", {k: v for k, v in args.items() if v is not None},
            carry.d.device)
    glob_dense_epilogue.launches += 1
    return accept


glob_scan.launches = 0
glob_scan.launches_bold = 0  # the launches with the bold mixture's uniforms
glob_dense_prologue.launches = 0
glob_dense_epilogue.launches = 0
