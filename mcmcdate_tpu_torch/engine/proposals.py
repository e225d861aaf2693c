"""Proposal kernels and the weighted proposal cycle over a chain batch.

Port of ``mcmcdate_tpu/engine/proposals.py``.  The host side (the
:class:`ProposalTable` and :func:`build_proposal_table`) is copied, because
the JAX module imports JAX.  Each kernel ``_k_*`` is a plain torch function
``(state, draw, tune, node, aux, par, topo) -> (state', log_mhg)`` over the
``[C]`` chain axis: ``node``, ``aux`` and ``par`` are host values (every
chain runs the same ticket), ``tune`` is ``[C]`` and ``draw`` is the
kernel's random draw, a uniform for the truncated-normal kernels and a
standard-gamma variate of shape ``par / tune`` for the gamma-scale kernels.
Fields a kernel leaves unchanged are the same tensors in ``state'``.

``log_mhg`` is the log Metropolis-Hastings-Green factor: kernel ratio plus
the FULL log determinant of the (state, auxiliary) -> (state', auxiliary')
map.  Two proposals deviate deliberately from the reference's recorded
exponents where those disagree with the determinant of the map (derivations
in the kernel docstrings): ``scale_var_rate_tree`` (reference
Unconstrained.hs:321-326) and ``slide_root_contra`` (reference
Contrary.hs:173-189).  Both agree to first order around u = 1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..ops.dists import gamma_scale_lq, gamma_scale_sample, truncated_normal_draw, \
    truncated_normal_lq, truncated_normal_sample
from ..ops.node_priors import BraceSet
from ..tree import FlatTopology

# Proposal kinds.
K_SCALE_SCALAR = 0
K_SCALE_HEIGHT_RATEMEAN_CONTRA = 1
K_SLIDE_NODE_ULTRA = 2
K_SCALE_SUBTREE_ULTRA = 3
K_PULLEY_ULTRA = 4
K_SCALE_BRANCH_RATE = 5
K_SCALE_SUBTREE_RATE = 6
K_SCALE_NORM_RATE_TREE_CONTRA = 7
K_SCALE_VAR_RATE_TREE = 8
K_SCALE_VAR_RATE_TREE_AUTOCORR = 9
K_SLIDE_NODES_CONTRA = 10
K_SCALE_SUBTREES_CONTRA = 11
K_SLIDE_ROOT_CONTRA = 12
K_SCALE_NORM_HEIGHT_RATE_TREE_CONTRA = 13
K_SCALE_RATES_TIME_TREE_CONTRA = 14
K_SLIDE_BRACED_ULTRA = 15
K_SLIDE_BRACED_CONTRA = 16
N_KINDS = 17

# aux codes for K_SCALE_SCALAR.  The last two are TPU-side extras with no
# reference analog: joint moves along the two principal directions of the
# weakly-identified (birth, death) pair (the reference only moves each rate
# alone, app/Definitions.hs:259-260, which mixes the near-flat ridge of the
# birth-death posterior with a tiny effective step; a joint ray scale
# (b,d) -> (ub, ud) and its contrary (ub, d/u) traverse the ridge directly).
(SC_BIRTH, SC_DEATH, SC_RATE_MEAN, SC_RATE_VAR, SC_HEIGHT,
 SC_BIRTH_DEATH, SC_BIRTH_DEATH_CONTRA) = range(7)

# Likelihood-update classes (static per proposal row).  The whitened
# residual y = (d - mu) @ L is updated incrementally:
#
# - DC_INV: the proposal leaves the distance vector EXACTLY invariant.
#   This covers every "contrary" move — their defining property is that the
#   expected number of substitutions per branch is unchanged (e.g.
#   slideNodesAtContrarily rescales rates by (h_p-h)/(h_p-h') so t*r is
#   constant, Contrary.hs:48-64) — plus scalar moves on parameters the
#   distances do not involve (birth, death, rate variance).
# - DC_FULL: recompute y (pulley, the variance-spread kernels, scalar
#   height / rate-mean scales; all carry O(1) weight, so full O(n^2)
#   evaluations are a vanishing fraction of a sweep).
# - DC_GATHER: <= KG statically-known entries change (node slides: the
#   node's branch and its children; single branch scales; braced slides;
#   scaleRatesAndTreeContrarily touches only the merged root entry 0).
# - DC_B64/B256/B1024: a contiguous internal-layout range changes (sub-tree
#   scales); entry 0 is handled by an unconditional extra term.
DC_INV, DC_FULL, DC_GATHER, DC_B64, DC_B256, DC_B1024 = range(6)
D_BUCKETS = {DC_B64: 64, DC_B256: 256, DC_B1024: 1024}

# Prior-term block classes: which of the [scalars, bd, clock, nodes] blocks
# a proposal can change.  Skipped blocks reuse the carried values (their
# acceptance delta is exactly zero).
PC_SC, PC_SC_BD, PC_SC_CK, PC_CK, PC_ND, PC_SC_ND, PC_BD_CK_ND, PC_ALL = range(8)
PC_BLOCKS = {  # (scalars, bd, clock, nodes)
    PC_SC: (1, 0, 0, 0),
    PC_SC_BD: (1, 1, 0, 0),
    PC_SC_CK: (1, 0, 1, 0),
    PC_CK: (0, 0, 1, 0),
    PC_ND: (0, 0, 0, 1),
    PC_SC_ND: (1, 0, 0, 1),
    PC_BD_CK_ND: (0, 1, 1, 1),
    PC_ALL: (1, 1, 1, 1),
}

NEG_INF = -math.inf


@dataclass(frozen=True)
class ProposalTable:
    """Static description of the proposal cycle.

    Mirrors ``proposals`` (app/Definitions.hs:256-278): one row per proposal
    instance; ``tickets`` repeats row indices by weight (``PWeight``); a
    sweep executes the tickets in random order.
    """

    kind: np.ndarray  # int32[P]
    node: np.ndarray  # int32[P] target node (or -1)
    aux: np.ndarray  # int32[P] scalar selector / brace index
    par: np.ndarray  # f64[P] base sd (slides) or gamma shape (scales)
    weight: np.ndarray  # int32[P]
    dim: np.ndarray  # int32[P] PDimension (sets the tuned acceptance target)
    root_jac: np.ndarray  # bool[P] multiply by jacobianRootBranch ratio
    names: Tuple[str, ...]
    tickets: np.ndarray  # int32[T] row index per ticket
    d_class: np.ndarray = None  # int32[P] likelihood-update class (DC_*)
    d_lo: np.ndarray = None  # int32[P] range start for DC_B* rows
    didx: np.ndarray = None  # int32[P, KG] gathered entries; pad = D (zero row)
    prior_class: np.ndarray = None  # int32[P] prior-block class (PC_*)

    @property
    def n_proposals(self) -> int:
        return len(self.kind)

    @property
    def n_tickets(self) -> int:
        return len(self.tickets)

    def tune_max(self) -> np.ndarray:
        """Per-proposal tuning upper bound.

        Gamma-scale kernels keep shape ``par / t >= 2``.  The variance-spread
        kernels (scaleVarianceAndTree and its autocorrelated variant) keep
        shape ``>= 10``: heavier kernels propose u ~ 3-5 jumps that
        occasionally tunnel the chain into the near-zero-mass
        (large variance, large rates) ridge where exits are exponentially
        slow — a metastability the reference never exposes because its
        auto-tuner leaves these shape-100 kernels at O(1) tuning.
        """
        is_scale = np.isin(
            self.kind,
            [K_SCALE_SCALAR, K_SCALE_HEIGHT_RATEMEAN_CONTRA, K_SCALE_BRANCH_RATE,
             K_SCALE_SUBTREE_RATE, K_SCALE_NORM_RATE_TREE_CONTRA,
             K_SCALE_NORM_HEIGHT_RATE_TREE_CONTRA],
        )
        is_spread = np.isin(
            self.kind, [K_SCALE_VAR_RATE_TREE, K_SCALE_VAR_RATE_TREE_AUTOCORR]
        )
        out = np.where(is_scale, np.minimum(self.par / 2.0, 1e2), 1e2)
        return np.where(is_spread, self.par / 10.0, out)

    def target_rates(self) -> np.ndarray:
        """Optimal acceptance rate per proposal from its dimension: 0.44 for
        one dimension falling linearly to 0.234 at five or more (the classic
        Roberts-Gelman-Gilks targets; mirrors the reference engine's
        PDimension-based tuning targets)."""
        d = np.clip(self.dim.astype(np.float64), 1, 5)
        return 0.44 + (0.234 - 0.44) * (d - 1) / 4.0


def weight_n_branches(n_nodes: int) -> int:
    """Weight of global proposals: floor(log_1.3 N) (Definitions.hs:127-130)."""
    return int(math.floor(math.log(n_nodes) / math.log(1.3)))


def build_proposal_table(
    topo: FlatTopology,
    braces: BraceSet,
    calibrations_available: bool,
) -> ProposalTable:
    """Assemble the full cycle (app/Definitions.hs:256-278)."""
    rows: List[Tuple] = []

    def add(kind, node, aux, par, weight, dim, root_jac, name,
            dclass=DC_FULL, dlo=1, didx=(), pclass=PC_ALL):
        if weight > 0:
            rows.append((kind, node, aux, par, weight, dim, root_jac, name,
                         dclass, dlo, tuple(didx), pclass))

    n = topo.n
    w_nb = weight_n_branches(n)
    inner = [int(i) for i in topo.inner_nodes if i != 0]
    depth = topo.depth
    level = topo.level
    n_inner_sub = topo.n_inner_subtree
    n_nodes_sub = topo.n_nodes_subtree
    n_inner_total = int((~topo.is_leaf).sum())

    def depth_weight(i):
        # min(wMin + depth - 2, wMax), wMin=3, wMax=8 (Ultrametric.hs:211-217)
        return min(3 + int(depth[i]) - 2, 8)

    pos = topo.internal_pos

    def range_of(i):
        lo, hi = topo.dist_range(i)
        ln = hi - lo
        if ln <= 64:
            return DC_B64, lo
        if ln <= 256:
            return DC_B256, lo
        if ln <= 1024:
            return DC_B1024, lo
        return DC_FULL, 1

    def slide_idx(i):
        out = {int(pos[i])}
        for c in topo.children[i]:
            if c >= 0:
                out.add(int(pos[c]))
        return sorted(out)

    # Hyper-parameter scales (Definitions.hs:259-262).  Birth, death, and
    # rate variance do not enter the distances: likelihood-invariant.
    add(K_SCALE_SCALAR, -1, SC_BIRTH, 10.0, w_nb, 1, False, "Time birth rate",
        DC_INV, pclass=PC_SC_BD)
    add(K_SCALE_SCALAR, -1, SC_DEATH, 10.0, w_nb, 1, False, "Time death rate",
        DC_INV, pclass=PC_SC_BD)
    # Joint (birth, death) ridge moves (see the SC_* comment above).
    add(K_SCALE_SCALAR, -1, SC_BIRTH_DEATH, 10.0, w_nb, 2, False,
        "Time birth and death rates", DC_INV, pclass=PC_SC_BD)
    add(K_SCALE_SCALAR, -1, SC_BIRTH_DEATH_CONTRA, 10.0, w_nb, 2, False,
        "Time birth and death rates (contrary)", DC_INV, pclass=PC_SC_BD)
    add(K_SCALE_SCALAR, -1, SC_RATE_MEAN, 10.0, w_nb, 1, False, "Rate mean",
        DC_FULL, pclass=PC_SC)
    add(K_SCALE_SCALAR, -1, SC_RATE_VAR, 10.0, w_nb, 1, False, "Rate variance",
        DC_INV, pclass=PC_SC_CK)
    # Rates and time tree contrary (Definitions.hs:263, 275): all inner
    # branches are rate-compensated; only the merged root entry changes.
    add(
        K_SCALE_RATES_TIME_TREE_CONTRA, 0, -1, 0.1, w_nb,
        (n_inner_total - 1) + 2, True, "Rates and time tree",
        DC_GATHER, 1, [0], PC_ALL,
    )

    # Time tree proposals (Definitions.hs:144-166).
    l, r = topo.root_children
    if not topo.is_leaf[l] and not topo.is_leaf[r]:
        add(
            K_PULLEY_ULTRA, 0, -1, 0.01, 6,
            int(n_inner_sub[l] + n_inner_sub[r]), True, "[R] Time tree pulley",
            DC_FULL, pclass=PC_BD_CK_ND,
        )
    for i in inner:
        rj = level[i] == 1
        tag = "[R]" if rj else "[O]"
        add(K_SLIDE_NODE_ULTRA, i, -1, 0.01, 5, 1, rj,
            f"{tag} Time tree slide node {i}", DC_GATHER, 1, slide_idx(i),
            PC_BD_CK_ND)
        dc, dlo = range_of(i)
        add(
            K_SCALE_SUBTREE_ULTRA, i, -1, 0.01, depth_weight(i),
            int(n_inner_sub[i]), rj, f"{tag} Time tree scale sub tree {i}",
            dc, dlo, pclass=PC_BD_CK_ND,
        )
    for b in range(braces.n):
        nodes_b = [int(x) for x in braces.node[b] if x >= 0]
        bidx = sorted({j for x in nodes_b for j in slide_idx(x)})
        add(
            K_SLIDE_BRACED_ULTRA, -1, b, 0.01, 5, len(nodes_b), False,
            f"[B] Time tree brace {braces.names[b] if braces.names else b}",
            DC_GATHER, 1, bidx, PC_BD_CK_ND,
        )

    # Rate tree proposals (Definitions.hs:180-201).  The norm-contrary move
    # rescales rates against the mean: distances invariant.
    add(
        K_SCALE_NORM_RATE_TREE_CONTRA, -1, -1, 100.0, w_nb, n, True,
        "[R] Rate mean, Rate tree", DC_INV, pclass=PC_SC_CK,
    )
    add(K_SCALE_VAR_RATE_TREE, -1, -1, 100.0, w_nb, n, True,
        "[R] Rate variance, Rate tree", DC_FULL, pclass=PC_SC_CK)
    add(
        K_SCALE_VAR_RATE_TREE_AUTOCORR, -1, -1, 100.0, w_nb, n, True,
        "[R] Rate variance, Rate tree (autocorrelated)", DC_FULL,
        pclass=PC_SC_CK,
    )
    for i in range(1, n):
        rj = level[i] == 1
        tag = "[R]" if rj else "[O]"
        add(K_SCALE_BRANCH_RATE, i, -1, 100.0, 3, 1, rj,
            f"{tag} Rate tree scale branch {i}", DC_GATHER, 1, [int(pos[i])],
            PC_CK)
    for i in inner:
        rj = level[i] == 1
        tag = "[R]" if rj else "[O]"
        dc, dlo = range_of(i)
        add(
            K_SCALE_SUBTREE_RATE, i, -1, 100.0, depth_weight(i),
            int(n_nodes_sub[i]), rj, f"{tag} Rate tree scale sub tree {i}",
            dc, dlo, pclass=PC_CK,
        )

    # Contrary proposals on both trees (Definitions.hs:204-221): rates are
    # rescaled so t*r stays constant per branch — likelihood-invariant.
    for i in inner:
        rj = level[i] == 1
        tag = "[C] [R]" if rj else "[C] [O]"
        ndaughters = int(topo.n_children[i])
        add(
            K_SLIDE_NODES_CONTRA, i, -1, 0.1, depth_weight(i),
            1 + 1 + ndaughters, rj, f"{tag} Trees slide node {i}", DC_INV,
            pclass=PC_BD_CK_ND,
        )
        add(
            K_SCALE_SUBTREES_CONTRA, i, -1, 0.1, depth_weight(i),
            int(n_inner_sub[i] + n_nodes_sub[i]), rj,
            f"{tag} Trees scale sub tree {i}", DC_INV, pclass=PC_BD_CK_ND,
        )
    for b in range(braces.n):
        nodes_b = [int(x) for x in braces.node[b] if x >= 0]
        ndaughters = sum(int(topo.n_children[x]) for x in nodes_b)
        add(
            K_SLIDE_BRACED_CONTRA, -1, b, 0.1, 5,
            len(nodes_b) * 2 + ndaughters, False,
            f"[C] [B] Trees brace {braces.names[b] if braces.names else b}",
            DC_INV, pclass=PC_BD_CK_ND,
        )

    # Proposals changing the absolute time height — only when calibrated
    # (Definitions.hs:241-253).
    if calibrations_available:
        add(K_SCALE_SCALAR, -1, SC_HEIGHT, 3000.0, w_nb, 1, False,
            "Time height", DC_FULL, pclass=PC_ND)
        add(
            K_SCALE_HEIGHT_RATEMEAN_CONTRA, -1, -1, 10.0, w_nb, 2, False,
            "Time height, rate mean", DC_INV, pclass=PC_SC_ND,
        )
        add(
            K_SCALE_NORM_HEIGHT_RATE_TREE_CONTRA, -1, -1, 100.0, w_nb, n, True,
            "[R] Time height, Rate tree", DC_INV, pclass=PC_BD_CK_ND,
        )
        add(
            K_SLIDE_ROOT_CONTRA, 0, -1, 10.0, w_nb,
            1 + n_inner_total + int(topo.n_children[0]), True,
            "[R] Trees slide root", DC_INV, pclass=PC_BD_CK_ND,
        )

    kind = np.asarray([x[0] for x in rows], np.int32)
    node = np.asarray([x[1] for x in rows], np.int32)
    aux = np.asarray([x[2] for x in rows], np.int32)
    par = np.asarray([x[3] for x in rows], np.float64)
    weight = np.asarray([x[4] for x in rows], np.int32)
    dim = np.asarray([x[5] for x in rows], np.int32)
    root_jac = np.asarray([x[6] for x in rows], bool)
    names = tuple(x[7] for x in rows)
    d_class = np.asarray([x[8] for x in rows], np.int32)
    d_lo = np.asarray([x[9] for x in rows], np.int32)
    prior_class = np.asarray([x[11] for x in rows], np.int32)
    kg = max(max((len(x[10]) for x in rows), default=1), 1)
    n_dist = topo.n - 2
    didx = np.full((len(rows), kg), n_dist, np.int32)  # pad -> zero row
    for p, x in enumerate(rows):
        for j, v in enumerate(x[10]):
            didx[p, j] = v
    tickets = np.concatenate(
        [np.full(w, p, np.int32) for p, w in enumerate(weight)]
    )
    return ProposalTable(kind, node, aux, par, weight, dim, root_jac, names,
                         tickets, d_class, d_lo, didx, prior_class)


# ---------------------------------------------------------------------------
# Kernels.  Each returns (state', log_mhg [C]).
# ---------------------------------------------------------------------------

# Kinds whose draw is a standard-gamma variate; all others take a uniform.
GAMMA_KINDS = frozenset({
    K_SCALE_SCALAR, K_SCALE_HEIGHT_RATEMEAN_CONTRA, K_SCALE_BRANCH_RATE,
    K_SCALE_SUBTREE_RATE, K_SCALE_NORM_RATE_TREE_CONTRA, K_SCALE_VAR_RATE_TREE,
    K_SCALE_VAR_RATE_TREE_AUTOCORR, K_SCALE_NORM_HEIGHT_RATE_TREE_CONTRA,
})


class Replay:
    """A ticket's draw for the kernels below (``draw``, ``[C]``), with the
    proposal to build the state from in its place: ``given``, the
    truncated-normal value or the gamma factor (None: the one drawn), and
    ``given_mean``, the rate-variance spread's non-root rate mean.  The
    kernel records what it drew: ``prop``, ``mean`` and, for a truncated
    normal, ``dx_dp``, the value's sensitivity to the CDF value it inverts
    (``x = mean + s ndtri(p)``: ``dx/dp = s / phi((x - mean) / s)``).  A
    check replays another evaluation's proposals (a CUDA kernel's) through
    these kernels with it."""

    def __init__(self, draw, given=None, given_mean=None):
        self.draw, self.given, self.given_mean = draw, given, given_mean
        self.prop = self.mean = self.dx_dp = None


def _tn(uni, mean, par, tune, a, b):
    """``truncated_normal_sample`` of the kernels, from a uniform or a
    :class:`Replay`."""
    if not isinstance(uni, Replay):
        return truncated_normal_sample(uni, mean, par, tune, a, b)
    x = truncated_normal_draw(uni.draw, mean, par, tune, a, b)
    s = tune * par
    uni.prop = x
    uni.dx_dp = s * math.sqrt(2.0 * math.pi) * torch.exp(0.5 * ((x - mean) / s) ** 2)
    if uni.given is not None:
        x = uni.given
    return x, truncated_normal_lq(mean, par, tune, a, b, x)


def _gs(g, par, tune):
    """``gamma_scale_sample`` of the kernels, from a standard-gamma draw or
    a :class:`Replay`."""
    if not isinstance(g, Replay):
        return gamma_scale_sample(g, par, tune)
    u = gamma_scale_sample(g.draw, par, tune)[0]
    g.prop = u
    if g.given is not None:
        u = g.given
    return (u, *gamma_scale_lq(u, par, tune))


def _mean(g, mean):
    """The spread's rate mean, recorded in (and replaced from) a Replay."""
    if not isinstance(g, Replay):
        return mean
    g.mean = mean
    return mean if g.given_mean is None else g.given_mean


def _children(topo, i):
    return [int(c) for c in topo.children[i] if c >= 0]


def _max_child_height(h, topo, i):
    ch = _children(topo, i)
    if not ch:
        return torch.full_like(h[:, 0], -math.inf)
    return h[:, ch].amax(dim=1)


def _set_col(t, i, v):
    out = t.clone()
    out[:, i] = v
    return out


def _scale_cols(t, lo, hi, f):
    out = t.clone()
    out[:, lo:hi] = t[:, lo:hi] * f[:, None]
    return out


def _k_scale_scalar(state, g, tune, node, aux, par, topo, braces):
    u, base, logu = _gs(g, par, tune)
    # n_up - n_down coordinates scaled by u: 1 for the single-scalar moves,
    # 2 for the joint (birth, death) ray, 0 for its contrary variant.
    coef = 2.0 if aux == SC_BIRTH_DEATH else 0.0 if aux == SC_BIRTH_DEATH_CONTRA else 1.0
    log_mhg = base + coef * logu
    new = {}
    if aux in (SC_BIRTH, SC_BIRTH_DEATH, SC_BIRTH_DEATH_CONTRA):
        new["birth"] = state.birth * u
    if aux in (SC_DEATH, SC_BIRTH_DEATH):
        new["death"] = state.death * u
    elif aux == SC_BIRTH_DEATH_CONTRA:
        new["death"] = state.death * (1.0 / u)
    if aux == SC_RATE_MEAN:
        new["rate_mean"] = state.rate_mean * u
    if aux == SC_RATE_VAR:
        new["rate_var"] = state.rate_var * u
    if aux == SC_HEIGHT:
        new["height"] = state.height * u
    return state.replace(**new), log_mhg


def _k_scale_height_ratemean_contra(state, g, tune, node, aux, par, topo, braces):
    """scaleContrarily on (timeHeight, rateMean): x -> x*u, y -> y/u."""
    u, base, _ = _gs(g, par, tune)
    return state.replace(height=state.height * u, rate_mean=state.rate_mean / u), base


def _k_slide_node_ultra(state, uni, tune, node, aux, par, topo, braces):
    """Truncated-normal slide of one inner node between its highest child
    and its parent."""
    h = state.heights
    hi = h[:, node]
    hp = h[:, int(topo.parent[node])]
    hnew, lq = _tn(uni, hi, par, tune, _max_child_height(h, topo, node), hp)
    return state.replace(heights=_set_col(h, node, hnew)), lq


def _k_scale_subtree_ultra(state, uni, tune, node, aux, par, topo, braces):
    """Rescale the node heights of the sub tree; Jacobian xi^(n_inner - 1)."""
    h = state.heights
    hi = h[:, node]
    hp = h[:, int(topo.parent[node])]
    hnew, lq = _tn(uni, hi, par, tune, 0.0, hp)
    xi = hnew / hi
    h2 = _scale_cols(h, node, int(topo.subtree_end[node]), xi)
    n_inner = int(topo.n_inner_subtree[node])
    return state.replace(heights=h2), lq + (n_inner - 1) * torch.log(xi)


def _k_pulley_ultra(state, uni, tune, node, aux, par, topo, braces):
    """Pulley at the root: one root subtree moves up, the other down."""
    l, r = topo.root_children
    h = state.heights
    ht, hl, hr = h[:, 0], h[:, l], h[:, r]
    brl, brr = ht - hl, ht - hr
    a = -torch.minimum(brl, hr)
    b = torch.minimum(brr, hl)
    u, lq = _tn(uni, 0.0, par, tune, a, b)
    xil, xir = (hl - u) / hl, (hr + u) / hr
    h2 = _scale_cols(h, l, int(topo.subtree_end[l]), xil)
    h2[:, r:int(topo.subtree_end[r])] = h[:, r:int(topo.subtree_end[r])] * xir[:, None]
    nl = int(topo.n_inner_subtree[l])
    nr = int(topo.n_inner_subtree[r])
    log_jac = (nl - 1) * torch.log(xil) + (nr - 1) * torch.log(xir)
    return state.replace(heights=h2), lq + log_jac


def _k_scale_branch_rate(state, g, tune, node, aux, par, topo, braces):
    u, base, logu = _gs(g, par, tune)
    rates = _set_col(state.rates, node, state.rates[:, node] * u)
    return state.replace(rates=rates), base + logu


def _k_scale_subtree_rate(state, g, tune, node, aux, par, topo, braces):
    """Scale all branches of the sub tree including its stem."""
    u, base, logu = _gs(g, par, tune)
    rates = _scale_cols(state.rates, node, int(topo.subtree_end[node]), u)
    n = int(topo.n_nodes_subtree[node])
    return state.replace(rates=rates), base + n * logu


def _k_scale_norm_rate_tree_contra(state, g, tune, node, aux, par, topo, braces):
    """rateMean / u, branches (without stem) * u."""
    u, base, logu = _gs(g, par, tune)
    rates = _scale_cols(state.rates, 1, topo.n, u)
    n = topo.n - 1
    return state.replace(rate_mean=state.rate_mean / u, rates=rates), base + (n - 1) * logu


def _k_scale_norm_height_rate_tree_contra(state, g, tune, node, aux, par, topo, braces):
    """timeHeight / u, branches (without stem) * u."""
    u, base, logu = _gs(g, par, tune)
    rates = _scale_cols(state.rates, 1, topo.n, u)
    n = topo.n - 1
    return state.replace(height=state.height / u, rates=rates), base + (n - 1) * logu


def _k_scale_var_rate_tree(state, g, tune, node, aux, par, topo, braces):
    """Variance * u^2, branches spread around their sample mean; log
    determinant (n + 1) log u (see the JAX kernel's derivation)."""
    u, base, logu = _gs(g, par, tune)
    n = topo.n - 1
    r = state.rates
    mean = (_mean(g, torch.sum(torch.where(topo.non_root_t, r, 0.0), dim=1) / n))[:, None]
    rates_new = (r - mean) * u[:, None] + mean
    ok = torch.all(rates_new[:, 1:] > 0, dim=1)
    rates = r.clone()
    rates[:, 1:] = rates_new[:, 1:]
    log_mhg = torch.where(ok, base + (n + 1) * logu, NEG_INF)
    return state.replace(rate_var=state.rate_var * u * u, rates=rates), log_mhg


def _k_scale_var_rate_tree_autocorr(state, g, tune, node, aux, par, topo, braces):
    """Differences to the rate mean scaled by u: r' = mu + u (r - mu);
    log determinant (n + 2) log u."""
    u, base, logu = _gs(g, par, tune)
    n = topo.n - 1
    mu = state.rate_mean[:, None]
    rates_new = mu + u[:, None] * (state.rates - mu)
    ok = torch.all(rates_new[:, 1:] > 0, dim=1)
    rates = state.rates.clone()
    rates[:, 1:] = rates_new[:, 1:]
    log_mhg = torch.where(ok, base + (n + 2) * logu, NEG_INF)
    return state.replace(rate_var=state.rate_var * u * u, rates=rates), log_mhg


def _k_slide_nodes_contra(state, uni, tune, node, aux, par, topo, braces):
    """Slide a time-tree node and rescale the adjacent rate-tree branches
    inversely, so expected substitutions stay constant."""
    i = node
    h = state.heights
    hi = h[:, i]
    hp = h[:, int(topo.parent[i])]
    ch = _children(topo, i)
    hch = h[:, ch]
    hnew, lq = _tn(uni, hi, par, tune, hch.amax(dim=1), hp)
    xi_stem = (hp - hi) / (hp - hnew)
    xi_ch = (hi[:, None] - hch) / (hnew[:, None] - hch)
    rates = _set_col(state.rates, i, state.rates[:, i] * xi_stem)
    rates[:, ch] = state.rates[:, ch] * xi_ch
    log_jac = torch.log(xi_stem) + torch.sum(torch.log(xi_ch), dim=1)
    return state.replace(heights=_set_col(h, i, hnew), rates=rates), lq + log_jac


def _k_scale_subtrees_contra(state, uni, tune, node, aux, par, topo, braces):
    """Scale the time sub tree by xi, the rate sub tree (without its stem)
    by 1/xi and the rate stem by (hp - h)/(hp - h')."""
    i = node
    end = int(topo.subtree_end[i])
    h = state.heights
    hi = h[:, i]
    hp = h[:, int(topo.parent[i])]
    hnew, lq = _tn(uni, hi, par, tune, 0.0, hp)
    xi = hnew / hi
    xi_stem = (hp - hi) / (hp - hnew)
    h2 = _scale_cols(h, i, end, xi)
    rates = state.rates.clone()
    rates[:, i + 1:end] = state.rates[:, i + 1:end] / xi[:, None]
    rates[:, i] = state.rates[:, i] * xi_stem
    n_inner = int(topo.n_inner_subtree[i])
    n_branches = int(topo.n_nodes_subtree[i])
    log_jac = (n_inner - n_branches) * torch.log(xi) + torch.log(xi_stem)
    return state.replace(heights=h2, rates=rates), lq + log_jac


def _k_slide_root_contra(state, uni, tune, node, aux, par, topo, braces):
    """Slide the absolute height H -> H u, divide the relative inner node
    heights by u and rescale the root-adjacent rates by (1 - h_j)/(u - h_j)."""
    h = state.heights
    ht = state.height
    ch = _children(topo, 0)
    hch = h[:, ch]
    ht_new, lq = _tn(uni, ht, par, tune, ht * hch.amax(dim=1), math.inf)
    u = ht_new / ht
    inner = [int(i) for i in topo.inner_nodes if i != 0]
    h2 = h.clone()
    h2[:, inner] = h[:, inner] / u[:, None]
    xi = (1.0 - hch) / (u[:, None] - hch)
    rates = state.rates.clone()
    rates[:, ch] = state.rates[:, ch] * xi
    n_scaled = int((~topo.is_leaf).sum()) - 1
    log_jac = -n_scaled * torch.log(u) + torch.sum(torch.log(xi), dim=1)
    return state.replace(height=ht_new, heights=h2, rates=rates), lq + log_jac


def _k_scale_rates_time_tree_contra(state, uni, tune, node, aux, par, topo, braces):
    """Scale all non-root node heights by xi, divide the birth rate and the
    rate mean by xi."""
    h = state.heights
    h_mc = h[:, _children(topo, 0)].amax(dim=1)
    h_new, lq = _tn(uni, h_mc, par, tune, 0.0, h[:, 0])
    xi = h_new / h_mc
    h2 = _scale_cols(h, 1, topo.n, xi)
    n_nodes = int((~topo.is_leaf).sum()) - 1
    log_jac = (n_nodes - 1 - 2) * torch.log(xi)
    new = state.replace(heights=h2, birth=state.birth / xi, rate_mean=state.rate_mean / xi)
    return new, lq + log_jac


def _brace_nodes(braces, b):
    return [int(x) for x in braces.node[b] if x >= 0]


def _brace_bounds(h, topo, nodes):
    hi = h[:, nodes]
    hp = h[:, [int(topo.parent[i]) for i in nodes]]
    hc = torch.stack([_max_child_height(h, topo, i) for i in nodes], dim=1)
    return (hc - hi).amax(dim=1), (hp - hi).amin(dim=1)


def _k_slide_braced_ultra(state, uni, tune, node, aux, par, topo, braces):
    """One common height delta for all braced nodes, bounded by the
    intersection of their intervals; Jacobian 1."""
    nodes = _brace_nodes(braces, aux)
    lo, hi = _brace_bounds(state.heights, topo, nodes)
    delta, lq = _tn(uni, 0.0, par, tune, lo, hi)
    h2 = state.heights.clone()
    h2[:, nodes] = state.heights[:, nodes] + delta[:, None]
    return state.replace(heights=h2), lq


def _k_slide_braced_contra(state, uni, tune, node, aux, par, topo, braces):
    """The braced slide plus inverse rate compensation per braced node."""
    nodes = _brace_nodes(braces, aux)
    h = state.heights
    lo, hi = _brace_bounds(h, topo, nodes)
    delta, lq = _tn(uni, 0.0, par, tune, lo, hi)
    h2 = h.clone()
    h2[:, nodes] = h[:, nodes] + delta[:, None]
    rates = state.rates.clone()
    log_jac = torch.zeros_like(delta)
    for i in nodes:
        hi_k = h[:, i]
        hp_k = h[:, int(topo.parent[i])]
        xi_stem = (hp_k - hi_k) / (hp_k - hi_k - delta)
        ch = _children(topo, i)
        hch = h[:, ch]
        xi_ch = (hi_k[:, None] - hch) / (hi_k[:, None] + delta[:, None] - hch)
        rates[:, i] = rates[:, i] * xi_stem
        rates[:, ch] = rates[:, ch] * xi_ch
        log_jac = log_jac + torch.log(xi_stem) + torch.sum(torch.log(xi_ch), dim=1)
    return state.replace(heights=h2, rates=rates), lq + log_jac


KERNELS = {
    K_SCALE_SCALAR: _k_scale_scalar,
    K_SCALE_HEIGHT_RATEMEAN_CONTRA: _k_scale_height_ratemean_contra,
    K_SLIDE_NODE_ULTRA: _k_slide_node_ultra,
    K_SCALE_SUBTREE_ULTRA: _k_scale_subtree_ultra,
    K_PULLEY_ULTRA: _k_pulley_ultra,
    K_SCALE_BRANCH_RATE: _k_scale_branch_rate,
    K_SCALE_SUBTREE_RATE: _k_scale_subtree_rate,
    K_SCALE_NORM_RATE_TREE_CONTRA: _k_scale_norm_rate_tree_contra,
    K_SCALE_VAR_RATE_TREE: _k_scale_var_rate_tree,
    K_SCALE_VAR_RATE_TREE_AUTOCORR: _k_scale_var_rate_tree_autocorr,
    K_SLIDE_NODES_CONTRA: _k_slide_nodes_contra,
    K_SCALE_SUBTREES_CONTRA: _k_scale_subtrees_contra,
    K_SLIDE_ROOT_CONTRA: _k_slide_root_contra,
    K_SCALE_NORM_HEIGHT_RATE_TREE_CONTRA: _k_scale_norm_height_rate_tree_contra,
    K_SCALE_RATES_TIME_TREE_CONTRA: _k_scale_rates_time_tree_contra,
    K_SLIDE_BRACED_ULTRA: _k_slide_braced_ultra,
    K_SLIDE_BRACED_CONTRA: _k_slide_braced_contra,
}
