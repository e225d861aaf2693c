"""K6 ``contra_step``: one mega-step of distance-invariant contrary moves,
fused, in two modes with a wrapper each.

``contra_slide`` replaces the XLA-compiled step of
``FastSweeps._mega_contra_slide`` (``mcmcdate_tpu/engine/fast_sweep.py:1223-1322``):
for each chain and each ticket of the step (nodes with no parent-child pair
among them) the truncated-normal slide of the node between its oldest
child and its parent, the inverse rate factors of its stem and child
branches, the new birth-death, clock and calibration terms it touches, the
accept, and the in-place write-back of heights, rates, terms and accept
counts.  ``contra_range`` replaces ``FastSweeps._mega_range_contra``
(``:1566-1694``): the same for a block of tickets that scale disjoint
subtrees by ``xi`` (heights inside by ``xi``, rates inside by ``1/xi``,
the stem rate by ``(h_p - h)/(h_p - h')``), with the terms of every node
of the subtree.  The tickets of a step read and write disjoint entries, so
every (chain, ticket) pair is independent.

On the H100 both are bound by their special functions (ndtr, ndtri,
log_ndtr, lgamma and the double-precision birth-death exp/log per touched
node); their bytes are a few gathered floats per (chain, ticket) and
touched node.  The kernels (``csrc/contra_step.cu``) keep every
intermediate in registers, one launch per step in place of the plain
version's ~150: the slide mode runs a thread per chain and tile of its
tickets (instantiated for the two children of a binary tree; a generic
kernel takes other steps), the range mode a group of lanes per (chain,
ticket) (:func:`group_width`: a
power of 2 up to a warp, about ``ROWS_PER_LANE`` rows a lane), its lanes
striding over the subtree's rows (at most 8 a lane) and summing with
shuffles.

Both wrappers return a :class:`ContraOut`: besides the accept mask, each
ticket's log acceptance ratio and the proposal it drew, so that a check
can replay the kernel's proposals through the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..ops import clocks
from ..ops.dists import bold_tune, truncated_normal_draw, truncated_normal_lq
from ..ops.local_terms import (
    NEG_INF,
    cal_range_terms,
    is_bad,
    range_gather,
    range_scaled,
    slide_terms,
    sum_valid,
)
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SLIDE_ARGTYPES = (
    (_P,) * 4  # heights, rates, terms, acc
    + (_P,) * 5  # tuning, birth, death, rate_var, height
    + (_P,) * 7  # node, par, ch, t_rows, rows, valid, sd
    + (_P,) * 4  # cal_lo, cal_lo_s, cal_hi, cal_hi_s
    + (_P,) * 8  # is_leaf, u_prop, u_acc, beta_prior, accept, log_alpha, h_prop, lq
    + (_I,) * 9  # C, B, N, T, P, KC, KT, KN, clock_model
    + (_P,)  # stream
)
_RANGE_ARGTYPES = (
    (_P,) * 4  # heights, rates, terms, acc
    + (_P,) * 5  # tuning, birth, death, rate_var, height
    + (_P,) * 9  # node, par, own, own_par, rows, valid, sd, n_inner, n_nodes
    + (_P,) * 6  # cal_t_rows, cal_hsrc, cal_lo, cal_lo_s, cal_hi, cal_hi_s
    + (_P,) * 8  # is_leaf, u_prop, u_acc, beta_prior, accept, log_alpha, h_prop, lq
    + (_P, ctypes.c_float, ctypes.c_float)  # u_bold, bold_p, bold_factor
    + (_I,) * 9  # C, S, N, T, P, RB, KN, clock_model, width
    + (_P,)  # stream
)
KT_MAX = 64  # touched terms per ticket the slide kernel holds in registers
# Range rows a lane of the group takes (up to 8): every lane also evaluates
# the ticket's proposal, about 3 rows' work, so 4 rows a lane measured
# fastest on all three buckets (PERF.md).
ROWS_PER_LANE = 4
CAL_PER_LANE = 4  # calibration slots a lane holds
ROWS_MAX = 8 * 32  # subtree rows per ticket the range kernel holds (8 per lane)
CAL_MAX = CAL_PER_LANE * 32  # calibration slots per ticket the range kernel holds
# The range blocks' row buckets (``engine.fast_sweep.RANGE_BUCKETS``): a
# block's rows (its largest subtree) fall in one of them, by which the
# range launches are counted too (``contra_range.launches_by_rows``).
ROW_BUCKETS = (16, 64, 256)


class ContraOut(NamedTuple):
    """What a contrary step decided, per chain and ticket ``[C, B]``."""

    accept: torch.Tensor     # bool
    log_alpha: torch.Tensor  # log acceptance ratio (-inf where rejected outright)
    h_prop: torch.Tensor     # proposed height of the ticket's node
    lq: torch.Tensor         # log proposal-density ratio of that proposal


def contra_slide_plain(state, terms, acc, tuning, sx, is_leaf, clock, u_prop, u_acc,
                       beta_prior=None):
    """Plain PyTorch version of :func:`contra_slide` (updates in place)."""
    h, ch = state.heights, sx["ch"]
    hc_max = torch.where(ch >= 0, h[:, torch.clamp(ch, min=0)], NEG_INF).amax(dim=-1)
    hnew = truncated_normal_draw(u_prop, h[:, sx["node"]], sx["sd"], tuning[:, sx["rows"]],
                                 hc_max, h[:, sx["par"]])
    return contra_slide_given(state, terms, acc, tuning, sx, is_leaf, clock, hnew, u_acc,
                              beta_prior)


def contra_slide_given(state, terms, acc, tuning, sx, is_leaf, clock, hnew, u_acc,
                       beta_prior=None):
    """The plain slide step at given proposed node heights ``hnew`` ``[C,
    B]`` (so a check can replay the kernel's own proposals)."""
    node, par, ch, valid = sx["node"], sx["par"], sx["ch"], sx["valid"]
    t_rows, rows = sx["t_rows"], sx["rows"]
    h, r = state.heights, state.rates
    hi = h[:, node]                                      # [C, B]
    hp = h[:, par]
    ch_ok = ch >= 0                                      # [B, KC]
    ch_i = torch.clamp(ch, min=0)
    hch = h[:, ch_i]                                     # [C, B, KC]
    hc_max = torch.where(ch_ok, hch, NEG_INF).amax(dim=-1)
    lq = truncated_normal_lq(hi, sx["sd"], tuning[:, rows], hc_max, hp, hnew)
    xi_stem = (hp - hi) / (hp - hnew)
    xi_ch = torch.where(ch_ok, (hi[..., None] - hch) / (hnew[..., None] - hch), 1.0)
    log_jac = torch.log(xi_stem) + torch.sum(torch.where(ch_ok, torch.log(xi_ch), 0.0), dim=-1)
    r_i_new = r[:, node] * xi_stem
    r_ch_new = r[:, ch_i] * torch.where(ch_ok, xi_ch, 1.0)
    tn = slide_terms(clock, state, is_leaf, sx, hnew, hp, hch, r_i_new, r_ch_new)
    t_ok = t_rows >= 0
    t_safe = torch.clamp(t_rows, min=0)
    told = terms[:, t_safe]
    d_pr = sum_valid(torch.where(t_ok, tn - told, 0.0))
    invalid = torch.any(t_ok & is_bad(tn), dim=-1)
    if beta_prior is not None:
        d_pr = beta_prior[:, None] * d_pr
    log_alpha = torch.where(invalid, NEG_INF, d_pr + lq + log_jac)
    log_alpha = torch.where(valid & ~torch.isnan(log_alpha), log_alpha, NEG_INF)
    accept = (torch.log(u_acc) < log_alpha) & valid      # [C, B]
    # Pad slots index entry 0 (root) and write back its own old value.
    h[:, node] = torch.where(accept, hnew, hi)
    r[:, node] = torch.where(accept, r_i_new, r[:, node])
    r[:, ch_i] = torch.where(accept[..., None] & ch_ok, r_ch_new, r[:, ch_i])
    terms[:, t_safe] = torch.where(accept[..., None] & t_ok, tn, told)
    acc.index_add_(1, rows, accept.to(acc.dtype))
    return ContraOut(accept, log_alpha, hnew, lq)


def contra_range_plain(state, terms, acc, tuning, sx, is_leaf, clock, u_prop, u_acc,
                       beta_prior=None, u_bold=None, bold_p=0.0, bold_factor=8.0):
    """Plain PyTorch version of :func:`contra_range` (updates in place)."""
    h = state.heights
    tune = bold_tune(tuning[:, sx["rows"]], u_bold, bold_p, bold_factor)
    hnew = truncated_normal_draw(u_prop, h[:, sx["node"]], sx["sd"], tune, 0.0,
                                 h[:, sx["par"]])
    return contra_range_given(state, terms, acc, tuning, sx, is_leaf, clock, hnew, u_acc,
                              beta_prior, u_bold, bold_p, bold_factor)


def contra_range_given(state, terms, acc, tuning, sx, is_leaf, clock, hnew, u_acc,
                       beta_prior=None, u_bold=None, bold_p=0.0, bold_factor=8.0):
    """The plain range step at given proposed subtree-root heights, as
    :func:`contra_slide_given`."""
    N = state.heights.shape[1]
    h, r = state.heights, state.rates
    node, par, valid, rows = sx["node"], sx["par"], sx["valid"], sx["rows"]
    hi = h[:, node]                                      # [C, S]
    hp = h[:, par]
    tune = bold_tune(tuning[:, rows], u_bold, bold_p, bold_factor)
    lq = truncated_normal_lq(hi, sx["sd"], tune, 0.0, hp, hnew)
    xi = hnew / hi
    xi_stem = (hp - hi) / (hp - hnew)
    rg = range_gather(state, sx)
    own_ok, own_s, is_root, h_own, _, r_own = rg
    r_new = torch.where(is_root, r_own * xi_stem[..., None], r_own / xi[..., None])
    h_new, bd_new, ck_new = range_scaled(clock, state, is_leaf, rg, xi, r_new)
    t_bd = 4 + own_s
    t_ck = 4 + (N + 1) + own_s
    bd_old = terms[:, t_bd]
    ck_old = terms[:, t_ck]
    d_pr = sum_valid(torch.where(own_ok, (bd_new - bd_old) + (ck_new - ck_old), 0.0))
    invalid = torch.any(own_ok & (is_bad(bd_new) | is_bad(ck_new)), dim=-1)
    knr = sx["cal_t_rows"].shape[-1]
    if knr:
        cal_ok, cal_safe, cal_new, cal_old, dpc, invc = cal_range_terms(state, terms, sx, xi)
        d_pr = d_pr + dpc
        invalid = invalid | invc
    log_jac = (sx["n_inner"] - sx["n_nodes"]) * torch.log(xi) + torch.log(xi_stem)
    if beta_prior is not None:
        d_pr = beta_prior[:, None] * d_pr
    log_alpha = d_pr + lq + log_jac
    log_alpha = torch.where(invalid | ~valid | torch.isnan(log_alpha), NEG_INF, log_alpha)
    accept = (torch.log(u_acc) < log_alpha) & valid      # [C, S]
    am = accept[..., None] & own_ok
    # Pad rows index node 0 (root) and write back its own old values.
    h[:, own_s] = torch.where(am, h_new, h_own)
    r[:, own_s] = torch.where(am, r_new, r_own)
    terms[:, t_bd] = torch.where(am, bd_new, bd_old)
    terms[:, t_ck] = torch.where(am, ck_new, ck_old)
    if knr:
        terms[:, cal_safe] = torch.where(accept[..., None] & cal_ok, cal_new, cal_old)
    acc.index_add_(1, rows, accept.to(acc.dtype))
    return ContraOut(accept, log_alpha, hnew, lq)


def group_width(rows: int, cal: int) -> int:
    """Lanes per (chain, ticket) of the range kernel: enough for
    ``ROWS_PER_LANE`` rows and ``CAL_PER_LANE`` calibration slots a lane, a
    power of 2, at most a warp."""
    width = 1
    while width < 32 and (width * ROWS_PER_LANE < rows or width * CAL_PER_LANE < cal):
        width *= 2
    return width


def _check_inputs(state, terms, acc, tuning, sx, is_leaf, u_prop, u_acc, ints):
    for name, t in (("heights", state.heights), ("rates", state.rates), ("terms", terms),
                    ("tuning", tuning), ("birth", state.birth), ("death", state.death),
                    ("rate_var", state.rate_var), ("height", state.height), ("sd", sx["sd"]),
                    ("u_prop", u_prop), ("u_acc", u_acc)):
        build.require_cuda(t, name, torch.float32)
    for name in ints:
        build.require_cuda(sx[name], name, torch.int32)
    build.require_cuda(acc, "acc", torch.int32)
    # The step's valid slots, the leaf flags and the accept mask are bool
    # tensors, which the kernels read and write as bytes 0 / 1: no
    # conversion at each call.
    for name, t in (("valid", sx["valid"]), ("is_leaf", is_leaf)):
        build.require_cuda(t, name, torch.bool)


def _outputs(C, B, device):
    """The kernel's accept mask and its three float outputs."""
    return (torch.empty((C, B), dtype=torch.bool, device=device),
            *(torch.empty((C, B), dtype=torch.float32, device=device) for _ in range(3)))


def contra_slide(state, terms, acc, tuning, sx, is_leaf, clock, u_prop, u_acc, beta_prior=None):
    """One mega-step of contrary node slides on every chain, in place:
    ``state`` heights and rates, ``terms`` ``[C, T]`` and ``acc`` ``[C, P]``.
    ``sx`` holds the point step's plan arrays (``node, par, ch, valid,
    t_rows, rows, sd, cal_*``), ``u_prop`` and ``u_acc`` the
    truncated-normal and accept uniforms ``[C, B]``, ``beta_prior`` the
    chains' prior temperature ``[C]`` (None: 1), which tempers each
    ticket's prior delta (``log alpha = beta_prior d_pr + lq + log_jac``,
    the JAX step's ``fast_sweep.py:1302-1304``).  Returns a
    :class:`ContraOut`.  The plain version runs for CPU tensors, kernel K6
    for CUDA tensors (float32)."""
    if terms.device.type == "cpu":
        return contra_slide_plain(state, terms, acc, tuning, sx, is_leaf, clock, u_prop, u_acc,
                                  beta_prior)
    C, N = state.heights.shape
    B, KC = sx["ch"].shape
    KT = sx["t_rows"].shape[-1]
    KN = sx["cal_lo"].shape[-1]
    if KT > KT_MAX:
        raise ValueError(f"contra_slide: {KT} touched terms per ticket, the kernel holds {KT_MAX}")
    _check_inputs(state, terms, acc, tuning, sx, is_leaf, u_prop, u_acc,
                  ("node", "par", "ch", "t_rows", "rows"))
    cal = [sx[k].contiguous() if KN else None for k in ("cal_lo", "cal_lo_s", "cal_hi",
                                                        "cal_hi_s")]
    accept, log_alpha, h_prop, lq = _outputs(C, B, terms.device)
    p = build.ptr
    err = build.bind("mcmcdate_contra_slide_f32", _SLIDE_ARGTYPES)(
        p(state.heights), p(state.rates), p(terms), p(acc), p(tuning), p(state.birth),
        p(state.death), p(state.rate_var), p(state.height), p(sx["node"]), p(sx["par"]),
        p(sx["ch"]), p(sx["t_rows"]), p(sx["rows"]), p(sx["valid"]), p(sx["sd"]), *map(p, cal),
        p(is_leaf), p(u_prop), p(u_acc), p(build.beta_arg(beta_prior, C, terms.device)),
        p(accept), p(log_alpha), p(h_prop), p(lq), C, B, N, terms.shape[1], acc.shape[1], KC,
        KT, KN, clocks.MODELS.index(clock), build.stream_ptr(terms.device),
    )
    build.check(err, "contra_slide kernel")
    contra_slide.launches += 1
    return ContraOut(accept, log_alpha, h_prop, lq)


def contra_range(state, terms, acc, tuning, sx, is_leaf, clock, u_prop, u_acc, beta_prior=None,
                 u_bold=None, bold_p=0.0, bold_factor=8.0):
    """One block of contrary subtree scales on every chain, in place, as
    :func:`contra_slide`; ``sx`` holds the range block's plan arrays
    (``node, par, own, own_par, rows, valid, sd, n_inner, n_nodes,
    cal_*``), with the prior delta tempered by ``beta_prior`` (the JAX
    step's ``fast_sweep.py:1674-1675``) and, where ``u_bold`` ``[C, S]`` is
    given, the bold mixture: a ticket whose ``u_bold < bold_p`` takes a
    ``bold_factor`` times wider kernel (``ops.dists.bold_tune``; None: off, the
    kernel then runs as without the mixture).  Returns a :class:`ContraOut`
    ``[C, S]``.  The plain version runs for CPU tensors, kernel K6's range
    mode for CUDA tensors (float32)."""
    if terms.device.type == "cpu":
        return contra_range_plain(state, terms, acc, tuning, sx, is_leaf, clock, u_prop, u_acc,
                                  beta_prior, u_bold, bold_p, bold_factor)
    C, N = state.heights.shape
    S, RB = sx["own"].shape
    KN = sx["cal_t_rows"].shape[-1]
    if RB > ROWS_MAX or KN > CAL_MAX:
        raise ValueError(f"contra_range: {RB} rows and {KN} calibration slots per ticket, the "
                         f"kernel holds {ROWS_MAX} and {CAL_MAX}")
    _check_inputs(state, terms, acc, tuning, sx, is_leaf, u_prop, u_acc,
                  ("node", "par", "own", "own_par", "rows", "n_inner", "n_nodes", "cal_t_rows",
                   "cal_hsrc"))
    cal = [sx[k] if KN else None for k in ("cal_t_rows", "cal_hsrc", "cal_lo", "cal_lo_s",
                                           "cal_hi", "cal_hi_s")]
    if u_bold is not None:
        build.require_cuda(u_bold, "u_bold", torch.float32)
        if u_bold.shape != u_acc.shape:
            raise ValueError(f"contra_range: u_bold of {tuple(u_bold.shape)}, expected "
                             f"{tuple(u_acc.shape)}")
    accept, log_alpha, h_prop, lq = _outputs(C, S, terms.device)
    p = build.ptr
    err = build.bind("mcmcdate_contra_range_f32", _RANGE_ARGTYPES)(
        p(state.heights), p(state.rates), p(terms), p(acc), p(tuning), p(state.birth),
        p(state.death), p(state.rate_var), p(state.height), p(sx["node"]), p(sx["par"]),
        p(sx["own"]), p(sx["own_par"]), p(sx["rows"]), p(sx["valid"]), p(sx["sd"]),
        p(sx["n_inner"]), p(sx["n_nodes"]), *map(p, cal),
        p(is_leaf), p(u_prop), p(u_acc), p(build.beta_arg(beta_prior, C, terms.device)),
        p(accept), p(log_alpha), p(h_prop), p(lq), p(u_bold), float(bold_p), float(bold_factor),
        C, S, N, terms.shape[1], acc.shape[1], RB, KN, clocks.MODELS.index(clock),
        group_width(RB, KN), build.stream_ptr(terms.device),
    )
    build.check(err, "contra_range kernel")
    contra_range.launches += 1
    contra_range.launches_bold += u_bold is not None
    bucket = next(b for b in ROW_BUCKETS if RB <= b)
    contra_range.launches_by_rows[bucket] += 1
    return ContraOut(accept, log_alpha, h_prop, lq)


contra_slide.launches = 0
contra_range.launches = 0
contra_range.launches_bold = 0  # the launches with the bold mixture's uniforms
contra_range.launches_by_rows = dict.fromkeys(ROW_BUCKETS, 0)
