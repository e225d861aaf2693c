"""Local (per-node) prior terms: gathered-operand versions of the term
blocks of ``DatingModel``, elementwise over any shape.

Port of ``bd_term_local``, ``_cal_terms_local`` and ``clock_term_local``
of ``mcmcdate_tpu/engine/fast_sweep.py``, plus the terms of a node slide
and the rows of a subtree-range block; the batched sweep steps and their
kernels' plain versions evaluate the terms a ticket touches with them.
"""

from __future__ import annotations

import math

import torch

from . import birth_death as BD
from . import clocks as CK
from .dists import gamma_mean_variance_logpdf, log_normal_mean_param_logpdf

NEG_INF = -math.inf


def bd_term_local(h_node, h_parent, is_leaf, la, mu):
    """Birth-death log term of a non-root node from its and its parent's
    heights (``birth_death_terms`` with rho = 1).  Evaluated in float64
    whatever the dtype and rounded once, as the full term block and kernel
    K1 are (see ``ops/birth_death.py``)."""
    dtype = h_node.dtype
    f64 = torch.float64
    h_node = h_node.to(f64)
    h_parent = h_parent.to(f64)
    la = la.to(f64)
    mu = mu.to(f64)
    dt = h_parent - h_node
    _, e_at = BD._de_factors(la, mu, torch.zeros_like(h_node), h_node)
    c = torch.where(torch.as_tensor(is_leaf, device=h_node.device), 0.0, e_at)
    log_d, _ = BD._de_factors(la, mu, c, dt)
    log_d = torch.where(dt > 0, log_d, NEG_INF)
    log_boundary = torch.where(torch.as_tensor(is_leaf, device=h_node.device), 0.0,
                               torch.log(la))
    return (log_d + log_boundary).to(dtype)


def cal_terms_local(h_new, height, lo, lo_s, hi, hi_s):
    """Soft-calibration log term(s) of a node at relative height ``h_new``
    under the absolute-height multiplier ``height``; ``lo``/``hi`` are
    absolute bounds, ``*_s`` the tail sigmas ``sqrt(2/pi) * pm``.  All
    arguments broadcast (rows of ``calibrate_constrain_brace_terms``)."""
    lo_rel = lo / height
    hi_rel = hi / height
    below = torch.clamp(lo_rel - h_new, min=0.0)
    above = torch.clamp(h_new - hi_rel, min=0.0)
    s_lo_safe = torch.where(lo_s > 0, lo_s, 1.0)
    s_hi_safe = torch.where(hi_s > 0, hi_s, 1.0)
    return -0.5 * (below / s_lo_safe) ** 2 - 0.5 * torch.where(
        torch.isfinite(hi_rel), (above / s_hi_safe) ** 2, 0.0)


def clock_term_local(model_clock, r, t, var):
    """Relaxed-clock log term of one branch (``relaxed_clock_terms`` body,
    mean 1)."""
    if model_clock == CK.UNCORRELATED_GAMMA:
        return gamma_mean_variance_logpdf(1.0, var, r)
    if model_clock == CK.UNCORRELATED_LOG_NORMAL:
        return log_normal_mean_param_logpdf(1.0, var, r)
    ts = torch.where(t > 0, t, 1.0)
    if model_clock == CK.UNCORRELATED_WHITE_NOISE:
        lp = gamma_mean_variance_logpdf(1.0, var / ts, r)
    elif model_clock == CK.AUTOCORRELATED_GAMMA:
        lp = gamma_mean_variance_logpdf(1.0, var * ts, r)
    elif model_clock == CK.AUTOCORRELATED_LOG_NORMAL:
        lp = log_normal_mean_param_logpdf(1.0, var * ts, r)
    else:
        raise ValueError(model_clock)
    return torch.where(t > 0, lp, NEG_INF)


def sum_valid(diff):
    """Sum over the last axis with NaN entries counted as 0."""
    return torch.sum(torch.where(torch.isnan(diff), 0.0, diff), dim=-1)


def is_bad(x):
    """NaN or -inf: a term that rejects the proposal."""
    return torch.isnan(x) | torch.isneginf(x)


def prior_accept(d_pr, lmhg, u_acc, beta_prior=None):
    """The decisions of a step without a likelihood: ``log u < beta_prior
    d_pr + lmhg`` (``beta_prior`` ``[C]``, None: 1), a NaN log alpha
    rejecting."""
    if beta_prior is not None:
        d_pr = beta_prior[:, None] * d_pr
    log_alpha = d_pr + lmhg
    return torch.log(u_acc) < torch.where(torch.isnan(log_alpha), NEG_INF, log_alpha)


def slide_terms(clock, state, is_leaf, sx, hnew, hp, hch, r_node, r_ch):
    """New terms of a point step's node slides ``[C, B, KT]``, in the order
    of ``sx["t_rows"]``: the node's birth-death and clock terms at its new
    height ``hnew`` under its parent's ``hp`` with rate ``r_node``, each
    child's at heights ``hch`` and rates ``r_ch`` ``[C, B, KC]`` (0 for pad
    children), then the node's calibration terms."""
    ch = sx["ch"]
    ch_ok = ch >= 0
    ch_i = torch.clamp(ch, min=0)
    kc = ch.shape[-1]
    la = state.birth[:, None]
    mu = state.death[:, None]
    var = state.rate_var[:, None]
    new = [bd_term_local(hnew, hp, False, la, mu),
           clock_term_local(clock, r_node, hp - hnew, var)]
    for j in range(kc):
        new.append(torch.where(
            ch_ok[:, j], bd_term_local(hch[:, :, j], hnew, is_leaf[ch_i[:, j]], la, mu), 0.0))
    for j in range(kc):
        new.append(torch.where(
            ch_ok[:, j], clock_term_local(clock, r_ch[:, :, j], hnew - hch[:, :, j], var), 0.0))
    kn = sx["t_rows"].shape[-1] - 2 * (1 + kc)
    if kn:
        lp_cal = cal_terms_local(hnew[..., None], state.height[:, None, None], sx["cal_lo"],
                                 sx["cal_lo_s"], sx["cal_hi"], sx["cal_hi_s"])
        new += [lp_cal[..., j] for j in range(kn)]
    return torch.stack(new, dim=-1)


def range_gather(state, sx):
    """The rows of a subtree-range block (``sx["own"]`` ``[S, RB]``, -1
    pad): ``(own_ok, own_s, is_root, h_own, hpar_own, r_own)`` with the
    mask, the clamped rows, the subtree-root flags and the rows' heights,
    parent heights and rates ``[C, S, RB]``."""
    h, r = state.heights, state.rates
    own = sx["own"]
    own_ok = own >= 0
    own_s = torch.clamp(own, min=0)
    is_root = own == sx["node"][:, None]
    return (own_ok, own_s, is_root, h[:, own_s], h[:, torch.clamp(sx["own_par"], min=0)],
            r[:, own_s])


def range_scaled(clock, state, is_leaf, rg, xi, r_new):
    """A range block's rows (``rg``, from :func:`range_gather`) when each
    ticket's subtree scales its heights by ``xi`` ``[C, S]`` (the subtree
    root keeps its parent) and the rows take the rates ``r_new``:
    ``(h_new, bd_new, ck_new)`` ``[C, S, RB]``."""
    _, own_s, is_root, h_own, hpar_own, _ = rg
    xi_e = xi[..., None]
    h_new = xi_e * h_own
    hpar_new = torch.where(is_root, hpar_own, xi_e * hpar_own)
    bd_new = bd_term_local(h_new, hpar_new, is_leaf[own_s], state.birth[:, None, None],
                           state.death[:, None, None])
    ck_new = clock_term_local(clock, r_new, hpar_new - h_new, state.rate_var[:, None, None])
    return h_new, bd_new, ck_new


def cal_range_terms(state, terms, sx, f):
    """New calibration terms of the calibrated nodes inside each range of a
    block, whose heights scale by the ticket's factor ``f`` ``[C, S]``:
    ``(cal_ok, cal_safe, cal_new, cal_old, d_pr, invalid)``."""
    cal_ok = sx["cal_t_rows"] >= 0                         # [S, KN]
    cal_safe = torch.clamp(sx["cal_t_rows"], min=0)
    h_src = state.heights[:, torch.clamp(sx["cal_hsrc"], min=0)]  # [C, S, KN]
    cal_new = cal_terms_local(f[..., None] * h_src, state.height[:, None, None],
                               sx["cal_lo"], sx["cal_lo_s"], sx["cal_hi"], sx["cal_hi_s"])
    cal_old = terms[:, cal_safe]
    d_pr = sum_valid(torch.where(cal_ok, cal_new - cal_old, 0.0))
    invalid = torch.any(cal_ok & is_bad(cal_new), dim=-1)
    return cal_ok, cal_safe, cal_new, cal_old, d_pr, invalid
