"""K5's likelihood range-block step around the Gram-and-scan kernel
(``range_scan``): ``range_lik_prologue`` and ``range_lik_epilogue``.

Together with :func:`~.range_scan.range_scan` and one product for the
``z`` update they replace the XLA-compiled ``FastSweeps._mega_range_lik``
(``mcmcdate_tpu/engine/fast_sweep.py:1695-1909``): a block of S tickets
that each scale a disjoint subtree (its RB pre-order rows), ultrametric
(heights inside by ``f = h'/h``, truncated-normal proposal) or rate (rates
inside by a gamma factor ``f``).

- ``range_lik_prologue`` (kernel ``range_lik_prologue_kernel``): from the
  injected draw, the proposal (``prop``: the new subtree-root height, or
  the rate factor), its log proposal ratio ``lq``, the rows' new heights or
  rates and their birth-death, clock and calibration terms, the prior delta
  ``d_pr``, ``lmhg`` (``-inf`` where a term is invalid), ``coef = f - 1``,
  and the rank-1 delta directions ``g`` with the carried ``z`` at their
  rows ``zg`` (with a likelihood).
- ``range_lik_epilogue`` (kernel ``range_lik_epilogue_kernel``): the
  write-back of the accepted tickets: heights or rates, terms, ``d += dacc``,
  ``q += sum of accepted dq``, the accept counts, and ``dacc`` ``[C, S RB]``
  for the ``z`` update ``z += dacc @ Prow``.  Without a likelihood there
  is no scan: the epilogue takes the decisions itself, ``log u < d_pr +
  lmhg``, and leaves ``q``.

On the H100 both are bound by their special functions (the inverse normal
CDF or lgamma per ticket, the double-precision birth-death exp/log and a
gamma or log-normal density per row); their bytes are a few gathered
floats per row.  The prologue kernel (``csrc/range_step.cu``) takes a
group of lanes per (chain, ticket), as many as the block's rows rounded up
to a power of 2 and at most a warp, its lanes striding over the subtree's
rows (and calibration slots) and reducing ``d_pr`` with shuffles: a thread
per (chain, ticket) walking 256-row subtrees serially is what holds K6's
range mode at a few percent of its bound.  Every lane evaluates the
ticket's proposal, so no lane waits for another.  The prologue writes each
row's new values, so the epilogue only selects and stores (one warp per
(chain, ticket), its lanes over the rows; ``q`` summed in a fixed order).
Both mirror their plain versions operation by operation (built with
``-fmad=false``), with CUDA's normal CDF and its inverse in place of
PyTorch's: a proposal may differ from the plain one in its last bits, so
the checks on the card replay the kernel's proposals through
:func:`range_lik_given`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..ops import clocks
from ..ops.dists import gamma_scale_lq, gamma_scale_sample, truncated_normal_draw, \
    truncated_normal_lq
from ..ops.local_terms import (
    NEG_INF,
    cal_range_terms,
    clock_term_local,
    is_bad,
    prior_accept,
    range_gather,
    range_scaled,
    sum_valid,
)
from . import build
from .range_scan import range_scan_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_PROLOGUE_ARGTYPES = (
    (_P,) * 5  # heights, rates, terms, d, z
    + (_P,) * 6  # tuning, birth, death, rate_var, height, rate_mean
    + (_P,) * 10  # node, par, own, own_par, d_flat, rows, valid, sd, n_inner, n_nodes
    + (_P,) * 6  # cal_t_rows, cal_hsrc, cal_lo, cal_lo_s, cal_hi, cal_hi_s
    + (_P,) * 2  # is_leaf, draw
    + (_P,) * 11  # prop, lq, coef, d_pr, lmhg, g, zg, x_new, bd_new, ck_new, cal_new
    + (_I,) * 10  # C, S, N, T, P, D, RB, KN, clock_model, rate
    + (_P,)  # stream
)
_EPILOGUE_ARGTYPES = (
    (_P,) * 7  # heights, rates, terms, d, q, acc, dacc
    + (_P,) * 11  # accept, dq, u_acc, d_pr, lmhg, coef, g, x_new, bd_new, ck_new, cal_new
    + (_P,) * 5  # own, d_flat, rows, valid, cal_t_rows
    + (_I,) * 9  # C, S, N, T, P, D, RB, KN, rate
    + (_P,)  # stream
)


class RangeProposal(NamedTuple):
    """What the prologue computes per chain and ticket ``[C, S]`` and per
    row ``[C, S, RB]`` (calibration slots ``[C, S, KN]``)."""

    prop: torch.Tensor    # proposed subtree-root height (ultrametric) or rate factor
    lq: torch.Tensor      # log proposal ratio, with the Jacobian's log f terms
    coef: torch.Tensor    # f - 1 (0 on pad slots)
    d_pr: torch.Tensor    # prior delta
    lmhg: torch.Tensor    # lq, or -inf where a new term is invalid or the slot a pad
    g: torch.Tensor       # rank-1 delta direction of the rows' distances (0 on pad rows)
    zg: Optional[torch.Tensor]  # carried z at the rows (None without a likelihood)
    x_new: torch.Tensor   # the rows' new heights (ultrametric) or rates (rate)
    bd_new: Optional[torch.Tensor]  # new birth-death terms (ultrametric; None for rate)
    ck_new: torch.Tensor  # new clock terms
    cal_new: torch.Tensor  # new calibration terms of the calibrated nodes inside


def range_proposal(rate, state, tuning, sx, draw):
    """The proposal of each ticket from its draw: the truncated-normal
    uniform (ultrametric: the subtree root's new height) or the standard
    gamma variate (rate: the factor)."""
    tune = tuning[:, sx["rows"]]
    if rate:
        return gamma_scale_sample(draw, sx["sd"], tune)[0]
    h = state.heights
    return truncated_normal_draw(draw, h[:, sx["node"]], sx["sd"], tune, 0.0, h[:, sx["par"]])


def range_lik_prologue_plain(rate, state, terms, d, z, tuning, sx, is_leaf, clock, draw):
    """Plain PyTorch version of :func:`range_lik_prologue`."""
    prop = range_proposal(rate, state, tuning, sx, draw)
    return range_lik_prologue_given(rate, state, terms, d, z, tuning, sx, is_leaf, clock, prop)


def range_lik_prologue_given(rate, state, terms, d, z, tuning, sx, is_leaf, clock, prop):
    """The plain prologue at given proposals ``prop`` ``[C, S]`` (so a check
    can replay the kernel's own proposals)."""
    N = state.heights.shape[1]
    h = state.heights
    node, par, valid, rows, sd = sx["node"], sx["par"], sx["valid"], sx["rows"], sx["sd"]
    C, S = prop.shape
    tune = tuning[:, rows]
    rg = range_gather(state, sx)
    own_ok, own_s, is_root, h_own, hpar_own, r_own = rg
    RB = own_s.shape[-1]
    d_flat = sx["d_flat"]
    d_old_g = d[:, d_flat].reshape(C, S, RB)
    var = state.rate_var[:, None, None]
    if rate:
        f = prop
        base, logu = gamma_scale_lq(f, sd, tune)
        lq = base + sx["n_nodes"] * logu
        x_new = r_own * f[..., None]
        bd_new = None
        ck_new = clock_term_local(clock, x_new, hpar_own - h_own, var)
        t_news = ((4 + (N + 1) + own_s, ck_new),)
        g = torch.where(own_ok, d_old_g, 0.0)
    else:
        hi = h[:, node]
        lq = truncated_normal_lq(hi, sd, tune, 0.0, h[:, par], prop)
        f = prop / hi                                     # xi  [C, S]
        lq = lq + (sx["n_inner"] - 1) * torch.log(f)
        x_new, bd_new, ck_new = range_scaled(clock, state, is_leaf, rg, f, r_own)
        t_news = ((4 + own_s, bd_new), (4 + (N + 1) + own_s, ck_new))
        # The subtree root's own branch keeps its parent: its delta is
        # (f - 1) times -scale * r * h.
        height_rm = (state.height * state.rate_mean)[:, None, None]
        g = torch.where(is_root, -height_rm * r_own * h_own, d_old_g)
        g = torch.where(own_ok, g, 0.0)

    d_pr = torch.zeros_like(f)
    invalid = torch.zeros_like(valid).expand(C, S)
    for t_rows_k, tn_k in t_news:
        d_pr = d_pr + sum_valid(torch.where(own_ok, tn_k - terms[:, t_rows_k], 0.0))
        invalid = invalid | torch.any(own_ok & is_bad(tn_k), dim=-1)
    knr = 0 if rate else sx["cal_t_rows"].shape[-1]
    if knr:
        _, _, cal_new, _, dpc, invc = cal_range_terms(state, terms, sx, f)
        d_pr = d_pr + dpc
        invalid = invalid | invc
    else:
        cal_new = f.new_zeros((C, S, 0))
    lmhg = torch.where(invalid | ~valid, NEG_INF, lq)
    # Pad slots (sd = 0) draw f = NaN; their coefficient is 0, so the
    # scan's cross terms with them are 0 and not NaN.  (The JAX step
    # keeps the NaN, and then rejects every ticket of a padded block.)
    coef = torch.where(valid, f - 1.0, 0.0)
    zg = None
    if z is not None:
        zg = (z[:, d_flat] * own_ok.reshape(-1).to(z.dtype)).reshape(C, S, RB)
    return RangeProposal(prop, lq, coef, d_pr, lmhg, g, zg, x_new, bd_new, ck_new, cal_new)


def range_lik_epilogue_plain(rate, state, terms, d, q, acc, sx, pro, accept, dq, u_acc=None):
    """Plain PyTorch version of :func:`range_lik_epilogue` (updates in
    place; ``dq`` None skips ``q``)."""
    N = state.heights.shape[1]
    if accept is None:
        accept = prior_accept(pro.d_pr, pro.lmhg, u_acc)
    accept = accept & sx["valid"]
    own_ok = sx["own"] >= 0
    own_s = torch.clamp(sx["own"], min=0)
    am = accept[..., None] & own_ok
    # Pad rows index node 0 (the root, in no subtree) and write back its
    # own old values.
    if rate:
        state.rates[:, own_s] = torch.where(am, pro.x_new, state.rates[:, own_s])
    else:
        state.heights[:, own_s] = torch.where(am, pro.x_new, state.heights[:, own_s])
        terms[:, 4 + own_s] = torch.where(am, pro.bd_new, terms[:, 4 + own_s])
        if pro.cal_new.shape[-1]:
            cal_ok = sx["cal_t_rows"] >= 0
            cal_safe = torch.clamp(sx["cal_t_rows"], min=0)
            terms[:, cal_safe] = torch.where(accept[..., None] & cal_ok, pro.cal_new,
                                             terms[:, cal_safe])
    t_ck = 4 + (N + 1) + own_s
    terms[:, t_ck] = torch.where(am, pro.ck_new, terms[:, t_ck])
    dacc = torch.where(am, pro.coef[..., None] * pro.g, 0.0).reshape(accept.shape[0], -1)
    # Tickets of a block touch disjoint rows and pad rows add zero.
    d.index_add_(1, sx["d_flat"], dacc)
    if dq is not None:
        q += torch.sum(torch.where(accept, dq, 0.0), dim=-1)
    acc.index_add_(1, sx["rows"], accept.to(acc.dtype))
    return accept, dacc


def range_lik_given(rate, state, terms, d, z, q, acc, tuning, sx, is_leaf, clock, prop, u_acc):
    """The whole plain step at given proposals: prologue, scan, epilogue and
    the ``z`` update, in place.  Returns ``(accept, proposal, dq)``."""
    pro = range_lik_prologue_given(rate, state, terms, d, z, tuning, sx, is_leaf, clock, prop)
    accept, dq = range_scan_plain(pro.g, pro.zg, sx["Q"], pro.coef, pro.d_pr, pro.lmhg, u_acc)
    accept, dacc = range_lik_epilogue_plain(rate, state, terms, d, q, acc, sx, pro, accept, dq)
    z.addmm_(dacc, sx["Prow"])
    return accept, pro, dq


def range_lik_prologue(rate, state, terms, d, z, tuning, sx, is_leaf, clock, draw):
    """The prologue of a likelihood range block on every chain: returns a
    :class:`RangeProposal`.  ``rate`` picks the rate kind (else
    ultrametric); ``sx`` holds the block's plan arrays (``node, par, own,
    own_par, d_flat, rows, valid, sd, n_inner, n_nodes, cal_*``); ``draw``
    ``[C, S]`` is the truncated-normal uniform or the standard gamma
    variate.  The plain version runs for CPU tensors, the kernel for CUDA
    tensors (float32).  Without a likelihood ``z`` is None, and so is the
    proposal's ``zg``."""
    if terms.device.type == "cpu":
        return range_lik_prologue_plain(rate, state, terms, d, z, tuning, sx, is_leaf, clock,
                                        draw)
    C, N = state.heights.shape
    S, RB = sx["own"].shape
    KN = 0 if rate else sx["cal_t_rows"].shape[-1]
    for name, t in (("heights", state.heights), ("rates", state.rates), ("terms", terms),
                    ("d", d), ("z", z), ("tuning", tuning), ("birth", state.birth),
                    ("death", state.death), ("rate_var", state.rate_var),
                    ("height", state.height), ("rate_mean", state.rate_mean),
                    ("sd", sx["sd"]), ("draw", draw)):
        if t is not None:
            build.require_cuda(t, name, torch.float32)
    for name in ("node", "par", "own", "own_par", "d_flat", "rows", "n_inner", "n_nodes",
                 "cal_t_rows", "cal_hsrc"):
        build.require_cuda(sx[name], name, torch.int32)
    for name, t in (("valid", sx["valid"]), ("is_leaf", is_leaf)):
        build.require_cuda(t, name, torch.bool)  # read as bytes 0 / 1
    cal = [sx[k] if KN else None for k in ("cal_t_rows", "cal_hsrc", "cal_lo", "cal_lo_s",
                                           "cal_hi", "cal_hi_s")]
    dev = terms.device

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    pro = RangeProposal(out(C, S), out(C, S), out(C, S), out(C, S), out(C, S), out(C, S, RB),
                        None if z is None else out(C, S, RB), out(C, S, RB),
                        None if rate else out(C, S, RB),
                        out(C, S, RB), out(C, S, KN))
    p = build.ptr
    err = build.bind("mcmcdate_range_lik_prologue_f32", _PROLOGUE_ARGTYPES)(
        p(state.heights), p(state.rates), p(terms), p(d), p(z), p(tuning), p(state.birth),
        p(state.death), p(state.rate_var), p(state.height), p(state.rate_mean),
        p(sx["node"]), p(sx["par"]), p(sx["own"]), p(sx["own_par"]), p(sx["d_flat"]),
        p(sx["rows"]), p(sx["valid"]), p(sx["sd"]), p(sx["n_inner"]), p(sx["n_nodes"]),
        *map(p, cal), p(is_leaf), p(draw), *map(p, pro),
        C, S, N, terms.shape[1], tuning.shape[1], d.shape[1], RB, KN,
        clocks.MODELS.index(clock), int(bool(rate)), build.stream_ptr(dev),
    )
    build.check(err, "range_lik_prologue kernel")
    range_lik_prologue.launches += 1
    return pro


def range_lik_epilogue(rate, state, terms, d, q, acc, sx, pro, accept, dq, u_acc=None):
    """The write-back of a likelihood range block on every chain, in place:
    heights (ultrametric) or rates (rate), terms, ``d``, ``q`` and the accept
    counts ``acc`` of the accepted tickets (``accept``, ``dq`` from
    :func:`~.range_scan.range_scan`, ``pro`` from the prologue; pad slots
    never accept, their ``lmhg`` is ``-inf``).  Without a likelihood
    ``accept`` and ``dq`` are None and the accept uniforms ``u_acc`` are
    given: the epilogue decides, ``log u < d_pr + lmhg``, and leaves ``q``.
    Returns ``(accept, dacc [C, S RB])`` with ``dacc`` the accepted distance
    deltas at the block's rows (``d_flat``).  The plain version runs for
    CPU tensors, the kernel for CUDA tensors (float32)."""
    if terms.device.type == "cpu":
        return range_lik_epilogue_plain(rate, state, terms, d, q, acc, sx, pro, accept, dq,
                                        u_acc)
    C, N = state.heights.shape
    S, RB = sx["own"].shape
    KN = pro.cal_new.shape[-1]
    if (accept is None) == (u_acc is None) or (u_acc is not None and dq is not None):
        raise ValueError("range_lik_epilogue takes accept and dq, or u_acc alone")
    for name, t in (("heights", state.heights), ("rates", state.rates), ("terms", terms),
                    ("d", d), ("q", q), ("dq", dq), ("u_acc", u_acc), ("d_pr", pro.d_pr),
                    ("lmhg", pro.lmhg), ("coef", pro.coef), ("g", pro.g),
                    ("x_new", pro.x_new), ("ck_new", pro.ck_new), ("cal_new", pro.cal_new)):
        if t is not None:
            build.require_cuda(t, name, torch.float32)
    build.require_cuda(acc, "acc", torch.int32)
    for name in ("own", "d_flat", "rows", "cal_t_rows"):
        build.require_cuda(sx[name], name, torch.int32)
    if accept is None:
        accept = torch.empty((C, S), dtype=torch.bool, device=terms.device)  # the kernel's
    for name, t in (("valid", sx["valid"]), ("accept", accept)):
        build.require_cuda(t, name, torch.bool)
    dacc = torch.empty((C, S * RB), dtype=torch.float32, device=terms.device)
    p = build.ptr
    err = build.bind("mcmcdate_range_lik_epilogue_f32", _EPILOGUE_ARGTYPES)(
        p(state.heights), p(state.rates), p(terms), p(d), p(q), p(acc), p(dacc), p(accept), p(dq),
        p(u_acc), p(pro.d_pr), p(pro.lmhg), p(pro.coef), p(pro.g), p(pro.x_new), p(pro.bd_new),
        p(pro.ck_new), p(pro.cal_new),
        p(sx["own"]), p(sx["d_flat"]), p(sx["rows"]), p(sx["valid"]), p(sx["cal_t_rows"]),
        C, S, N, terms.shape[1], acc.shape[1], d.shape[1], RB, KN, int(bool(rate)),
        build.stream_ptr(terms.device),
    )
    build.check(err, "range_lik_epilogue kernel")
    range_lik_epilogue.launches += 1
    return accept, dacc


range_lik_prologue.launches = 0
range_lik_epilogue.launches = 0
