"""K4's point mega-step around the correction scan (``point_scan``):
``point_lik_prologue`` and ``point_lik_epilogue``.

Together with :func:`~.point_scan.point_scan` and one product for the ``z``
update they replace the XLA-compiled ``FastSweeps._mega_point_lik``
(``mcmcdate_tpu/engine/fast_sweep.py:1324-1565``): a step of B tickets on
nodes with no parent-child pair among them, each a truncated-normal slide
of the node's height between its oldest child and its parent (the node
kind) or a gamma scale of its branch rate (the branch kind), touching the
distance rows of the node's branch and, for a slide, its children's (KD
rows in all, ``d_rows``).

- ``point_lik_prologue`` (kernel ``point_lik_prologue_kernel``): from the
  injected draw, the proposal (``prop``: the new height, or the rate
  factor), its log proposal ratio ``lq``, the new terms ``tn`` at the
  step's term rows, the distance deltas ``delta``, the prior delta
  ``d_pr``, ``lmhg`` (``-inf`` where a term is invalid or the slot a pad)
  and, with a likelihood, the carried ``z`` at the distance rows ``zG``.
- ``point_lik_epilogue`` (kernel ``point_lik_epilogue_kernel``): the
  write-back of the accepted tickets: heights or rates, terms, ``d +=
  dacc``, ``q += sum of accepted dq``, the accept counts, and ``dacc``
  ``[C, B KD]`` for the ``z`` update ``z += dacc @ Prow``.  Without a
  likelihood there is no scan: the epilogue takes the decisions itself,
  ``log u < d_pr + lmhg``, and leaves ``q``.

On the H100 both are bound by their special functions (the inverse normal
CDF or lgamma, and the double-precision birth-death exp/log of up to 1 + KC
nodes, per ticket); their bytes are a few gathered floats per (chain,
ticket).  The prologue kernel (``csrc/point_step.cu``) takes a thread per
(chain, ticket); the epilogue a lane per (chain, ticket), the first warp
of each chain summing ``q`` over its tickets in a fixed order.  Both mirror their
plain versions operation by operation (built with ``-fmad=false``), with
CUDA's normal CDF and its inverse in place of PyTorch's: a slide's
proposal may differ from the plain one in its last bits, so the checks on
the card replay the kernel's proposals through :func:`point_lik_given`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..ops import clocks
from ..ops.dists import gamma_scale_lq, gamma_scale_sample, truncated_normal_draw, \
    truncated_normal_lq
from ..ops.local_terms import NEG_INF, clock_term_local, is_bad, prior_accept, slide_terms, \
    sum_valid
from . import build
from .point_scan import point_scan_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_PROLOGUE_ARGTYPES = (
    (_P,) * 5  # heights, rates, terms, d, z
    + (_P,) * 6  # tuning, birth, death, rate_var, height, rate_mean
    + (_P,) * 8  # node, par, ch, t_rows, d_rows, rows, valid, sd
    + (_P,) * 4  # cal_lo, cal_lo_s, cal_hi, cal_hi_s
    + (_P,) * 3  # is_leaf, pos, draw
    + (_P,) * 7  # prop, lq, tn, delta, d_pr, lmhg, zG
    + (_I,) * 12  # C, B, N, T, P, D, KC, KT, KD, KN, clock_model, branch
    + (_P,)  # stream
)
KT_MAX = 64  # touched terms per ticket the prologue kernel holds in registers
_EPILOGUE_ARGTYPES = (
    (_P,) * 7  # heights, rates, terms, d, q, acc, dacc
    + (_P,) * 8  # accept, dq, u_acc, d_pr, lmhg, prop, tn, delta
    + (_P,) * 5  # node, t_rows, d_rows, rows, valid
    + (_I,) * 9  # C, B, N, T, P, D, KT, KD, branch
    + (_P,)  # stream
)


class PointProposal(NamedTuple):
    """What the prologue computes per chain and ticket ``[C, B]``."""

    prop: torch.Tensor    # the node's proposed height (slide) or the rate factor (branch)
    lq: torch.Tensor      # log proposal ratio
    tn: torch.Tensor      # new terms at the step's term rows [C, B, KT] (0 at pad rows)
    delta: torch.Tensor   # distance deltas at the step's rows [C, B, KD] (0 at pad rows)
    d_pr: torch.Tensor    # prior delta
    lmhg: torch.Tensor    # lq, or -inf where a new term is invalid or the slot a pad
    zG: Optional[torch.Tensor]  # carried z at the rows [C, B KD] (None without a likelihood)


def point_proposal(branch, state, tuning, sx, draw):
    """The proposal of each ticket from its draw: the truncated-normal
    uniform (slide: the node's new height between its oldest child and its
    parent) or the standard gamma variate (branch: the rate factor)."""
    tune = tuning[:, sx["rows"]]
    if branch:
        return gamma_scale_sample(draw, sx["sd"], tune)[0]
    h, ch = state.heights, sx["ch"]
    hc_max = torch.where(ch >= 0, h[:, torch.clamp(ch, min=0)], NEG_INF).amax(dim=-1)
    return truncated_normal_draw(draw, h[:, sx["node"]], sx["sd"], tune, hc_max, h[:, sx["par"]])


def point_lik_prologue_plain(branch, state, terms, d, z, tuning, sx, is_leaf, pos, clock, draw):
    """Plain PyTorch version of :func:`point_lik_prologue`."""
    prop = point_proposal(branch, state, tuning, sx, draw)
    return point_lik_prologue_given(branch, state, terms, d, z, tuning, sx, is_leaf, pos, clock,
                                    prop)


def point_lik_prologue_given(branch, state, terms, d, z, tuning, sx, is_leaf, pos, clock, prop):
    """The plain prologue at given proposals ``prop`` ``[C, B]`` (so a check
    can replay the kernel's own proposals)."""
    h, r = state.heights, state.rates
    node, par, ch, valid = sx["node"], sx["par"], sx["ch"], sx["valid"]
    t_rows, d_rows, sd = sx["t_rows"], sx["d_rows"], sx["sd"]
    kc, kd, kt = ch.shape[-1], d_rows.shape[-1], t_rows.shape[-1]
    tune = tuning[:, sx["rows"]]
    var = state.rate_var[:, None]
    d_ok = d_rows >= 0
    d_old = d[:, torch.clamp(d_rows, min=0)]                    # [C, B, KD]
    if branch:
        base, logu = gamma_scale_lq(prop, sd, tune)
        lq = base + logu
        tn0 = clock_term_local(clock, r[:, node] * prop, h[:, par] - h[:, node], var)[..., None]
        tn = torch.cat([tn0, tn0.new_zeros(tn0.shape[:-1] + (kt - 1,))], dim=-1)
        d_new = torch.where(d_ok, d_old * prop[..., None], d_old)
    else:
        hnew, hi, hp = prop, h[:, node], h[:, par]
        ch_ok = ch >= 0
        ch_i = torch.clamp(ch, min=0)
        hch = h[:, ch_i]                                        # [C, B, KC]
        hc_max = torch.where(ch_ok, hch, NEG_INF).amax(dim=-1)
        lq = truncated_normal_lq(hi, sd, tune, hc_max, hp, hnew)
        tn = slide_terms(clock, state, is_leaf, sx, hnew, hp, hch, r[:, node], r[:, ch_i])
        # New distance rows: the node's own branch gets t = hp - hnew, a
        # child c's branch t = hnew - h_c; d = scale * t * r.
        sc = (state.height * state.rate_mean)[:, None]
        pos_i = pos[node]
        d_new = d_old.clone()
        for slot in range(kd):
            is_i = d_rows[:, slot] == pos_i
            t_val = torch.where(is_i, hp - hnew, 0.0)
            r_val = torch.where(is_i, r[:, node], 0.0)
            for j in range(kc):
                cj = ch_i[:, j]
                owns = (d_rows[:, slot] == pos[cj]) & ch_ok[:, j]
                t_val = torch.where(owns, hnew - h[:, cj], t_val)
                r_val = torch.where(owns, r[:, cj], r_val)
            d_new[:, :, slot] = torch.where(d_ok[:, slot], sc * t_val * r_val, d_old[:, :, slot])
    delta = torch.where(d_ok, d_new - d_old, 0.0)
    t_ok = t_rows >= 0
    d_pr = sum_valid(torch.where(t_ok, tn - terms[:, torch.clamp(t_rows, min=0)], 0.0))
    invalid = torch.any(t_ok & is_bad(tn), dim=-1)
    lmhg = torch.where(invalid | ~valid, NEG_INF, lq)
    zG = None
    if z is not None:
        zG = z[:, sx["d_flat"]] * d_ok.reshape(-1).to(z.dtype)
    return PointProposal(prop, lq, tn, delta, d_pr, lmhg, zG)


def point_lik_epilogue_plain(branch, state, terms, d, q, acc, sx, pro, accept, dq, u_acc=None):
    """Plain PyTorch version of :func:`point_lik_epilogue` (updates in
    place; ``dq`` None skips ``q``)."""
    if accept is None:
        accept = prior_accept(pro.d_pr, pro.lmhg, u_acc)
    accept = accept & sx["valid"]
    node, t_rows = sx["node"], sx["t_rows"]
    a = accept[..., None]
    # Pad slots index node 0 (the root, in no step) and write back its own
    # old value.
    if branch:
        state.rates[:, node] = torch.where(accept, state.rates[:, node] * pro.prop,
                                           state.rates[:, node])
    else:
        state.heights[:, node] = torch.where(accept, pro.prop, state.heights[:, node])
    t_safe = torch.clamp(t_rows, min=0)
    terms[:, t_safe] = torch.where(a & (t_rows >= 0), pro.tn, terms[:, t_safe])
    dacc = torch.where(a & (sx["d_rows"] >= 0), pro.delta, 0.0).reshape(accept.shape[0], -1)
    # Tickets of a step touch disjoint rows and pad rows add zero.
    d.index_add_(1, sx["d_flat"], dacc)
    if dq is not None:
        q += torch.sum(torch.where(accept, dq, 0.0), dim=-1)
    acc.index_add_(1, sx["rows"], accept.to(acc.dtype))
    return accept, dacc


def point_lik_given(branch, state, terms, d, z, q, acc, tuning, sx, is_leaf, pos, clock, prop,
                    u_acc):
    """The whole plain step at given proposals: prologue, scan, epilogue and
    the ``z`` update, in place.  Returns ``(accept, proposal, dq)``."""
    pro = point_lik_prologue_given(branch, state, terms, d, z, tuning, sx, is_leaf, pos, clock,
                                   prop)
    accept, dq = point_scan_plain(pro.delta, pro.zG, sx["Pblk"], pro.d_pr, pro.lmhg, u_acc)
    accept, dacc = point_lik_epilogue_plain(branch, state, terms, d, q, acc, sx, pro, accept, dq)
    z.addmm_(dacc, sx["Prow"])
    return accept, pro, dq


def point_lik_prologue(branch, state, terms, d, z, tuning, sx, is_leaf, pos, clock, draw):
    """The prologue of a likelihood point step on every chain: returns a
    :class:`PointProposal`.  ``branch`` picks the branch-rate kind (else the
    node slide); ``sx`` holds the step's plan arrays (``node, par, ch,
    t_rows, d_rows, d_flat, rows, valid, sd, cal_*``); ``pos`` ``[N]`` is
    each node's distance row; ``draw`` ``[C, B]`` is the truncated-normal
    uniform or the standard gamma variate.  The plain version runs for CPU
    tensors, the kernel for CUDA tensors (float32).  Without a likelihood
    ``z`` is None, and so is the proposal's ``zG``."""
    if terms.device.type == "cpu":
        return point_lik_prologue_plain(branch, state, terms, d, z, tuning, sx, is_leaf, pos,
                                        clock, draw)
    C, N = state.heights.shape
    B, KC = sx["ch"].shape
    KT, KD = sx["t_rows"].shape[-1], sx["d_rows"].shape[-1]
    KN = sx["cal_lo"].shape[-1]
    if KT > KT_MAX:
        raise ValueError(f"point_lik_prologue: {KT} touched terms per ticket, the kernel holds "
                         f"{KT_MAX}")
    for name, t in (("heights", state.heights), ("rates", state.rates), ("terms", terms),
                    ("d", d), ("z", z), ("tuning", tuning), ("birth", state.birth),
                    ("death", state.death), ("rate_var", state.rate_var),
                    ("height", state.height), ("rate_mean", state.rate_mean),
                    ("sd", sx["sd"]), ("draw", draw)):
        if t is not None:
            build.require_cuda(t, name, torch.float32)
    for name in ("node", "par", "ch", "t_rows", "d_rows", "rows"):
        build.require_cuda(sx[name], name, torch.int32)
    build.require_cuda(pos, "pos", torch.int32)
    for name, t in (("valid", sx["valid"]), ("is_leaf", is_leaf)):
        build.require_cuda(t, name, torch.bool)  # read as bytes 0 / 1
    cal = [sx[k] if KN else None for k in ("cal_lo", "cal_lo_s", "cal_hi", "cal_hi_s")]
    dev = terms.device

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    pro = PointProposal(out(C, B), out(C, B), out(C, B, KT), out(C, B, KD), out(C, B),
                        out(C, B), None if z is None else out(C, B * KD))
    p = build.ptr
    err = build.bind("mcmcdate_point_lik_prologue_f32", _PROLOGUE_ARGTYPES)(
        p(state.heights), p(state.rates), p(terms), p(d), p(z), p(tuning), p(state.birth),
        p(state.death), p(state.rate_var), p(state.height), p(state.rate_mean),
        p(sx["node"]), p(sx["par"]), p(sx["ch"]), p(sx["t_rows"]), p(sx["d_rows"]),
        p(sx["rows"]), p(sx["valid"]), p(sx["sd"]), *map(p, cal), p(is_leaf), p(pos), p(draw),
        *map(p, pro), C, B, N, terms.shape[1], tuning.shape[1], d.shape[1], KC, KT, KD, KN,
        clocks.MODELS.index(clock), int(bool(branch)), build.stream_ptr(dev),
    )
    build.check(err, "point_lik_prologue kernel")
    point_lik_prologue.launches += 1
    return pro


def point_lik_epilogue(branch, state, terms, d, q, acc, sx, pro, accept, dq, u_acc=None):
    """The write-back of a likelihood point step on every chain, in place:
    heights (slide) or rates (branch), terms, ``d``, ``q`` and the accept
    counts ``acc`` of the accepted tickets (``accept``, ``dq`` from
    :func:`~.point_scan.point_scan`, ``pro`` from the prologue; pad slots
    never accept, their ``lmhg`` is ``-inf``).  Without a likelihood
    ``accept`` and ``dq`` are None and the accept uniforms ``u_acc`` are
    given: the epilogue decides, ``log u < d_pr + lmhg``, and leaves ``q``.
    Returns ``(accept, dacc [C, B KD])`` with ``dacc`` the accepted
    distance deltas at the step's rows (``d_flat``).  The plain version
    runs for CPU tensors, the kernel for CUDA tensors (float32)."""
    if terms.device.type == "cpu":
        return point_lik_epilogue_plain(branch, state, terms, d, q, acc, sx, pro, accept, dq,
                                        u_acc)
    C, N = state.heights.shape
    B, KT = sx["t_rows"].shape
    KD = sx["d_rows"].shape[-1]
    if (accept is None) == (u_acc is None) or (u_acc is not None and dq is not None):
        raise ValueError("point_lik_epilogue takes accept and dq, or u_acc alone")
    for name, t in (("heights", state.heights), ("rates", state.rates), ("terms", terms),
                    ("d", d), ("q", q), ("dq", dq), ("u_acc", u_acc), ("d_pr", pro.d_pr),
                    ("lmhg", pro.lmhg), ("prop", pro.prop), ("tn", pro.tn),
                    ("delta", pro.delta)):
        if t is not None:
            build.require_cuda(t, name, torch.float32)
    build.require_cuda(acc, "acc", torch.int32)
    for name in ("node", "t_rows", "d_rows", "rows"):
        build.require_cuda(sx[name], name, torch.int32)
    if accept is None:
        accept = torch.empty((C, B), dtype=torch.bool, device=terms.device)  # the kernel's
    for name, t in (("valid", sx["valid"]), ("accept", accept)):
        build.require_cuda(t, name, torch.bool)
    dacc = torch.empty((C, B * KD), dtype=torch.float32, device=terms.device)
    p = build.ptr
    err = build.bind("mcmcdate_point_lik_epilogue_f32", _EPILOGUE_ARGTYPES)(
        p(state.heights), p(state.rates), p(terms), p(d), p(q), p(acc), p(dacc), p(accept),
        p(dq), p(u_acc), p(pro.d_pr), p(pro.lmhg), p(pro.prop), p(pro.tn), p(pro.delta),
        p(sx["node"]), p(sx["t_rows"]), p(sx["d_rows"]), p(sx["rows"]), p(sx["valid"]), C, B, N,
        terms.shape[1], acc.shape[1], d.shape[1], KT, KD, int(bool(branch)),
        build.stream_ptr(terms.device),
    )
    build.check(err, "point_lik_epilogue kernel")
    point_lik_epilogue.launches += 1
    return accept, dacc


point_lik_prologue.launches = 0
point_lik_epilogue.launches = 0
