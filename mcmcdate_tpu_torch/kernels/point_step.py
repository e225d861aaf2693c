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
  ``log u < beta_prior d_pr + lmhg`` (the chain's prior temperature), and
  leaves ``q``.

On the H100 the prologue is bound by its instructions and a long dependent
path per (chain, ticket) pair: its plan, one round of gathers from the
chain's rows, then its special functions (the inverse normal CDF or
lgamma, and the double-precision birth-death exp/log of up to 1 + KC
nodes); its bytes are a few gathered floats per pair.  The epilogue is
bound by a few dependent rounds of scattered reads and writes in each
chain's rows.  The kernels (``csrc/point_step.cu``):

- Each step's plan is packed once, when ``FastSweeps`` is built, into one
  record of ``W`` int32 words a ticket (:func:`point_plan`, ``sx["kplan"]``):
  node, parent, tuning row, flags (valid, each child's leaf bit), ``sd``'s
  bits, ``ch``, ``t_rows``, ``d_rows`` and each distance slot's owner (0
  the node's own branch, 1 + j child j's, -1 none).  A pair reads its
  record through L1.
- The prologue is instantiated for the main path's shapes with their
  sizes at compile time, their arrays in registers: the binary slide (KC =
  2, KT = 6, KD = 3; it spills 16 bytes under the register cap below) and
  the branch scale (KT = 6, KD = 1), neither with a calibration slot; a
  generic instantiation takes every other step (multifurcating trees,
  calibrated slides).  A CTA of 128 threads (at
  most 64 registers a thread, 8 CTAs an SM) takes a contiguous range of
  (chain, ticket) pairs in the outputs' chain-major order, a pair a
  thread per round, the fewest rounds that fit the step into one wave: a
  warp's lanes take neighbouring tickets of one chain.  The CTA forms each
  chain's constants once (``BdConsts``, ``GammaClock``: the same
  operations, so the terms stay bitwise); each pair issues all its gathers
  first; each warp stores its round's ``tn``, ``delta`` and ``zG`` from
  shared memory as 16-byte words.
- The epilogue takes a CTA per chain and a thread per ticket: its
  decision, its distance slots, its height or rate, terms and accept count,
  and its part of ``q``, summed by a block reduction in a fixed order.

Both mirror their plain versions operation by operation (built with
``-fmad=false``), with CUDA's normal CDF and its inverse in place of
PyTorch's: a slide's proposal may differ from the plain one in its last
bits, so the checks on the card replay the kernel's proposals through
:func:`point_lik_given`.

To time the two kernels of a checkout against another's on the card (the
other unpacked with ``git archive`` into a git-ignored directory, in turns
P / C / C / P): ``python3 mcmcdate_tpu_torch/tools/phase_time.py --phase
kernels [--root DIR]``.
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
    + (_P,) * 5  # plan, cal_lo, cal_lo_s, cal_hi, cal_hi_s
    + (_P,) * 1  # draw
    + (_P,) * 7  # prop, lq, tn, delta, d_pr, lmhg, zG
    + (_I,) * 13  # C, B, N, T, P, D, KC, KT, KD, KN, W, clock_model, branch
    + (_P,)  # stream
)
KT_MAX = 64  # touched terms per ticket the prologue kernel holds
KC_MAX = (KT_MAX - 2) // 2  # children per ticket (a flag bit each)
# The fields of a ticket's plan record (point_plan), then ch [KC], t_rows
# [KT], d_rows [KD] and the distance slots' owners [KD].
PLAN_NODE, PLAN_PAR, PLAN_ROW, PLAN_FLAGS, PLAN_SD, PLAN_HEAD = range(6)
_EPILOGUE_ARGTYPES = (
    (_P,) * 7  # heights, rates, terms, d, q, acc, dacc
    + (_P,) * 9  # accept, dq, u_acc, beta_prior, d_pr, lmhg, prop, tn, delta
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


def plan_width(kc, kt, kd):
    """int32 words of a ticket's plan record: the head, ``ch``, ``t_rows``,
    ``d_rows`` and the owners, rounded up to 16 bytes."""
    return (PLAN_HEAD + kc + kt + 2 * kd + 3) // 4 * 4


def slot_owners(sx, pos):
    """Each distance slot's owner ``[B, KD]``: 0 where ``d_rows`` is the
    node's own branch row (``pos[node]``), 1 + j where it is child j's (the
    last such child, as the plain prologue's matching takes it), -1 where
    the slot is a pad or matches neither."""
    node, ch, d_rows = sx["node"].long(), sx["ch"].long(), sx["d_rows"]
    pos = pos.to(d_rows.dtype)
    own = torch.where(d_rows == pos[node][:, None], 0, -1)
    for j in range(ch.shape[-1]):
        cj = ch[:, j]
        hit = (d_rows == pos[cj.clamp(min=0)][:, None]) & (cj >= 0)[:, None]
        own = torch.where(hit, 1 + j, own)
    return torch.where(d_rows >= 0, own, -1).to(torch.int32)


def point_plan(sx, pos, is_leaf):
    """A step's plan as the prologue kernel reads it: one record of
    :func:`plan_width` int32 words per ticket ``[B, W]``: node, parent,
    tuning row, flags (bit 0 valid, bit 1 + j child j is a leaf), ``sd`` as
    float32 bits, then ``ch``, ``t_rows``, ``d_rows`` and
    :func:`slot_owners`, zero-padded."""
    ch = sx["ch"]
    B, KC = ch.shape
    KT, KD = sx["t_rows"].shape[-1], sx["d_rows"].shape[-1]
    if KC > KC_MAX:
        raise ValueError(f"point_plan: {KC} children per ticket, the record holds {KC_MAX}")
    leaf = is_leaf[ch.clamp(min=0).long()] & (ch >= 0)
    bits = torch.arange(1, KC + 1, device=ch.device)
    flags = sx["valid"].long() | (leaf.long() << bits).sum(-1)
    sd = sx["sd"].to(torch.float32).view(torch.int32)
    head = torch.stack([sx["node"], sx["par"], sx["rows"], flags.to(torch.int32), sd], dim=1)
    rec = torch.cat([head.to(torch.int32), ch, sx["t_rows"], sx["d_rows"],
                     slot_owners(sx, pos)], dim=1)
    pad = plan_width(KC, KT, KD) - rec.shape[1]
    return torch.nn.functional.pad(rec, (0, pad)).contiguous()


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


def point_lik_epilogue_plain(branch, state, terms, d, q, acc, sx, pro, accept, dq, u_acc=None,
                             beta_prior=None):
    """Plain PyTorch version of :func:`point_lik_epilogue` (updates in
    place; ``dq`` None skips ``q``)."""
    if accept is None:
        accept = prior_accept(pro.d_pr, pro.lmhg, u_acc, beta_prior)
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
    t_rows, d_rows, d_flat, rows, valid, sd, cal_*``, and for the kernel
    the packed ``kplan`` of :func:`point_plan`, which ``FastSweeps``
    binds); ``pos`` ``[N]`` is
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
                    ("height", state.height), ("rate_mean", state.rate_mean), ("draw", draw)):
        if t is not None:
            build.require_cuda(t, name, torch.float32)
    plan = sx["kplan"]
    build.require_cuda(plan, "kplan", torch.int32)
    W = plan_width(KC, KT, KD)
    if tuple(plan.shape) != (B, W):
        raise ValueError(f"point_lik_prologue: kplan is {tuple(plan.shape)}, not {(B, W)}")
    cal = [sx[k] if KN else None for k in ("cal_lo", "cal_lo_s", "cal_hi", "cal_hi_s")]
    for name, t in zip(("cal_lo", "cal_lo_s", "cal_hi", "cal_hi_s"), cal):
        if t is not None:
            build.require_cuda(t, name, torch.float32)
    dev = terms.device

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    pro = PointProposal(out(C, B), out(C, B), out(C, B, KT), out(C, B, KD), out(C, B),
                        out(C, B), None if z is None else out(C, B * KD))
    p = build.ptr
    err = build.bind("mcmcdate_point_lik_prologue_f32", _PROLOGUE_ARGTYPES)(
        p(state.heights), p(state.rates), p(terms), p(d), p(z), p(tuning), p(state.birth),
        p(state.death), p(state.rate_var), p(state.height), p(state.rate_mean), p(plan),
        *map(p, cal), p(draw), *map(p, pro), C, B, N, terms.shape[1], tuning.shape[1],
        d.shape[1], KC, KT, KD, KN, W, clocks.MODELS.index(clock), int(bool(branch)),
        build.stream_ptr(dev),
    )
    build.check(err, "point_lik_prologue kernel")
    point_lik_prologue.launches += 1
    return pro


def point_lik_epilogue(branch, state, terms, d, q, acc, sx, pro, accept, dq, u_acc=None,
                       beta_prior=None):
    """The write-back of a likelihood point step on every chain, in place:
    heights (slide) or rates (branch), terms, ``d``, ``q`` and the accept
    counts ``acc`` of the accepted tickets (``accept``, ``dq`` from
    :func:`~.point_scan.point_scan`, ``pro`` from the prologue; pad slots
    never accept, their ``lmhg`` is ``-inf``).  Without a likelihood
    ``accept`` and ``dq`` are None and the accept uniforms ``u_acc`` are
    given: the epilogue decides, ``log u < beta_prior d_pr + lmhg`` with the
    chains' prior temperature ``beta_prior`` ``[C]`` (None: 1; the JAX
    step's ``fast_sweep.py:1471``), and leaves ``q``.  Returns ``(accept,
    dacc [C, B KD])`` with ``dacc`` the accepted distance deltas at the
    step's rows (``d_flat``).  The plain version runs for CPU tensors, the
    kernel for CUDA tensors (float32)."""
    if terms.device.type == "cpu":
        return point_lik_epilogue_plain(branch, state, terms, d, q, acc, sx, pro, accept, dq,
                                        u_acc, beta_prior)
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
        p(dq), p(u_acc), p(build.beta_arg(beta_prior, C, terms.device)), p(pro.d_pr),
        p(pro.lmhg), p(pro.prop), p(pro.tn), p(pro.delta),
        p(sx["node"]), p(sx["t_rows"]), p(sx["d_rows"]), p(sx["rows"]), p(sx["valid"]), C, B, N,
        terms.shape[1], acc.shape[1], d.shape[1], KT, KD, int(bool(branch)),
        build.stream_ptr(terms.device),
    )
    build.check(err, "point_lik_epilogue kernel")
    point_lik_epilogue.launches += 1
    return accept, dacc


point_lik_prologue.launches = 0
point_lik_epilogue.launches = 0
