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
  is no scan: the epilogue takes the decisions itself, ``log u <
  beta_prior d_pr + lmhg`` (the chain's prior temperature), and leaves
  ``q``.

The prologue is bound on the H100 by its special functions (the inverse
normal CDF or lgamma per ticket, the double-precision birth-death exp, log
and divisions and a gamma or log-normal density per row), the epilogue by
its bytes.  Each block has a row plan (:func:`range_plan`, built with
FastSweeps): its real rows ticket by ticket, then its pad slots, one
16-byte entry a row, and each ticket's first row and row count.  The
prologue kernel (``csrc/range_step.cu``) runs one CTA per
:data:`PROLOGUE_TILE` chains over the whole block: it stages the rows'
entries into shared memory while its threads draw each (chain, ticket)'s
proposal once and form each chain's birth-death and clock constants once
(the same operations, so the terms stay bitwise the plain version's), then
walks (chain, row) pairs over the real rows only (a pad slot gets ``g =
zg = 0``, what ``range_scan`` reads) and sums each ticket's term deltas
with a group of lanes in a fixed order.  The epilogue kernel runs one
thread per chain and row slot, ticket or ``q``.  A block's arguments are
one struct bound once (:class:`RangeBlock`); FastSweeps gives each (kind,
row bucket) one :class:`RangeWork` whose buffers its blocks write in turn,
so a block costs no allocation and two short calls.  Both kernels mirror
their plain versions operation by operation (built with ``-fmad=false``),
with CUDA's normal CDF and its inverse in place of PyTorch's: a proposal
may differ from the plain one in its last bits, so the checks on the card
replay the kernel's proposals through :func:`range_lik_given`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
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

class RangeProposal(NamedTuple):
    """What the prologue computes per chain and ticket ``[C, S]`` and per
    row ``[C, S, RB]`` (calibration slots ``[C, S, KN]``).  The kernel's are
    its block's :class:`RangeWork` buffers, valid until the next prologue of
    a block of the same bucket; there ``x_new``, ``bd_new``, ``ck_new`` and
    ``cal_new`` hold values only on the real rows and slots of valid tickets
    (the plain version's are 0 elsewhere), which is all the epilogue reads."""

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


def range_lik_epilogue_plain(rate, state, terms, d, q, acc, sx, pro, accept, dq, u_acc=None,
                             beta_prior=None):
    """Plain PyTorch version of :func:`range_lik_epilogue` (updates in
    place; ``dq`` None skips ``q``)."""
    N = state.heights.shape[1]
    if accept is None:
        accept = prior_accept(pro.d_pr, pro.lmhg, u_acc, beta_prior)
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


# ---------------------------------------------------------------------------
# The block's plan and the kernels' arguments
# ---------------------------------------------------------------------------

# The fields of a ticket's row in ``tplan`` (``kTicketFields`` of
# ``csrc/range_step.cu``).
TICKET_FIELDS = ("row_start", "n_rows", "node", "par", "rows", "n_inner", "n_nodes", "valid")
# Chains per CTA of the prologue kernel.
PROLOGUE_TILE = 2


def range_plan(sx):
    """The row plan of a block for its kernels, from ``own`` ``[S, RB]`` (-1
    pad), ``own_par``, ``d_flat`` and the ticket arrays of ``sx``:
    ``(rplan, tplan)`` on their device.

    ``rplan`` int32 ``[S RB, 4]`` lists the real rows (``own >= 0``) ticket
    by ticket in slot order, then the pad slots in slot order, each as
    ``(slot | s << 16 | root << 24, own, own_par, dpos)``: ``root`` flags
    the subtree root (``own == node[s]``) and ``dpos`` is ``d_flat[slot]``;
    a pad slot's ``own`` and ``own_par`` are -1 and its ``dpos`` 0.
    ``tplan`` int32 ``[S, 8]`` holds each ticket's :data:`TICKET_FIELDS`:
    its first row in ``rplan``, its number of rows, then ``node, par, rows,
    n_inner, n_nodes, valid`` as ``sx`` has them.  Built on the host, once
    per block."""
    own = sx["own"].cpu().numpy().astype(np.int64)
    S, RB = own.shape
    ok = own >= 0
    slots = np.arange(S * RB).reshape(S, RB)
    order = np.concatenate([slots[ok], slots[~ok]])
    tick = order // RB
    own_o = own.reshape(-1)[order]
    real = own_o >= 0
    node = sx["node"].cpu().numpy().astype(np.int64)
    root = (real & (own_o == node[tick])).astype(np.int64)
    own_par = np.maximum(sx["own_par"].cpu().numpy().astype(np.int64).reshape(-1)[order], 0)
    dpos = sx["d_flat"].cpu().numpy().astype(np.int64)[order]
    rplan = np.stack([order | tick << 16 | root << 24, own_o, np.where(real, own_par, -1),
                      np.where(real, dpos, 0)], 1)
    n_rows = ok.sum(1)
    tplan = np.stack([np.cumsum(n_rows) - n_rows, n_rows]
                     + [sx[k].cpu().numpy().astype(np.int64) for k in TICKET_FIELDS[2:]], 1)
    dev = sx["own"].device
    return (torch.as_tensor(rplan.astype(np.int32), device=dev),
            torch.as_tensor(tplan.astype(np.int32), device=dev))


_PLAN = ("rplan", "tplan", "sd", "cal_t_rows", "cal_hsrc", "cal_lo", "cal_lo_s", "cal_hi",
         "cal_hi_s")
_OUTS = ("prop", "lq", "coef", "d_pr", "lmhg", "g", "zg", "x_new", "bd_new", "ck_new",
         "cal_new", "dacc")
_INTS = ("C", "S", "RB", "R", "KN", "N", "T", "P", "D", "clock_model", "rate", "tile")


class _BlockArgs(ctypes.Structure):
    """``RangeBlockArgs`` of ``csrc/range_step.cu``, field by field."""

    _fields_ = [(k, ctypes.c_void_p) for k in _PLAN + _OUTS] + [(k, ctypes.c_int) for k in _INTS]


@functools.lru_cache(maxsize=None)
def _check_layout() -> None:
    if build.bind("mcmcdate_range_block_args_size", ())() != ctypes.sizeof(_BlockArgs):
        raise RuntimeError("range_step: the kernels' argument layout does not match the "
                           "wrapper's")


_P = ctypes.c_void_p
# args, heights, rates, terms, d, z, tuning, birth, death, rate_var, height,
# rate_mean, is_leaf, draw, stream
_PROLOGUE_ARGTYPES = (_P,) * 15
# args, heights, rates, terms, d, q, acc, accept, dq, u_acc, beta_prior, stream
_EPILOGUE_ARGTYPES = (_P,) * 12


class RangeBlock(NamedTuple):
    """A block bound to its outputs on the card: the prologue's outputs
    ``pro``, the epilogue's ``dacc`` ``[C, S RB]`` and, without a
    likelihood, its decisions ``accept`` ``[C, S]``, in one argument struct
    (``addr``) built for the state's ``shape`` ``(C, N, T, P, D)``."""

    pro: RangeProposal
    dacc: torch.Tensor
    accept: torch.Tensor
    args: _BlockArgs
    addr: int
    shape: tuple


def _require(named, dtype) -> None:
    for name, t in named:
        if t is not None and not (t.is_cuda and t.dtype == dtype and t.is_contiguous()):
            build.require_cuda(t, name, dtype)  # raises with the reason


def _bind(rate, sx, R, clock_model, shape, pro, dacc, accept) -> RangeBlock:
    """The argument struct of block ``sx`` (``R`` real rows) writing to
    ``pro``, ``dacc`` and ``accept``, after checking them."""
    _check_layout()
    if "rplan" not in sx:
        raise ValueError("range_step: the block has no row plan (range_plan)")
    C, N, T, P, D = shape
    S, RB = sx["own"].shape
    KN = 0 if rate else sx["cal_t_rows"].shape[-1]
    if not (sx["rplan"].shape == (S * RB, 4) and sx["rplan"].data_ptr() % 16 == 0):
        raise ValueError("range_step: rplan must be [S RB, 4] on a 16-byte boundary")
    _require([(k, sx[k]) for k in ("rplan", "tplan", "cal_t_rows", "cal_hsrc")], torch.int32)
    _require([(k, sx[k]) for k in ("sd", "cal_lo", "cal_lo_s", "cal_hi", "cal_hi_s")],
             torch.float32)
    want = dict(prop=(C, S), lq=(C, S), coef=(C, S), d_pr=(C, S), lmhg=(C, S), g=(C, S, RB),
                zg=(C, S, RB), x_new=(C, S, RB), bd_new=(C, S, RB), ck_new=(C, S, RB),
                cal_new=(C, S, KN))
    for k, t in pro._asdict().items():
        if t is not None and t.shape != want[k]:
            raise ValueError(f"range_step: {k} must be {want[k]}, got {tuple(t.shape)}")
    _require(pro._asdict().items(), torch.float32)
    _require((("dacc", dacc),), torch.float32)
    _require((("accept", accept),), torch.bool)  # read and written as bytes 0 / 1
    if (rate and pro.bd_new is not None) or (not rate and pro.bd_new is None):
        raise ValueError("range_step: bd_new is the ultrametric kind's alone")
    p = build.ptr
    args = _BlockArgs(**{k: p(sx[k]) for k in _PLAN},
                      **{k: p(v) for k, v in pro._asdict().items()}, dacc=p(dacc), C=C, S=S,
                      RB=RB, R=R, KN=KN, N=N, T=T, P=P, D=D, clock_model=clock_model,
                      rate=int(bool(rate)), tile=PROLOGUE_TILE)
    return RangeBlock(pro, dacc, accept, args, ctypes.addressof(args), shape)


def _real_rows(sx) -> int:
    return int((sx["own"] >= 0).sum())


def _work(rate, sx, lik: bool) -> "RangeWork":
    """The block's :class:`RangeWork`, ``sx["work"]`` (FastSweeps gives each
    (kind, row bucket) one), made for the block alone where it has none."""
    work = sx.get("work")
    if work is None:
        work = sx["work"] = RangeWork(rate, lik, [sx])
    if work.rate != bool(rate) or work.lik != lik:
        raise ValueError("range_step: the block's RangeWork is for another kind, or was made "
                         "with a likelihood where z is None (or without one where z is given)")
    return work


class RangeWork:
    """The outputs on the card of K5's prologue and epilogue for the blocks
    of one (kind, row bucket) of a FastSweeps: one set of buffers sized for
    the bucket's largest block, allocated at the first launch for a chain
    count, that its blocks write in turn (a block's outputs are read before
    the next block's prologue), and each block's :class:`RangeBlock`, bound
    once.  Every prologue writes ``g = zg = 0`` on its block's pad slots, so
    what an earlier block left there is never read; ``x_new``, ``bd_new``
    and ``ck_new`` hold stale values on pad slots, which nothing reads."""

    def __init__(self, rate: bool, lik: bool, blocks):
        self.rate, self.lik = bool(rate), bool(lik)
        self.S = max(sx["own"].shape[0] for sx in blocks)
        self.F = max(sx["own"].numel() for sx in blocks)
        self.KN = 0 if rate else max(sx["cal_t_rows"].shape[-1] for sx in blocks)
        # The real rows of each block, counted when FastSweeps is built so
        # that no launch waits for the card.
        self.rows = {id(sx): _real_rows(sx) for sx in blocks}
        self._C = None
        self._bound = {}

    def _alloc(self, C, device):
        def f(n):
            return torch.empty(n, dtype=torch.float32, device=device)

        s, fl = C * self.S, C * self.F
        self._buf = dict(prop=f(s), lq=f(s), coef=f(s), d_pr=f(s), lmhg=f(s), g=f(fl),
                         zg=f(fl) if self.lik else None, x_new=f(fl),
                         bd_new=None if self.rate else f(fl), ck_new=f(fl),
                         cal_new=f(s * self.KN), dacc=f(fl),
                         accept=torch.empty(s, dtype=torch.bool, device=device))
        self._C = C
        self._bound = {}

    def bound(self, sx, shape) -> Optional[RangeBlock]:
        """Block ``sx`` as :meth:`block` bound it for a state of ``shape``,
        or None."""
        got = self._bound.get(id(sx))
        return got[1] if got is not None and got[0] is sx and got[1].shape == shape else None

    def block(self, sx, clock_model: int, shape) -> RangeBlock:
        """Block ``sx`` bound to the buffers, for a state of ``shape``."""
        blk = self.bound(sx, shape)
        if blk is not None:
            return blk
        C = shape[0]
        if C != self._C:
            self._alloc(C, sx["own"].device)
        S, RB = sx["own"].shape
        KN = 0 if self.rate else sx["cal_t_rows"].shape[-1]
        b = self._buf

        def v(name, *dims):
            t = b[name]
            return None if t is None else t[:math.prod(dims)].view(dims)

        pro = RangeProposal(*(v(k, C, S) for k in _OUTS[:5]),
                            *(v(k, C, S, RB) for k in _OUTS[5:10]), v("cal_new", C, S, KN))
        R = self.rows.get(id(sx))
        blk = _bind(self.rate, sx, _real_rows(sx) if R is None else R, clock_model, shape, pro,
                    v("dacc", C, S * RB), v("accept", C, S))
        self._bound[id(sx)] = (sx, blk)
        return blk


def _shape(state, terms, d, tuning):
    return (*state.heights.shape, terms.shape[1], tuning.shape[1], d.shape[1])


def range_lik_prologue(rate, state, terms, d, z, tuning, sx, is_leaf, clock, draw):
    """The prologue of a likelihood range block on every chain: returns a
    :class:`RangeProposal`.  ``rate`` picks the rate kind (else
    ultrametric); ``sx`` holds the block's plan arrays (``node, par, own,
    own_par, d_flat, rows, valid, sd, n_inner, n_nodes, cal_*`` and, for
    the kernel, ``rplan`` and ``tplan`` of :func:`range_plan`); ``draw``
    ``[C, S]`` is the truncated-normal uniform or the standard gamma
    variate.  The plain version runs for CPU tensors, the kernel for CUDA
    tensors (float32), writing into the block's :class:`RangeWork`
    (``sx["work"]``, made on first use where the block has none): the
    returned tensors are its buffers.  Without a likelihood ``z`` is None,
    and so is the proposal's ``zg``."""
    if terms.device.type == "cpu":
        return range_lik_prologue_plain(rate, state, terms, d, z, tuning, sx, is_leaf, clock,
                                        draw)
    shape = _shape(state, terms, d, tuning)
    blk = _work(rate, sx, z is not None).block(sx, clocks.MODELS.index(clock), shape)
    if draw.shape != blk.pro.prop.shape:
        raise ValueError(f"range_lik_prologue: draw must be {tuple(blk.pro.prop.shape)}")
    _require((("heights", state.heights), ("rates", state.rates), ("terms", terms), ("d", d),
              ("z", z), ("tuning", tuning), ("birth", state.birth), ("death", state.death),
              ("rate_var", state.rate_var), ("height", state.height),
              ("rate_mean", state.rate_mean), ("draw", draw)), torch.float32)
    _require((("is_leaf", is_leaf),), torch.bool)  # read as bytes 0 / 1
    p = build.ptr
    err = build.bind("mcmcdate_range_lik_prologue_f32", _PROLOGUE_ARGTYPES)(
        blk.addr, p(state.heights), p(state.rates), p(terms), p(d), p(z), p(tuning),
        p(state.birth), p(state.death), p(state.rate_var), p(state.height), p(state.rate_mean),
        p(is_leaf), p(draw), build.stream_ptr(terms.device))
    build.check(err, "range_lik_prologue kernel")
    range_lik_prologue.launches += 1
    return blk.pro


def range_lik_epilogue(rate, state, terms, d, q, acc, sx, pro, accept, dq, u_acc=None,
                       beta_prior=None):
    """The write-back of a likelihood range block on every chain, in place:
    heights (ultrametric) or rates (rate), terms, ``d``, ``q`` and the accept
    counts ``acc`` of the accepted tickets (``accept``, ``dq`` from
    :func:`~.range_scan.range_scan`, ``pro`` from the prologue; pad slots
    never accept, their ``lmhg`` is ``-inf``).  Without a likelihood
    ``accept`` and ``dq`` are None and the accept uniforms ``u_acc`` are
    given: the epilogue decides, ``log u < beta_prior d_pr + lmhg`` with the
    chains' prior temperature ``beta_prior`` ``[C]`` (None: 1; the JAX
    step's ``fast_sweep.py:1834``), and leaves ``q``.
    Returns ``(accept, dacc [C, S RB])`` with ``dacc`` the accepted distance
    deltas at the block's rows (``d_flat``).  The plain version runs for
    CPU tensors, the kernel for CUDA tensors (float32): ``pro`` must be
    what the kernel prologue returned for this block and state, and
    ``dacc`` (and without a likelihood ``accept``) are the block's
    :class:`RangeWork` buffers, valid until the next block of its bucket."""
    if terms.device.type == "cpu":
        return range_lik_epilogue_plain(rate, state, terms, d, q, acc, sx, pro, accept, dq,
                                        u_acc, beta_prior)
    if (accept is None) == (u_acc is None) or (u_acc is not None and dq is not None):
        raise ValueError("range_lik_epilogue takes accept and dq, or u_acc alone")
    work = sx.get("work")
    blk = None if work is None else work.bound(sx, _shape(state, terms, d, acc))
    if blk is None or blk.pro is not pro:
        raise ValueError("range_lik_epilogue: pro is not the kernel prologue's output for this "
                         "block and state")
    if accept is None:
        accept = blk.accept
    _require((("heights", state.heights), ("rates", state.rates), ("terms", terms), ("d", d),
              ("q", q), ("dq", dq), ("u_acc", u_acc)), torch.float32)
    _require((("acc", acc),), torch.int32)
    _require((("accept", accept),), torch.bool)
    if accept.shape != pro.prop.shape:
        raise ValueError(f"range_lik_epilogue: accept must be {tuple(pro.prop.shape)}")
    p = build.ptr
    err = build.bind("mcmcdate_range_lik_epilogue_f32", _EPILOGUE_ARGTYPES)(
        blk.addr, p(state.heights), p(state.rates), p(terms), p(d), p(q), p(acc), p(accept),
        p(dq), p(u_acc), p(build.beta_arg(beta_prior, terms.shape[0], terms.device)),
        build.stream_ptr(terms.device))
    build.check(err, "range_lik_epilogue kernel")
    range_lik_epilogue.launches += 1
    return accept, blk.dacc


range_lik_prologue.launches = 0
range_lik_epilogue.launches = 0
