"""K3 ``accept_select``: the ticket epilogue of the sequential sweep.

Replaces the accept-and-select part of the XLA-compiled
``MHKernel._ticket_step`` (``mcmcdate_tpu/engine/mh.py:120-128`` and
``180-207``).  After T1 ``ticket_prologue`` (``ticket_step.py``) and, for a
full-MVN ticket of a dense or range class, K2's ``dy``, it takes the
likelihood delta (K2's under a full MVN; ``dy = delta * inv_sd`` on the
row's class rows under the univariate kind; zero with no likelihood or for
``DC_INV``), ``log alpha = d_pr + d_lik + lmhg + lj`` (NaN -> -inf, d_pr
-inf where T1 found the new term vector invalid), the decision ``log u <
log alpha`` and then writes back only what the ticket touched: for an
accepted chain its term entries, ``d`` on the class rows, ``y`` (all of it
after K2, the class rows under the univariate kind), the accept count and
the bad-term count (0); for a rejected one the old heights, rates and
scalars T1 kept.  The same device functions end every ticket of T3
``ticket_scan``.

On the H100 it is bound by latency and bytes: a few per-chain values, the
ticket's touched entries (O(1) for a node-local ticket; the whole blocks of
a global one), and ``y`` after K2 (``D`` floats per accepted chain).  The
kernel (``csrc/accept_select.cu``, device functions in
``csrc/ticket_step.cuh``) runs one CTA per chain, built with ``-fmad=false``
as its plain version's arithmetic.
"""

from __future__ import annotations

import math

import torch

from ..models.state import FIELDS
from .ticket_step import LIK_DIAG, LIK_FULL, TicketDraws, TicketPro, TicketTable, kernel_args, \
    launch


def accept_select_plain(tt: TicketTable, carry, pidx: int, pro: TicketPro, u_acc, dy=None,
                        d_lik=None):
    """Plain version of :func:`accept_select` for one ticket of row ``pidx``
    (``u_acc`` ``[C]``), in place.  Returns ``(accept, log_alpha)``."""
    p = int(pidx)
    rows = tt.rows(p)
    has_rows = rows is None or rows.numel() > 0
    y = carry.y
    dy_r = None
    if tt.lik == LIK_DIAG and has_rows:
        inv_sd = tt.model.inv_sd_internal_t
        y_r = y if rows is None else y[:, rows]
        dy_r = (pro.delta if rows is None else pro.delta[:, rows]) * (
            inv_sd if rows is None else inv_sd[rows])
        d_lik = -0.5 * torch.sum(dy_r * (2.0 * y_r + dy_r), dim=-1)
    d_pr = torch.where(pro.invalid, -math.inf, pro.d_pr)
    log_alpha = d_pr + (0.0 if d_lik is None else d_lik) + pro.lmhg + pro.lj
    log_alpha = torch.where(torch.isnan(log_alpha), -math.inf, log_alpha)
    accept = torch.log(u_acc) < log_alpha
    a = accept[:, None]
    b = carry.batch
    for name in FIELDS:
        old, new = getattr(b, name), getattr(pro.state, name)
        if new is not old:
            old.copy_(torch.where(a if old.dim() == 2 else accept, new, old))
    tix = tt.tix(p)
    carry.terms[:, tix] = torch.where(a, pro.tn[:, tix], carry.terms[:, tix])
    if tt.lik and has_rows:
        if rows is None:
            carry.d.copy_(torch.where(a, pro.d_new, carry.d))
        else:
            carry.d[:, rows] = torch.where(a, pro.d_new[:, rows], carry.d[:, rows])
    if dy_r is not None:
        if rows is None:
            y.copy_(torch.where(a, y + dy_r, y))
        else:
            y[:, rows] = torch.where(a, y_r + dy_r, y_r)
    elif tt.lik == LIK_FULL and dy is not None:
        y.copy_(torch.where(a, y + dy, y))
    carry.acc[:, p] += accept.to(carry.acc.dtype)
    carry.nbad.copy_(torch.where(accept, 0, carry.nbad))
    return accept, log_alpha


def accept_select(tt: TicketTable, carry, tuning, dr: TicketDraws, j: int, pro: TicketPro,
                  dy=None, d_lik=None, out=None):
    """The decision and write-back of ticket ``j`` of ``dr`` on every chain,
    in place, after its prologue ``pro`` (:func:`~.ticket_step.
    ticket_prologue`) and, under a full MVN, K2's ``dy`` ``[C, D]`` and
    ``d_lik`` ``[C]`` (None for ``DC_INV`` and the gather class' plain
    step).  Returns the accept mask ``[C]``, and with ``out`` also the log
    acceptance ratio.  The plain version runs for CPU tensors, kernel K3 for
    CUDA tensors (float32; after kernel T1 alone, whose scratch it reads)."""
    p = int(dr.order_host[j])
    if carry.terms.device.type == "cpu":
        res = accept_select_plain(tt, carry, p, pro, dr.u_acc[:, j], dy, d_lik)
        return res if out else res[0]
    if pro.state is not None:
        raise ValueError("accept_select on the card follows kernel T1 (ticket_prologue)")
    if tt.lik == LIK_FULL and (dy is None) != (d_lik is None):
        raise ValueError("accept_select needs both of K2's dy and d_lik, or neither")
    args = kernel_args(tt, carry, tuning, dr)
    C = carry.terms.shape[0]
    dev = carry.terms.device
    accept = torch.empty(C, dtype=torch.bool, device=dev)
    la = torch.empty(C, dtype=torch.float32, device=dev) if out else None
    for name, t in (("dy", dy), ("d_lik", d_lik)):
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32")
    args.update(j0=j, nj=1, row=p, dy_in=dy, dlik_in=d_lik, accept_out=accept, la_out=la)
    launch("accept_select", args, dev)
    accept_select.launches += 1
    return (accept, la) if out else accept


accept_select.launches = 0
