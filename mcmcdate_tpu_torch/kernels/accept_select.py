"""K3 ``accept_select``: the MHG accept and the in-place select of every
carried quantity for one ticket.

Replaces the accept-and-select part of the XLA-compiled
``MHKernel._ticket_step`` (``mcmcdate_tpu/engine/mh.py:120-128`` and
``180-207``).  On the H100 it is bound by bytes (two ``[C, T]`` term rows
read, up to ``2N + T + 2D`` floats copied per accepted chain, no reuse);
the kernel (``csrc/accept_select.cu``) does the term reduction and the
decision in one block per chain and then the masked copies, skipping the
quantities a proposal left unchanged.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..models.state import FIELDS
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = ((_I,) * 6 + (_P,) * 6 + (_P,) * 14 + (_P,) * 4 + (_P, _P, _P))

_SCALARS = ("birth", "death", "height", "rate_mean", "rate_var")


def accept_select_plain(terms, terms2, log_mhg, u, state, state_new, acc, pidx, *,
                        d_lik=None, lj=None, d=None, d_new=None, y=None, dy=None):
    """Plain PyTorch version of :func:`accept_select` (updates in place)."""
    d_terms = terms2 - terms
    d_pr = torch.sum(torch.where(torch.isnan(d_terms), 0.0, d_terms), dim=-1)
    invalid_new = torch.any(~torch.isfinite(terms2) & ~torch.isposinf(terms2), dim=-1)
    d_pr = torch.where(invalid_new, -math.inf, d_pr)
    log_alpha = d_pr + (d_lik if d_lik is not None else 0.0)
    log_alpha = log_alpha + log_mhg
    if lj is not None:
        log_alpha = log_alpha + lj
    log_alpha = torch.where(torch.isnan(log_alpha), -math.inf, log_alpha)
    accept = torch.log(u) < log_alpha
    a = accept[:, None]
    for name in FIELDS:
        old, new = getattr(state, name), getattr(state_new, name)
        if new is not old:
            old.copy_(torch.where(a if old.dim() == 2 else accept, new, old))
    terms.copy_(torch.where(a, terms2, terms))
    if d_new is not None:
        d.copy_(torch.where(a, d_new, d))
    if dy is not None:
        y.copy_(torch.where(a, y + dy, y))
    acc[:, pidx] += accept.to(acc.dtype)
    return accept


def accept_select(terms, terms2, log_mhg, u, state, state_new, acc, pidx, *,
                  d_lik=None, lj=None, d=None, d_new=None, y=None, dy=None):
    """Accept each chain's proposal where ``log u < d_prior + d_lik +
    log_mhg + lj`` and, for accepted chains, copy
    ``state_new`` into ``state``, ``terms2`` into ``terms``, ``d_new`` into
    ``d``, add ``dy`` to ``y`` and count the accept in ``acc[:, pidx]``,
    all in place.  Fields of ``state_new`` that are the same tensor as in
    ``state`` are left alone, as are ``d`` and ``y`` when ``d_new`` or
    ``dy`` is None.  Returns the ``[C]`` accept mask.  The plain version
    runs for CPU tensors, kernel K3 for CUDA tensors (float32)."""
    if terms.device.type == "cpu":
        return accept_select_plain(
            terms, terms2, log_mhg, u, state, state_new, acc, pidx, d_lik=d_lik, lj=lj,
            d=d, d_new=d_new, y=y, dy=dy)
    C, T = terms.shape
    N = state.heights.shape[1]
    D = 0 if d is None else d.shape[1]
    f32 = torch.float32
    for name, t in (("terms", terms), ("terms2", terms2), ("log_mhg", log_mhg), ("u", u),
                    ("d_lik", d_lik), ("lj", lj), ("d", d), ("d_new", d_new), ("y", y),
                    ("dy", dy)):
        if t is not None:
            build.require_cuda(t, name, f32)
    build.require_cuda(acc, "acc", torch.int32)
    pairs = []
    for name in ("heights", "rates") + _SCALARS:
        old, new = getattr(state, name), getattr(state_new, name)
        build.require_cuda(old, name, f32)
        if new is old:
            new = None
        else:
            build.require_cuda(new, name + " (new)", f32)
        pairs += [old, new]
    accept = torch.empty(C, dtype=torch.uint8, device=terms.device)
    p = build.ptr
    err = build.bind("mcmcdate_accept_select_f32", _ARGTYPES)(
        C, T, N, D, acc.shape[1], int(pidx), p(terms), p(terms2), p(d_lik), p(log_mhg),
        p(lj), p(u), *map(p, pairs), p(d), p(d_new), p(y),
        p(dy), p(acc), p(accept), build.stream_ptr(terms.device),
    )
    build.check(err, "accept_select kernel")
    accept_select.launches += 1
    return accept.bool()


accept_select.launches = 0
