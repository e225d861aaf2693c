"""M1 ``mc3_swap``: the MC3 swap move, every group's exchange decisions and
the permutation of its temperature slots' states, in one launch.

Replaces the body of the JAX package's ``make_swap_fn``
(``mcmcdate_tpu/engine/mc3.py:46-84``).  The batch is laid out ``[g * T +
k]``: group ``g``'s slot ``k`` runs at the ladder's ``betas[k]``.  Per
group, draw after draw ``s``: the pair ``(p, p + 1)`` with ``p =
pair[s, g]`` swaps where ``log u[s, g] < (betas[p] - betas[p + 1]) (U[p +
1] - U[p])``, ``U`` the slots' untempered log posteriors, exchanging
``perm[p], perm[p + 1]`` and ``U[p], U[p + 1]``; then every field of the
state takes row ``g * T + perm[k]`` into row ``g * T + k``.  The tuning
stays with its slot.  The JAX package draws ``pair`` and ``u`` inside the
jitted function from its key; here they are arguments, so that a test can
hand both the same draws.

On the H100 it is bound by bytes: a moved group reads and writes its ``T``
rows of every field (about 16.4 MB each way at 1000 taxa x 1024 chains
when every group moves).  The kernel (``csrc/mc3_swap.cu``) runs a CTA a
group: thread 0 takes the group's decisions, then each thread permutes
whole columns of the group's rows in place (it reads a column's ``T``
values before it writes them, so no other thread's reads are in the way),
and the last CTA sums the per-pair counts in a fixed order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.state import FIELDS
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _I) + (_P,) * 8 + (_I,) * 3 + (_P,)
MAX_TEMPS = 8  # temperature slots a group the kernel takes


def mc3_swap_plain(batch, U, pair, u, betas):
    """Plain PyTorch version of :func:`mc3_swap` (the JAX scan, in place):
    returns ``(accept [S, G] bool, pair_acc [T-1], pair_tot [T-1])``, the
    counts int32."""
    S, G = pair.shape
    T = betas.shape[0]
    Ug = U.view(G, T)
    perm = torch.arange(T, device=U.device).expand(G, T).clone()
    gi = torch.arange(G, device=U.device)
    p = pair.long()
    accepts = []
    for s in range(S):
        ps = p[s]
        ui, uj = Ug[gi, ps], Ug[gi, ps + 1]
        log_alpha = (betas[ps] - betas[ps + 1]) * (uj - ui)
        acc = torch.log(u[s]) < log_alpha
        pi, pj = perm[gi, ps], perm[gi, ps + 1]
        perm[gi, ps] = torch.where(acc, pj, pi)
        perm[gi, ps + 1] = torch.where(acc, pi, pj)
        Ug[gi, ps] = torch.where(acc, uj, ui)
        Ug[gi, ps + 1] = torch.where(acc, ui, uj)
        accepts.append(acc)
    accept = torch.stack(accepts)
    flat = (gi[:, None] * T + perm).reshape(-1)
    for name in FIELDS:
        x = getattr(batch, name)
        x.copy_(x.index_select(0, flat))
    oh = p[..., None] == torch.arange(T - 1, device=U.device)
    pair_acc = (oh & accept[..., None]).sum((0, 1)).to(torch.int32)
    pair_tot = oh.sum((0, 1)).to(torch.int32)
    return accept, pair_acc, pair_tot


@functools.lru_cache(maxsize=None)
def _ticket(device: str):
    """The kernel's ticket counter: one zeroed word per device, which every
    launch leaves zeroed."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def mc3_swap(batch, U, pair, u, betas):
    """One swap move of every group, in place: ``batch`` (a ``State`` of ``G
    T`` chains laid out ``[g * T + k]``) permuted within each group, ``U``
    ``[G T]`` (the chains' untempered log posteriors) permuted with it.
    ``pair`` (int32) and ``u`` ``[S, G]`` are each draw's lower slot (in
    ``[0, T - 1)``) and accept uniform; ``betas`` ``[T]`` the ladder.
    Returns ``(accept [S, G] bool, pair_acc [T - 1], pair_tot [T - 1])``
    (int32 counts of accepted and attempted swaps per adjacent pair).  The
    plain version runs for CPU tensors, kernel M1 for CUDA tensors
    (float32, contiguous)."""
    S, G = pair.shape
    T = betas.shape[0]
    if U.shape != (G * T,) or u.shape != (S, G):
        raise ValueError(f"mc3_swap: U must be [{G * T}] and u [{S}, {G}]")
    if U.device.type == "cpu":
        return mc3_swap_plain(batch, U, pair, u, betas)
    if not 2 <= T <= MAX_TEMPS:
        raise ValueError(f"mc3_swap: {T} temperatures, the kernel takes 2 to {MAX_TEMPS}")
    fields = [getattr(batch, name) for name in FIELDS]
    for name, x in zip(FIELDS, fields):
        build.require_cuda(x, name)
        if x.shape[0] != G * T or x.element_size() != 4:
            raise ValueError(f"mc3_swap: {name} must be [{G * T}, ...] of 4-byte entries")
    for name, x in (("U", U), ("u", u), ("betas", betas)):
        build.require_cuda(x, name, torch.float32)
    build.require_cuda(pair, "pair", torch.int32)
    dev = U.device
    accept = torch.empty((S, G), dtype=torch.bool, device=dev)  # written as bytes 0 / 1
    counts = torch.empty((2, T - 1), dtype=torch.int32, device=dev)
    n = len(fields)
    bases = (ctypes.c_void_p * n)(*[x.data_ptr() for x in fields])
    rows = (ctypes.c_longlong * n)(*[x[0].numel() * 4 for x in fields])
    p = build.ptr
    err = build.bind("mcmcdate_mc3_swap_f32", _ARGTYPES)(
        ctypes.addressof(bases), ctypes.addressof(rows), n, p(U), p(pair), p(u), p(betas),
        p(accept), p(counts[0]), p(counts[1]), p(_ticket(str(dev))), G, T, S,
        build.stream_ptr(dev))
    build.check(err, "mc3_swap kernel")
    mc3_swap.launches += 1
    return accept, counts[0], counts[1]


mc3_swap.launches = 0
