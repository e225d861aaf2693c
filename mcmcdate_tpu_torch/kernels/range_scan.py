"""K5 ``range_scan``: the Gram blocks and accept scan of a subtree-range
block (ultrametric or rate subtree scales), fused into one launch.

Replaces the XLA-compiled core of ``FastSweeps._mega_range_lik``
(``mcmcdate_tpu/engine/fast_sweep.py:1839-1874``); the rest of that step
is the prologue and epilogue of :mod:`.range_step`.  Each of the block's S
tickets scales its subtree by ``f``, so its distance delta is rank-1,
``delta_a = coef_a g_a`` with ``coef = f - 1`` and ``g_a`` on RB rows.  Per
chain: ``v_a = g_a . zg_a``, the Gram matrix ``G_ab = g_a' Q_ab g_b`` with
``Q`` the precision between the block's rows, ``dq0_a = 2 coef_a v_a +
coef_a^2 G_aa``, ``X_ab = coef_a G_ab coef_b``, then the serial scan
``dq_t = dq0_t + 2 sum_{a<t accepted} X_at`` and accept where ``log u_t <
beta_prior dpr_t - (beta dq_t) / 2 + lmhg_t``, ``beta`` and ``beta_prior``
the chain's likelihood and prior temperatures (the JAX scan's ``la_t``,
``engine/fast_sweep.py:1860``).

On the H100 it is bound by operations: the upper triangle of ``G`` is
``(S RB)^2 / 2`` multiply-adds per chain (about 0.5 G at 1024 chains, since
S RB <= 1024), against a few MB of bytes.  The kernel
(``csrc/range_scan.cu``) takes one CTA per tile of 4 chains and walks the
tickets in order: for ticket t it forms ``Q[:, t] g_t`` on the rows of the
tickets up to t with ``Q`` staged through shared memory by bulk copies and
shared by the tile's chains, contracts it with ``g_t`` and the accepted
deltas before t to get ``dq_t``, and takes the scan step.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P,) * 3 + (_I,) + (_P,) * 8 + (_I,) * 3 + (_P,)
S_MAX = 64     # tickets per block the kernel takes
F_MAX = 1024   # rows per block (S RB) the kernel takes


def kernel_layout(Q):
    """``Q`` ``[F, F]`` as the kernel reads it: a view equal to ``Q`` whose
    columns are the rows of a buffer with a pitch of a multiple of 4 floats,
    so that the kernel stages them with 16-byte copies.  ``FastSweeps``
    builds each block's ``Q`` so once."""
    F = Q.shape[0]
    buf = Q.new_zeros((F, -(-F // 4) * 4))
    buf[:, :F] = Q.T
    return buf[:, :F].T


def range_scan_plain(g, zg, Q, coef, d_pr, lmhg, u, beta=None, beta_prior=None):
    """Plain PyTorch version of :func:`range_scan` (``beta`` or
    ``beta_prior`` None: untempered)."""
    C, S, RB = g.shape
    if beta_prior is not None:
        d_pr = beta_prior[:, None] * d_pr
    v = torch.sum(g * zg, dim=-1)                                    # [C, S]
    G = torch.einsum("cai,aibj,cbj->cab", g, Q.reshape(S, RB, S, RB), g)
    gamma = torch.diagonal(G, dim1=1, dim2=2)
    dq0 = 2.0 * coef * v + coef * coef * gamma
    X = coef[:, :, None] * G * coef[:, None, :]
    logu = torch.log(u)
    accm = torch.zeros_like(coef)
    accept = torch.zeros((C, S), dtype=torch.bool, device=g.device)
    dq = torch.zeros_like(coef)
    for t in range(S):
        dq_t = dq0[:, t] + 2.0 * torch.sum(accm * X[:, :, t], dim=-1)
        bdq = dq_t if beta is None else beta * dq_t
        la_t = d_pr[:, t] - 0.5 * bdq + lmhg[:, t]
        la_t = torch.where(torch.isnan(la_t), -torch.inf, la_t)
        a_t = logu[:, t] < la_t
        accm[:, t] = a_t.to(g.dtype)
        accept[:, t] = a_t
        dq[:, t] = dq_t
    return accept, dq


def range_scan(g, zg, Q, coef, d_pr, lmhg, u, beta=None, beta_prior=None):
    """Accept scan of a range block.  ``g`` ``[C, S, RB]`` are the tickets'
    rank-1 delta directions (zero on pad rows), ``zg`` ``[C, S, RB]`` the
    carried ``z`` at their rows, ``Q`` ``[S*RB, S*RB]`` the precision
    between those rows (for the kernel in :func:`kernel_layout`), ``coef =
    f - 1``, ``d_pr``, ``lmhg`` and the accept uniforms ``u`` ``[C, S]``,
    and the chains' likelihood and prior temperatures ``beta`` and
    ``beta_prior`` ``[C]`` (None: 1).  Returns ``(accept [C, S] bool, dq [C,
    S])``.  The plain version runs for CPU tensors, kernel K5 for CUDA
    tensors (float32)."""
    if g.device.type == "cpu":
        return range_scan_plain(g, zg, Q, coef, d_pr, lmhg, u, beta, beta_prior)
    C, S, RB = g.shape
    for name, t in (("g", g), ("zg", zg), ("coef", coef), ("d_pr", d_pr), ("lmhg", lmhg),
                    ("u", u)):
        build.require_cuda(t, name, torch.float32)
    if Q.device != g.device or Q.dtype != torch.float32:
        raise ValueError(f"Q must be a float32 tensor on {g.device}")
    if S > S_MAX or S * RB > F_MAX:
        raise ValueError(f"range_scan: {S} tickets of {RB} rows per block, the kernel takes at "
                         f"most {S_MAX} tickets and {F_MAX} rows")
    if Q.shape != (S * RB, S * RB):
        raise ValueError(f"Q must be [{S * RB}, {S * RB}], got {tuple(Q.shape)}")
    if not (Q.stride(0) == 1 and Q.stride(1) % 4 == 0 and Q.stride(1) >= S * RB
            and Q.data_ptr() % 16 == 0):
        raise ValueError("range_scan: Q must be in kernel_layout")
    dev = g.device
    beta = build.beta_arg(beta, C, dev)
    beta_prior = build.beta_arg(beta_prior, C, dev)
    accept = torch.empty((C, S), dtype=torch.bool, device=dev)  # written as bytes 0 / 1
    dq = torch.empty((C, S), dtype=torch.float32, device=dev)
    p = build.ptr
    err = build.bind("mcmcdate_range_scan_f32", _ARGTYPES)(
        p(g), p(zg), p(Q), Q.stride(1), p(coef), p(d_pr), p(lmhg), p(u), p(beta),
        p(beta_prior), p(accept), p(dq), C, S, RB, build.stream_ptr(dev),
    )
    build.check(err, "range_scan kernel")
    range_scan.launches += 1
    return accept, dq


range_scan.launches = 0
