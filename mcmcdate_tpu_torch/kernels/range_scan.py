"""K5 ``range_scan``: the Gram blocks and accept scan of a subtree-range
block (ultrametric or rate subtree scales).

Replaces the XLA-compiled core of ``FastSweeps._mega_range_lik``
(``mcmcdate_tpu/engine/fast_sweep.py:1839-1874``).  Each of the block's S
tickets scales its subtree by ``f``, so its distance delta is rank-1,
``delta_a = coef_a g_a`` with ``coef = f - 1`` and ``g_a`` on RB rows.  Per
chain: ``v_a = g_a . zg_a``, the Gram matrix ``G_ab = g_a' Q_ab g_b`` with
``Q`` the precision between the block's rows, ``dq0_a = 2 coef_a v_a +
coef_a^2 G_aa``, ``X_ab = coef_a G_ab coef_b``, then the serial scan
``dq_t = dq0_t + 2 sum_{a<t accepted} X_at`` and accept where ``log u_t <
dpr_t - dq_t / 2 + lmhg_t``.

On the H100 it is bound by operations: ``G`` is ``(S RB)^2`` multiply-adds
per chain (about 1 G at 1024 chains, since S RB = 1024), against a few MB
of bytes.  The kernel (``csrc/range_scan.cu``) computes the upper triangle
of ``G`` with one block per (chain tile, ticket pair), staging the pair's
``Q`` rows and the tile's ``g`` rows in shared memory, then runs the scan
with one warp per chain.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P,) * 10 + (_I,) * 3 + (_P,)


def range_scan_plain(g, zg, Q, coef, d_pr, lmhg, u):
    """Plain PyTorch version of :func:`range_scan`."""
    C, S, RB = g.shape
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
        la_t = d_pr[:, t] - 0.5 * dq_t + lmhg[:, t]
        la_t = torch.where(torch.isnan(la_t), -torch.inf, la_t)
        a_t = logu[:, t] < la_t
        accm[:, t] = a_t.to(g.dtype)
        accept[:, t] = a_t
        dq[:, t] = dq_t
    return accept, dq


def range_scan(g, zg, Q, coef, d_pr, lmhg, u):
    """Accept scan of a range block.  ``g`` ``[C, S, RB]`` are the tickets'
    rank-1 delta directions (zero on pad rows), ``zg`` ``[C, S, RB]`` the
    carried ``z`` at their rows, ``Q`` ``[S*RB, S*RB]`` the precision
    between those rows, ``coef = f - 1``, ``d_pr``, ``lmhg`` and the accept
    uniforms ``u`` ``[C, S]``.  Returns ``(accept [C, S] bool, dq [C, S])``.
    The plain version runs for CPU tensors, kernel K5 for CUDA tensors
    (float32)."""
    if g.device.type == "cpu":
        return range_scan_plain(g, zg, Q, coef, d_pr, lmhg, u)
    C, S, RB = g.shape
    for name, t in (("g", g), ("zg", zg), ("Q", Q), ("coef", coef), ("d_pr", d_pr),
                    ("lmhg", lmhg), ("u", u)):
        build.require_cuda(t, name, torch.float32)
    if S > 64:
        raise ValueError(f"range_scan: {S} tickets per block, the scan takes at most 64")
    dev = g.device
    gram = torch.empty((C, S, S), dtype=torch.float32, device=dev)
    accept = torch.empty((C, S), dtype=torch.uint8, device=dev)
    dq = torch.empty((C, S), dtype=torch.float32, device=dev)
    p = build.ptr
    err = build.bind("mcmcdate_range_scan_f32", _ARGTYPES)(
        p(g), p(zg), p(Q), p(coef), p(d_pr), p(lmhg), p(u), p(gram), p(accept), p(dq),
        C, S, RB, build.stream_ptr(dev),
    )
    build.check(err, "range_scan kernel")
    range_scan.launches += 1
    return accept.bool(), dq


range_scan.launches = 0
