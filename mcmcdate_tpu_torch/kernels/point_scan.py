"""K4 ``point_scan``: the sequential-correction accept scan of a point
mega-step (likelihood-coupled node slides and branch-rate scales).

Replaces the XLA-compiled correction scan of ``FastSweeps._mega_point_lik``
(``mcmcdate_tpu/engine/fast_sweep.py:1477-1534``).  Per chain, over the
step's B tickets in order, each with a distance delta ``delta_t`` on KD
rows: ``dq0_t = 2 delta_t . zG_t + delta_t' Pself_t delta_t``, the cross
terms ``T_at = delta_a' Pcross_at delta_t`` and the scan ``dq_t = dq0_t +
2 sum_{a<t accepted} T_at``, ``log alpha_t = beta_prior dpr_t - (beta
dq_t) / 2 + lmhg_t`` with the chain's likelihood and prior temperatures
``beta`` and ``beta_prior`` (the JAX scan's ``la_t``,
``engine/fast_sweep.py:1511``), accept where ``log u_t < log alpha_t``.
The scan runs in sub-blocks of ``SUB`` tickets; between them the gathered
``zG`` takes the accepted deltas through ``Pblk`` (``zG += dacc @ Pblk[sub
rows]``).

On the H100 it is bound by its serial scan and by the reads of the step's
``Pblk`` (up to 9 MB at 1000 taxa, shared by every chain): the cross terms
are ``B * SUB * KD^2`` multiply-adds per chain and the ``zG`` update ``B *
KD * B * KD`` at most.  The kernel (``csrc/point_scan.cu``) gives a block
to a tile of 8 chains, so that ``Pblk`` is read from L2 once per tile and
not once per chain: it stages each sub-block's diagonal block of ``Pblk``
in shared memory (``cp.async``), where one warp per chain runs the scan
with each lane's tickets in registers (for KD <= 3), adding an accepted
ticket's delta to the ``zG`` of the later tickets; then it streams the
panels of the later columns through shared memory (two buffers) and
applies the sub-block's accepted deltas to them as a register-tiled
product for the 8 chains.  Its sub-blocks hold ``192 // KD`` tickets (the
diagonal block then fits in shared memory), not ``SUB``: sub-blocks change
only the order of the sums.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P,) * 8 + (_P, _P, _P) + (_I,) * 4 + (_P,)
SUB = 64  # the plain scan's sub-block (the JAX step's SUB)


def pitched(x):
    """``x`` ``[R, K]`` as a view of a zero-padded ``[R, ceil4(K)]`` buffer:
    rows on a 16-byte pitch, which the kernel stages with 16-byte copies."""
    buf = x.new_zeros((x.shape[0], (x.shape[1] + 3) // 4 * 4))
    buf[:, :x.shape[1]] = x
    return buf[:, :x.shape[1]]


def point_scan_plain(delta, zG, Pblk, d_pr, lmhg, u, beta=None, beta_prior=None):
    """Plain PyTorch version of :func:`point_scan` (``beta`` or
    ``beta_prior`` None: untempered)."""
    C, B, kd = delta.shape
    if beta_prior is not None:
        d_pr = beta_prior[:, None] * d_pr
    Pblk4 = Pblk.reshape(B, kd, B, kd)
    logu = torch.log(u)
    zG = zG.clone()
    accept = torch.zeros((C, B), dtype=torch.bool, device=delta.device)
    dq_all = torch.zeros_like(d_pr)
    n_sub = (B + SUB - 1) // SUB
    for s0 in range(n_sub):
        lo, hi = s0 * SUB, min(s0 * SUB + SUB, B)
        sn = hi - lo
        dl = delta[:, lo:hi]                                  # [C, S, KD]
        zg = zG[:, lo * kd:hi * kd].reshape(C, sn, kd)
        blk = Pblk4[lo:hi, :, lo:hi, :]
        pself = torch.diagonal(blk, dim1=0, dim2=2).permute(2, 0, 1)   # [S, KD, KD]
        dq0 = (2.0 * torch.sum(dl * zg, dim=-1)
               + torch.einsum("csi,sij,csj->cs", dl, pself, dl))
        T = torch.einsum("cai,abij,cbj->cab", dl, blk.permute(0, 2, 1, 3), dl)
        accm = torch.zeros((C, sn), dtype=delta.dtype, device=delta.device)
        for t in range(sn):
            dq_t = dq0[:, t] + 2.0 * torch.sum(accm * T[:, :, t], dim=-1)
            bdq = dq_t if beta is None else beta * dq_t
            la_t = d_pr[:, lo + t] - 0.5 * bdq + lmhg[:, lo + t]
            la_t = torch.where(torch.isnan(la_t), -torch.inf, la_t)
            a_t = logu[:, lo + t] < la_t
            accm[:, t] = a_t.to(delta.dtype)
            accept[:, lo + t] = a_t
            dq_all[:, lo + t] = dq_t
        if s0 < n_sub - 1:
            dacc = torch.where(accept[:, lo:hi, None], dl, 0.0)
            zG = zG + dacc.reshape(C, -1) @ Pblk[lo * kd:hi * kd]
    return accept, dq_all


def point_scan(delta, zG, Pblk, d_pr, lmhg, u, beta=None, beta_prior=None):
    """Accept scan of a point mega-step.  ``delta`` ``[C, B, KD]`` are the
    tickets' distance deltas (zero on pad rows), ``zG`` ``[C, B*KD]`` the
    carried ``z`` at their rows, ``Pblk`` ``[B*KD, B*KD]`` the precision
    between them (zero rows and columns for pads; on a CUDA tensor its rows
    on a 16-byte pitch, as :func:`pitched` makes them),
    ``d_pr``, ``lmhg`` and the accept uniforms ``u`` ``[C, B]``, and the
    chains' likelihood and prior temperatures ``beta`` and ``beta_prior``
    ``[C]`` (None: 1).  Returns
    ``(accept [C, B] bool, dq [C, B])``.  The plain version runs for CPU
    tensors, kernel K4 for CUDA tensors (float32)."""
    if delta.device.type == "cpu":
        return point_scan_plain(delta, zG, Pblk, d_pr, lmhg, u, beta, beta_prior)
    C, B, kd = delta.shape
    for name, t in (("delta", delta), ("zG", zG), ("d_pr", d_pr), ("lmhg", lmhg), ("u", u)):
        build.require_cuda(t, name, torch.float32)
    if Pblk.device != delta.device or Pblk.dtype != torch.float32:
        raise ValueError(f"Pblk must be a float32 tensor on {delta.device}")
    if Pblk.stride(1) != 1 or Pblk.stride(0) % 4 or Pblk.data_ptr() % 16:
        raise ValueError("Pblk's rows must lie on a 16-byte pitch (point_scan.pitched)")
    dev = delta.device
    beta = build.beta_arg(beta, C, dev)
    beta_prior = build.beta_arg(beta_prior, C, dev)
    accept = torch.empty((C, B), dtype=torch.bool, device=dev)  # written as bytes 0 / 1
    dq = torch.empty((C, B), dtype=torch.float32, device=dev)
    zwork = torch.empty_like(zG)  # the chains' zG as the sub-blocks update it
    p = build.ptr
    err = build.bind("mcmcdate_point_scan_f32", _ARGTYPES)(
        p(delta), p(zG), p(Pblk), p(d_pr), p(lmhg), p(u), p(beta), p(beta_prior),
        p(accept), p(dq), p(zwork),
        C, B, kd, Pblk.stride(0), build.stream_ptr(dev),
    )
    build.check(err, "point_scan kernel")
    point_scan.launches += 1
    return accept, dq


point_scan.launches = 0
