"""A1 ``admm_shift``, A2 ``admm_eig_scale`` and A3 ``admm_update``: the
elementwise passes of one ADMM iteration of the graphical lasso, in float64.

Replace the body of the XLA-compiled ``while_loop`` of
``graphical_lasso_admm`` (``mcmcdate_tpu/utils/glasso.py:81``, body
109-135); the loop itself runs on the host (``utils/glasso.py``), and the
iteration's ``torch.linalg.eigh`` and product ``Qs @ Q.T`` stay library
calls, as they were XLA's.  One iteration::

    A = admm_shift(Z, U, S, t, fac)        # U /= fac; A = sym(t (Z - U) - S)
    lam, Q = torch.linalg.eigh(A)
    Qs = admm_eig_scale(lam, Q, t)         # Q diag(theta(lam, t))
    rs = admm_update(Qs @ Q.mT, Z, U, alpha, rho / t)   # Z, U in place; [r^2, s^2]

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel (``csrc/glasso_admm.cu``, built with ``-fmad=false``) for CUDA
tensors, which must be float64; it counts its launches in
``<wrapper>.launches``.  The plain versions repeat ``glasso.py``'s
expressions op by op, so A1, A2 and A3's ``Z`` and ``U`` are bitwise equal
to them on the card; A3's two sums are taken in another order.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


# The plain versions divide by a tensor on the operands' device: PyTorch's
# CUDA division by a Python number multiplies by its reciprocal, which is
# not the division the kernels (and XLA) round.


def admm_shift_plain(Z, U, S, t, fac):
    """Plain version of :func:`admm_shift`."""
    U.div_(U.new_tensor(fac))
    B = t * (Z - U) - S
    return (B + B.mT) / B.new_tensor(2.0)


def admm_eig_scale_plain(lam, Q, t):
    """Plain version of :func:`admm_eig_scale`."""
    th = (lam + torch.sqrt(lam * lam + 4.0 * t)) / lam.new_tensor(2.0 * t)
    return Q * th


def admm_update_plain(T, Z, U, alpha, k):
    """Plain version of :func:`admm_update`."""
    Tr = alpha * T + (1.0 - alpha) * Z
    A = Tr + U
    Zn = torch.sign(A) * torch.clamp(torch.abs(A) - k, min=0.0)
    Un = U + Tr - Zn
    rs = torch.stack([torch.sum((T - Zn) * (T - Zn)), torch.sum((Zn - Z) * (Zn - Z))])
    Z.copy_(Zn)
    U.copy_(Un)
    return rs


def _square(t, name, p=None):
    build.require_cuda(t, name, torch.float64)
    if t.dim() != 2 or t.shape[0] != t.shape[1] or (p is not None and t.shape[0] != p):
        raise ValueError(f"{name} must be a square [p, p] matrix, got {tuple(t.shape)}")
    return t.shape[0]


def admm_shift(Z, U, S, t, fac):
    """Divide ``U`` by ``fac`` in place (the previous iteration's residual
    balancing, ``glasso.py:135``) and return the eigh input ``A = (B +
    B^T) / 2`` with ``B = t (Z - U) - S`` (``glasso.py:110``; the
    symmetrisation is ``jnp.linalg.eigh``'s own).  ``Z``, ``U``, ``S``:
    ``[p, p]`` float64."""
    if Z.device.type == "cpu":
        return admm_shift_plain(Z, U, S, t, fac)
    p = _square(Z, "Z")
    _square(U, "U", p)
    _square(S, "S", p)
    A = torch.empty_like(Z)
    err = build.bind("mcmcdate_admm_shift_f64", (_P, _P, _P, _P, _I, _D, _D, _P))(
        U.data_ptr(), Z.data_ptr(), S.data_ptr(), A.data_ptr(), p, float(t), float(fac),
        build.stream_ptr(Z.device))
    build.check(err, "admm_shift kernel")
    admm_shift.launches += 1
    return A


def admm_eig_scale(lam, Q, t):
    """``Q diag(theta)`` with ``theta = (lam + sqrt(lam^2 + 4 t)) / (2 t)``
    (``glasso.py:111-112``), in ``Q``'s layout: row-major, or column-major
    as ``torch.linalg.eigh`` returns it.  ``lam`` ``[p]``, ``Q`` ``[p, p]``,
    float64."""
    if Q.device.type == "cpu":
        return admm_eig_scale_plain(lam, Q, t)
    p = Q.shape[0]
    build.require_cuda(lam, "lam", torch.float64)
    if Q.dim() != 2 or Q.shape != (p, p) or lam.shape != (p,):
        raise ValueError(f"Q must be [p, p] and lam [p], got {tuple(Q.shape)}, {tuple(lam.shape)}")
    col_major = not Q.is_contiguous()
    build.require_cuda(Q.mT if col_major else Q, "Q (or its transpose)", torch.float64)
    out = torch.empty_like(Q)  # keeps Q's strides
    err = build.bind("mcmcdate_admm_eig_scale_f64", (_P, _P, _P, _I, _I, _D, _P))(
        lam.data_ptr(), Q.data_ptr(), out.data_ptr(), p, int(col_major), float(t),
        build.stream_ptr(Q.device))
    build.check(err, "admm_eig_scale kernel")
    admm_eig_scale.launches += 1
    return out


def admm_update(T, Z, U, alpha, k):
    """The relaxed soft-threshold update (``glasso.py:125-129``): with ``Tr
    = alpha T + (1 - alpha) Z``, ``Z <- sign(Tr + U) max(|Tr + U| - k, 0)``
    and ``U <- U + Tr - Z``, both in place; returns ``[sum (T - Z')^2,
    sum (Z' - Z)^2]`` (float64, on ``T``'s device; the kernel sums
    per-block partials in a fixed order).  ``T``, ``Z``, ``U``: ``[p, p]``
    float64."""
    if T.device.type == "cpu":
        return admm_update_plain(T, Z, U, alpha, k)
    p = _square(T, "T")
    _square(Z, "Z", p)
    _square(U, "U", p)
    blocks = build.bind("mcmcdate_admm_update_blocks", (_I,))(p)
    partial = torch.empty(2 * blocks, dtype=torch.float64, device=T.device)
    out = torch.empty(2, dtype=torch.float64, device=T.device)
    err = build.bind("mcmcdate_admm_update_f64", (_P, _P, _P, _I, _D, _D, _D, _P, _P, _P))(
        T.data_ptr(), Z.data_ptr(), U.data_ptr(), p, float(alpha), 1.0 - float(alpha),
        float(k), partial.data_ptr(), out.data_ptr(), build.stream_ptr(T.device))
    build.check(err, "admm_update kernel")
    admm_update.launches += 1
    return out


admm_shift.launches = 0
admm_eig_scale.launches = 0
admm_update.launches = 0

KERNELS = (admm_shift, admm_eig_scale, admm_update)
PLAIN = (admm_shift_plain, admm_eig_scale_plain, admm_update_plain)
