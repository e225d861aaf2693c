"""B1 ``band_matmul`` and B2 ``band_matmul_t``: ``X @ M`` and ``X @ M^T``
for a block-tridiagonal ``M``, with a fused per-chain reduction.

They replace the XLA-compiled ``block_tridiag_matmul`` and
``block_tridiag_matmul_t`` (``mcmcdate_tpu/ops/banded.py:209, 235``), which
carry every precision and Cholesky product of the banded likelihood kind:
the whitened residual ``(d - mu) L`` (with ``mu`` subtracted as ``X`` is
read and ``sum y^2`` as the reduction), ``z = y L^T``, a sequential
ticket's ``dy = delta L`` (with ``-0.5 sum dy (2 y + dy)``), the glob
families' ``delta @ P`` and the point and range steps' ``z += dacc P``.
``M`` is given by its blocks ``B3 [nb, 3, wb, wb]``, ``B3[n, o] = M[block
n, block n + o - 1]`` (``ops.banded.blocks_from_sym_band`` and
``blocks_from_upper_band``); ``X`` is ``[C, D]`` with ``D <= nb wb``.

A call may take a window ``(n0, n1)`` of output blocks: the product is
formed there only (from input blocks ``n0 - 1`` to ``n1``), which is the
whole product where ``X`` is zero outside the blocks that reach the
window: the rows of a ticket or of a subtree.  ``x_rows = (r0, r1)`` reads
``X`` as zero outside the columns ``[r0, r1)`` (a ticket's delta, whose
other entries its prologue did not write).  Without ``into`` the other
blocks of the output are zero; with ``into`` the product is added to it on
the window (no reduction).  ``upper`` says that ``M``'s sub-diagonal
blocks are zero (``L``), which the kernel then skips.

Each wrapper runs the plain PyTorch version (the einsum-and-shift form of
the JAX functions) for CPU tensors and launches its kernel for CUDA
tensors (float32), or raises; it counts its launches in
``<wrapper>.launches``.  The kernel (``csrc/band_matmul.cu``) is a float32
GEMM on the SIMT cores, one CTA per tile of chains and columns of one
output block (no TF32).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P) + (_I,) * 11 + (ctypes.c_float, _P)


def _window(window, nb: int) -> tuple:
    n0, n1 = (0, nb) if window is None else (int(window[0]), int(window[1]))
    return max(n0, 0), min(n1, nb)


def band_matmul_plain(x, B3, sub=None, window=None, y=None, into=None, upper=False,
                      x_rows=None, trans=False):
    """Plain version of :func:`band_matmul` (``trans``: of
    :func:`band_matmul_t`): the JAX functions' three block products and two
    block shifts, over the window's blocks."""
    del upper  # the zero blocks add exact zeros
    C, D = x.shape
    if x_rows is not None:
        r0, r1 = x_rows
        keep = torch.zeros(D, dtype=torch.bool, device=x.device)
        keep[r0:r1] = True
        x = torch.where(keep, x if sub is None else x - sub, 0.0)
        sub = None
    nb, _, wb, _ = B3.shape
    n0, n1 = _window(window, nb)
    M = n1 - n0
    lo, hi = n0 * wb, min(n1 * wb, D)
    if M <= 0:
        prod = x.new_zeros((C, 0))
    else:
        # Input blocks n0 - 1 .. n1, zero-padded past either end.
        a0, a1 = max(n0 - 1, 0), min(n1 + 1, nb)
        c0, c1 = a0 * wb, min(a1 * wb, D)
        xs = x[:, c0:c1] if sub is None else x[:, c0:c1] - sub[c0:c1]
        xb = x.new_zeros((C, (M + 2) * wb))
        start = (a0 - (n0 - 1)) * wb
        xb[:, start:start + (c1 - c0)] = xs
        xb = xb.reshape(C, M + 2, wb)
        Bp = B3.new_zeros((M + 2, 3, wb, wb))
        Bp[a0 - (n0 - 1):a1 - (n0 - 1)] = B3[a0:a1]
        if trans:
            # out[m] = sum_o X[m + o - 1] @ B3[m, o]^T
            prod = sum(torch.einsum("cmk,mvk->cmv", xb[:, o:o + M], Bp[1:1 + M, o])
                       for o in range(3))
        else:
            # out[m] = sum_o X[m + 1 - o] @ B3[m + 1 - o, o]
            prod = sum(torch.einsum("cmk,mkv->cmv", xb[:, 2 - o:2 - o + M], Bp[2 - o:2 - o + M, o])
                       for o in range(3))
        prod = prod.reshape(C, M * wb)[:, :hi - lo]
    if into is not None:
        into[:, lo:hi] += prod
        return into, None
    out = x.new_zeros((C, D))
    out[:, lo:hi] = prod
    if y is None:
        red = torch.sum(prod * prod, dim=-1)
    else:
        red = -0.5 * torch.sum(prod * (2.0 * y[:, lo:hi] + prod), dim=-1)
    return out, red


def band_matmul_t_plain(x, B3, sub=None, window=None, y=None, into=None, upper=False,
                        x_rows=None):
    """Plain version of :func:`band_matmul_t`."""
    return band_matmul_plain(x, B3, sub, window, y, into, upper, x_rows, trans=True)


def _launch(x, B3, sub, window, y, into, upper, x_rows, trans):
    C, D = x.shape
    for name, t in (("x", x), ("B3", B3), ("sub", sub), ("y", y), ("into", into)):
        if t is not None:
            build.require_cuda(t, name, torch.float32)
    if B3.dim() != 4 or B3.shape[1] != 3 or B3.shape[2] != B3.shape[3]:
        raise ValueError(f"B3 must be [nb, 3, wb, wb], got {tuple(B3.shape)}")
    nb, wb = B3.shape[0], B3.shape[2]
    if D > nb * wb:
        raise ValueError(f"x has {D} columns, more than B3's {nb} x {wb}")
    for name, t, shape in (("sub", sub, (D,)), ("y", y, (C, D)), ("into", into, (C, D))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")
    n0, n1 = _window(window, nb)
    r0, r1 = (0, D) if x_rows is None else (max(int(x_rows[0]), 0), min(int(x_rows[1]), D))
    dev = x.device
    if into is not None:
        out, red, partial = into, None, None
    else:
        # The kernel writes every block (zeros outside the window) and every
        # chain's reduction, unless the window is empty.
        alloc = torch.zeros if n1 <= n0 else torch.empty
        out = alloc((C, D), dtype=torch.float32, device=dev)
        red = alloc(C, dtype=torch.float32, device=dev)
        G = build.bind("mcmcdate_band_partials", (_I, _I, _I))(C, wb, nb)
        partial = torch.empty((C, G), dtype=torch.float32, device=dev)
    p = build.ptr
    err = build.bind("mcmcdate_band_matmul_f32", _ARGTYPES)(
        p(x), p(sub), p(B3), p(y), p(out), p(red), p(partial), C, D, nb, wb, n0, n1, r0, r1,
        int(trans), int(bool(upper)), int(into is not None), -0.5 if y is not None else 1.0,
        build.stream_ptr(dev))
    build.check(err, "band_matmul_t kernel" if trans else "band_matmul kernel")
    return out, red


def band_matmul(x, B3, sub=None, window=None, y=None, into=None, upper=False, x_rows=None):
    """``out = (x - sub) @ M`` on the output blocks of ``window`` (None:
    all) and a per-chain reduction over them: ``-0.5 * sum out (2 y + out)``
    when ``y`` is given, else ``sum out^2``.  Returns ``(out, red)``:
    ``out`` ``[C, D]`` zero outside the window, or, with ``into``, ``into``
    with the product added on the window, and ``red`` None.  ``x``, ``y``
    and ``into`` are ``[C, D]``, ``sub`` ``[D]``, ``B3`` ``[nb, 3, wb,
    wb]``; ``x`` reads as zero outside the columns ``x_rows`` (None: all).
    The plain version runs for CPU tensors, kernel B1 for CUDA tensors
    (float32)."""
    if x.device.type == "cpu":
        return band_matmul_plain(x, B3, sub, window, y, into, upper, x_rows)
    out = _launch(x, B3, sub, window, y, into, upper, x_rows, False)
    band_matmul.launches += 1
    return out


def band_matmul_t(x, B3, sub=None, window=None, y=None, into=None, upper=False, x_rows=None):
    """``out = (x - sub) @ M^T``, otherwise as :func:`band_matmul`: kernel
    B2 for CUDA tensors (float32), the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return band_matmul_t_plain(x, B3, sub, window, y, into, upper, x_rows)
    out = _launch(x, B3, sub, window, y, into, upper, x_rows, True)
    band_matmul_t.launches += 1
    return out


band_matmul.launches = 0
band_matmul_t.launches = 0
