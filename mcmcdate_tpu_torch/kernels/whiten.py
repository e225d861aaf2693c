"""K2 ``whiten``: ``(x[:, rows] - sub[rows]) @ L[rows, :]`` with a fused
row reduction.

Replaces the XLA-compiled ``whitened_residual_internal``
(``mcmcdate_tpu/models/dating.py:209``), ``mvn_log_density``
(``ops/mvn.py:121``) and the incremental likelihood classes of
``MHKernel._ticket_step`` (``engine/mh.py:147-180``).  One row list covers
all classes: every row (full), the <= KG touched entries (gather), or
``{0} U [lo, lo+B)`` (range); entries equal to ``D`` read as zero.  On the
H100 the full class is a float32 product computed on the SIMT cores (no
TF32), the others are bound by reading ``L[rows, :]`` and writing ``dy``;
the kernel (``csrc/whiten.cu``) is a register-tiled GEMM that stages its
tiles with asynchronous copies into two buffers, gathers and subtracts
while it stages, and reduces each chain's row in its epilogue.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _I, _P, _P, _I, ctypes.c_float, _P, _P, _P, _I, _I, _P)


def range_rows(lo: int, width: int, D: int) -> list:
    """Row list of a range class: entry 0 plus ``[lo, lo + width)``, with
    rows past the end padded to ``D``.  ``lo >= 1`` always holds
    (``FlatTopology.dist_range``), so entry 0 is never counted twice."""
    if lo < 1:
        raise ValueError(f"range rows must start at 1 or later, got {lo}")
    return [0] + [min(r, D) for r in range(lo, lo + width)]


def whiten_plain(x, L, rows=None, sub=None, y=None, minus_y=False):
    """Plain PyTorch version of :func:`whiten`."""
    D = L.shape[0]
    if rows is None:
        a = x if sub is None else x - sub
        Lr = L
    else:
        rows = rows.long()
        valid = rows < D
        r = torch.where(valid, rows, 0)
        a = x[:, r]
        if sub is not None:
            a = a - sub[r]
        a = torch.where(valid, a, 0.0)
        Lr = torch.where(valid[:, None], L[r], 0.0)
    dy = a @ Lr
    if y is None:
        return dy, torch.sum(dy * dy, dim=-1)
    if minus_y:
        dy = dy - y
    return dy, -0.5 * torch.sum(dy * (2.0 * y + dy), dim=-1)


def whiten(x, L, rows=None, sub=None, y=None, minus_y=False):
    """``dy = (x[:, rows] - sub[rows]) @ L[rows, :]`` (minus ``y`` when
    ``minus_y``) and a per-chain reduction: ``-0.5 * sum(dy * (2 y + dy))``
    when ``y`` is given (the log-likelihood delta), else ``sum(dy^2)``.

    ``x`` and ``y`` are ``[C, D]``, ``L`` ``[D, D]``, ``sub`` ``[D]``,
    ``rows`` an int32 ``[R]`` list (None: every row, the full class, which
    the kernel reads contiguously with no index reads).  The plain version
    runs for CPU tensors, kernel K2 for CUDA tensors (float32)."""
    if x.device.type == "cpu":
        return whiten_plain(x, L, rows, sub, y, minus_y)
    C, D = x.shape
    for name, t in (("x", x), ("L", L), ("sub", sub), ("y", y)):
        if t is not None:
            build.require_cuda(t, name, torch.float32)
    if rows is not None:
        build.require_cuda(rows, "rows", torch.int32)
    if L.shape != (D, D):
        raise ValueError(f"L must be [{D}, {D}], got {tuple(L.shape)}")
    tiles = build.bind("mcmcdate_whiten_tiles", (_I, _I))(C, D)
    dy = torch.empty((C, D), dtype=torch.float32, device=x.device)
    red = torch.empty(C, dtype=torch.float32, device=x.device)
    partial = torch.empty((C, tiles), dtype=torch.float32, device=x.device)
    p = build.ptr
    err = build.bind("mcmcdate_whiten_f32", _ARGTYPES)(
        p(x), p(sub), p(rows), D if rows is None else rows.numel(), p(L), p(y), int(bool(minus_y)),
        -0.5 if y is not None else 1.0, p(dy), p(red), p(partial), C, D,
        build.stream_ptr(x.device),
    )
    build.check(err, "whiten kernel")
    whiten.launches += 1
    return dy, red


whiten.launches = 0
