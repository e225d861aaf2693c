"""Block-banded MVN precision: the banded likelihood kind.

Port of ``mcmcdate_tpu/ops/banded.py``.  The precision lives in the
engine's internal pre-order layout as ``P = L L'`` with ``L`` upper-banded
of width ``w`` (the Cholesky banding estimator: regress each coordinate on
its ``w`` predecessors), stored as its band ``L[i, i..i+w]``: O(D w)
instead of O(D^2), so the kind runs past the dense precision's memory.
With a block size ``wb >= w`` both ``P`` and ``L`` are block tridiagonal,
``B3 [nb, 3, wb, wb]``, and every precision or Cholesky product of the
sweep is a block-tridiagonal product: kernels B1 ``band_matmul`` and B2
``band_matmul_t`` (``kernels/band_matmul.py``).

The host helpers (NumPy, float64) are copies of the JAX module's, which
imports JAX: they estimate the band and build its block forms once, at
``prepare`` and when a model or a sweep is built.
"""

from __future__ import annotations

import numpy as np

from ..kernels.band_matmul import band_matmul, band_matmul_t


def estimate_banded_chol(xs: np.ndarray, w: int, ridge: float = 1e-3):
    """Cholesky banding estimator.

    ``xs``: ``[n_samples, D]`` data, already in the layout the band lives
    in.  Returns ``(mu [D], Lb [D, w+1], log_det_sigma)`` with ``Lb`` the
    upper band of ``L`` (``Lb[i, t] = L[i, i+t]``), the estimated precision
    ``P = L L'`` and the model density ``N(mu, P^{-1})``.

    Row ``i`` of the regression: ``x_i = sum_a phi_a x_{i-p+a} + eps_i``
    over the window ``p = min(w, i)``; then ``T[i, i-p+a] = -phi_a``,
    ``D_ii = var(eps_i)``, ``P = T' D^{-1} T``.  ``ridge`` scales an
    identity added to each window Gram (relative to its mean diagonal) so
    that short samples stay well-posed.
    """
    xs = np.asarray(xs, np.float64)
    n, D = xs.shape
    w = int(min(w, D - 1)) if D > 1 else 0
    mu = xs.mean(axis=0)
    xc = xs - mu
    denom = max(n - 1, 1)
    # Covariance band: Sband[i, s] = Cov(x_i, x_{i-s}) for s = 0..w.
    Sband = np.zeros((D, w + 1))
    Sband[:, 0] = np.einsum("ni,ni->i", xc, xc) / denom
    for s in range(1, w + 1):
        Sband[s:, s] = np.einsum("ni,ni->i", xc[:, s:], xc[:, :-s]) / denom

    phi = np.zeros((D, w))  # phi[i, a]: coefficient on x_{i-p+a}
    sig2 = np.zeros(D)
    sig2[0] = Sband[0, 0]

    def _window_gram(i, p):
        # A[a, b] = Cov(x_{i-p+a}, x_{i-p+b}) from the band.
        r = i - p + np.arange(p)
        A = np.zeros((p, p))
        for a in range(p):
            for b in range(a, p):
                s = r[b] - r[a]
                A[a, b] = A[b, a] = Sband[r[b], s]
        return A

    # Small-i head: individual solves.
    head = min(w, D)
    for i in range(1, head):
        p = i
        A = _window_gram(i, p)
        c = Sband[i, p - np.arange(p)]
        A = A + ridge * (np.trace(A) / p) * np.eye(p)
        f = np.linalg.solve(A, c)
        phi[i, :p] = f
        sig2[i] = max(Sband[i, 0] - c @ f, 1e-12 * Sband[i, 0])

    # Tail i >= w: every window is w wide; the solves are batched.
    if D > w and w > 0:
        idx = np.arange(w, D)
        # A_i[a, b] = Sband[i - w + max(a, b), |a - b|]
        a_g, b_g = np.meshgrid(np.arange(w), np.arange(w), indexing="ij")
        rows = idx[:, None, None] - w + np.maximum(a_g, b_g)[None]
        offs = np.abs(a_g - b_g)[None]
        A = Sband[rows, np.broadcast_to(offs, rows.shape)]
        tr = np.trace(A, axis1=1, axis2=2) / w
        A = A + ridge * tr[:, None, None] * np.eye(w)[None]
        c = Sband[idx[:, None], (w - np.arange(w))[None, :]]
        f = np.linalg.solve(A, c[..., None])[..., 0]
        phi[w:] = f
        resid = Sband[idx, 0] - np.einsum("ia,ia->i", c, f)
        sig2[w:] = np.maximum(resid, 1e-12 * Sband[idx, 0])

    inv_sd = 1.0 / np.sqrt(sig2)
    # L = T' D^{-1/2}: L[i, j] for j in [i, i+w];
    # L[i, i] = 1/sd_i, L[i, i+t] = T[i+t, i] / sd_{i+t} = -phi_{i+t, ...}.
    Lb = np.zeros((D, w + 1))
    Lb[:, 0] = inv_sd
    for t in range(1, w + 1):
        j = np.arange(t, D)  # the regressed row i+t
        p = np.minimum(w, j)  # its window width
        # The coefficient of x_{j-t} in row j sits at slot a = p - t.
        a = p - t
        ok = a >= 0
        Lb[j[ok] - t, t] = -phi[j[ok], a[ok]] * inv_sd[j[ok]]
    log_det_sigma = float(np.sum(np.log(sig2)))
    return mu, Lb, log_det_sigma


def pband_from_chol_upper(Lb: np.ndarray) -> np.ndarray:
    """Symmetric band of ``P = L L'`` from the upper band of ``L``:
    ``pband [D, w+1]`` with ``pband[i, s] = P[i, i+s]`` (``P[i, i-s]`` by
    symmetry), ``s = 0..w``."""
    Lb = np.asarray(Lb, np.float64)
    D, w1 = Lb.shape
    w = w1 - 1
    pband = np.zeros((D, w + 1))
    # P[i, i+s] = sum_{t=s}^{w} Lb[i, t] * Lb[i+s, t-s]
    for s in range(w + 1):
        prod = Lb[: D - s, s:] * Lb[s:, : w + 1 - s]
        pband[: D - s, s] = prod.sum(axis=1)
    return pband


def blocks_from_sym_band(pband: np.ndarray, wb: int) -> np.ndarray:
    """Block-tridiagonal form ``B3 [nb, 3, wb, wb]`` of a symmetric-banded
    matrix given by ``pband [D, w+1]`` (``w <= wb`` required):
    ``B3[n, o] = M[n*wb:(n+1)*wb, (n+o-1)*wb:(n+o)*wb]``, zero-padded at
    the edges."""
    pband = np.asarray(pband, np.float64)
    D, w1 = pband.shape
    w = w1 - 1
    if w > wb:
        raise ValueError(f"band width {w} exceeds block size {wb}")
    nb = max(1, -(-D // wb))
    a_g, b_g = np.meshgrid(np.arange(wb), np.arange(wb), indexing="ij")
    B3 = np.zeros((nb, 3, wb, wb))
    for n in range(nb):
        i = n * wb + a_g
        for o in range(3):
            j = (n + o - 1) * wb + b_g
            s = j - i
            ok = (i < D) & (j >= 0) & (j < D) & (np.abs(s) <= w)
            ii = np.where(ok, np.where(s >= 0, i, j), 0)
            B3[n, o] = np.where(ok, pband[ii, np.abs(np.where(ok, s, 0))], 0.0)
    return B3


def blocks_from_upper_band(Lb: np.ndarray, wb: int) -> np.ndarray:
    """Block-tridiagonal form of the upper-banded ``L`` (its sub-diagonal
    blocks are zero; kept for the shared layout, skipped by the kernels'
    ``upper`` mode)."""
    Lb = np.asarray(Lb, np.float64)
    D, w1 = Lb.shape
    w = w1 - 1
    if w > wb:
        raise ValueError(f"band width {w} exceeds block size {wb}")
    nb = max(1, -(-D // wb))
    a_g, b_g = np.meshgrid(np.arange(wb), np.arange(wb), indexing="ij")
    B3 = np.zeros((nb, 3, wb, wb))
    for n in range(nb):
        i = n * wb + a_g
        for o in (1, 2):
            j = (n + o - 1) * wb + b_g
            t = j - i
            ok = (i < D) & (j < D) & (t >= 0) & (t <= w)
            B3[n, o] = np.where(ok, Lb[np.where(ok, i, 0), np.where(ok, t, 0)], 0.0)
    return B3


def rows_from_sym_band(pband: np.ndarray) -> np.ndarray:
    """Row band ``[D, 2w+1]`` of a symmetric-banded matrix given by ``pband
    [D, w+1]``: ``out[r, t] = M[r, r - w + t]``, zero outside the matrix
    (``band_rows_add``'s form of ``P``)."""
    pband = np.asarray(pband, np.float64)
    D, w1 = pband.shape
    w = w1 - 1
    out = np.zeros((D, 2 * w + 1))
    for s in range(w + 1):
        out[: D - s, w + s] = pband[: D - s, s]  # M[r, r + s]
        out[s:, w - s] = pband[: D - s, s]       # M[r, r - s] = M[r - s, r]
    return out


def sym_band_matvec(pband: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Host ``P @ x`` for a symmetric-banded ``P`` (``pband[i, s] =
    P[i, i+s]``)."""
    pband = np.asarray(pband, np.float64)
    x = np.asarray(x, np.float64)
    D, w1 = pband.shape
    out = pband[:, 0] * x
    for s in range(1, w1):
        out[: D - s] += pband[: D - s, s] * x[s:]
        out[s:] += pband[: D - s, s] * x[: D - s]
    return out


def default_block_size(w: int) -> int:
    """Block size for a band of width ``w``: at least ``w``, and 128 where
    the band is narrower (the JAX package's tile; the kernels' column tile)."""
    return max(w, 128)


def block_window(rows_lo: int, rows_hi: int, wb: int, nb: int, upper: bool = False) -> tuple:
    """The output blocks ``(n0, n1)`` that a product with a block-tridiagonal
    matrix can move when its input is zero outside the rows ``[rows_lo,
    rows_hi)``: the blocks holding them and the next one, and with a
    symmetric matrix (not ``upper``) also the one before."""
    if rows_hi <= rows_lo:
        return (0, 0)
    b0, b1 = rows_lo // wb, (rows_hi - 1) // wb
    return (b0 if upper else max(b0 - 1, 0), min(b1 + 2, nb))


def block_tridiag_matmul(X, B3, D: int = None, **kw):
    """``X @ M`` for block-tridiagonal ``M`` given as ``B3``: kernel B1 for
    CUDA tensors, its plain version for CPU tensors (see
    :func:`~..kernels.band_matmul.band_matmul` for the keywords)."""
    _check_dim(X, D)
    return band_matmul(X, B3, **kw)[0]


def block_tridiag_matmul_t(X, B3, D: int = None, **kw):
    """``X @ M.T`` for the same representation: kernel B2 for CUDA tensors,
    its plain version for CPU tensors."""
    _check_dim(X, D)
    return band_matmul_t(X, B3, **kw)[0]


def _check_dim(X, D):
    if D is not None and X.shape[-1] != D:
        raise ValueError(f"X has {X.shape[-1]} columns, not D = {D}")
