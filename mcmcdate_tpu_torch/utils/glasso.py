"""Graphical lasso (sparse precision estimation).

Port of ``mcmcdate_tpu/utils/glasso.py``.  Replaces the reference's Haskell
``glasso``/``covariance`` packages (app/Main.hs:257-277): standardize the
data, estimate a sparse precision matrix of the correlation matrix by
L1-penalized maximum likelihood, then rescale back to the covariance scale.

Two solvers of the same convex program: :func:`graphical_lasso`, the block
coordinate descent of Friedman, Hastie & Tibshirani (2008) with a cyclic
coordinate-descent lasso inner solver, on the host in NumPy (copied from
the JAX package verbatim, so its output is bitwise the same); and
:func:`graphical_lasso_admm`, the ADMM of Boyd et al. (2011, §6.5), whose
iterations run on the card: one ``torch.linalg.eigh``, one product and the
three kernels of ``kernels/glasso_admm.py`` (A1-A3) an iteration, with the
loop's test on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import device as devices

ALPHA = 1.5  # over-relaxation (Boyd §3.4.3)


def _lasso_cd(W11: np.ndarray, s12: np.ndarray, rho: float, beta0: np.ndarray,
              tol: float = 1e-6, max_iter: int = 500) -> np.ndarray:
    """Minimize (1/2) b' W11 b - s12' b + rho ||b||_1 by coordinate descent."""
    p = len(s12)
    beta = beta0.copy()
    d = np.diag(W11).copy()
    d[d <= 0] = 1e-12
    for _ in range(max_iter):
        max_delta = 0.0
        for j in range(p):
            # Partial residual.
            r = s12[j] - W11[j] @ beta + W11[j, j] * beta[j]
            new = np.sign(r) * max(abs(r) - rho, 0.0) / d[j]
            delta = abs(new - beta[j])
            if delta > max_delta:
                max_delta = delta
            beta[j] = new
        if max_delta < tol:
            break
    return beta


def graphical_lasso(S: np.ndarray, rho: float, tol: float = 1e-5,
                    max_iter: int = 100) -> Tuple[np.ndarray, np.ndarray]:
    """Estimate (covariance, precision) with an L1 penalty ``rho`` on the
    off-diagonal precision entries.

    Returns ``(W, Theta)`` where ``W ~ S + rho I`` on the diagonal and
    ``Theta`` is sparse.
    """
    S = np.asarray(S, dtype=np.float64)
    p = S.shape[0]
    W = S.copy()
    np.fill_diagonal(W, np.diag(S) + rho)
    B = np.zeros((p, p))  # beta vectors per column
    idx = np.arange(p)
    for it in range(max_iter):
        W_old = W.copy()
        for j in range(p):
            mask = idx != j
            W11 = W[np.ix_(mask, mask)]
            s12 = S[mask, j]
            beta = _lasso_cd(W11, s12, rho, B[mask, j])
            B[mask, j] = beta
            w12 = W11 @ beta
            W[mask, j] = w12
            W[j, mask] = w12
        if np.mean(np.abs(W - W_old)) < tol * np.mean(np.abs(np.diag(S))):
            break
    # Recover the precision matrix from W and the betas.
    Theta = np.zeros((p, p))
    for j in range(p):
        mask = idx != j
        denom = W[j, j] - W[mask, j] @ B[mask, j]
        theta_jj = 1.0 / denom
        Theta[j, j] = theta_jj
        Theta[mask, j] = -B[mask, j] * theta_jj
    # Symmetrize (coordinate descent leaves tiny asymmetries).
    Theta = 0.5 * (Theta + Theta.T)
    return W, Theta


@dataclass
class AdmmRun:
    """Where an ADMM loop stopped: the iterate ``Z`` (sparse, exact zeros),
    the scaled dual ``U`` before its last division by ``fac``, the penalty
    ``t`` (already multiplied by ``fac``), the residuals and the number of
    iterations.  ``(Z, U, t, fac)`` is the input of a next iteration."""

    Z: torch.Tensor
    U: torch.Tensor
    t: float
    fac: float
    r: float
    s: float
    iterations: int


def admm_solve(S: torch.Tensor, rho: float, *, tol: float = 1e-6, max_iter: int = 1000,
               t: float = 1.0, ops=None) -> AdmmRun:
    """The ADMM loop of ``mcmcdate_tpu/utils/glasso.py:107-143`` on ``S`` (a
    ``[p, p]`` tensor on its device).  ``ops``: the three passes
    ``(shift, eig_scale, update)``, the wrappers of
    ``kernels/glasso_admm.py`` by default (``glasso_admm.PLAIN`` runs the
    plain versions, also on the card).  The host reads ``[r^2, s^2]`` once
    an iteration for the loop's test and forms ``fac`` and ``t`` in double,
    as the JAX body does."""
    from ..kernels import glasso_admm as K

    shift, eig_scale, update = K.KERNELS if ops is None else ops
    p = S.shape[0]
    Z = torch.eye(p, dtype=S.dtype, device=S.device)
    U = torch.zeros((p, p), dtype=S.dtype, device=S.device)
    t = float(t)
    eps = tol * p
    r = s = math.inf
    fac = 1.0
    it = 0
    while it < max_iter and (r > eps or s > eps):
        A = shift(Z, U, S, t, fac)
        lam, Q = torch.linalg.eigh(A)
        T = eig_scale(lam, Q, t) @ Q.mT
        r2, s2 = update(T.contiguous(), Z, U, ALPHA, rho / t).tolist()
        r = math.sqrt(r2)  # primal residual
        s = t * math.sqrt(s2)  # dual residual
        # Residual balancing (Boyd §3.4.1): keep r and s within 10x by
        # rescaling the penalty (and the scaled dual with it, in the next
        # iteration's shift).
        fac = 2.0 if r > 10.0 * s else (0.5 if s > 10.0 * r else 1.0)
        t = t * fac
        it += 1
    return AdmmRun(Z, U, t, fac, r, s, it)


def graphical_lasso_admm(S: np.ndarray, rho: float, *, tol: float = 1e-6,
                         max_iter: int = 1000, t: float = 1.0, dtype=torch.float64,
                         device="cuda", stats: Optional[dict] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Graphical lasso by ADMM with its iterations on ``device`` (the card
    unless the caller asks for the CPU; no CPU fallback).

    Solves the SAME convex program as :func:`graphical_lasso` (``min -logdet
    T + tr(S T) + rho ||T||_1``, penalty on every entry, ``W = S + rho I`` on
    the diagonal); the minimizer is unique, so the two agree to solver
    tolerance.  Returns ``(W, Theta)``: ``Theta`` the symmetrised sparse
    iterate (exact zeros from the soft threshold), ``W`` its inverse, both
    formed on the host as in the JAX package.  ``stats``, where given,
    receives ``iterations``.  The kernels take float64."""
    device = devices.resolve(device)
    S = np.asarray(S, dtype=np.float64)
    run = admm_solve(torch.as_tensor(S, dtype=dtype, device=device), rho, tol=tol,
                     max_iter=max_iter, t=t)
    if stats is not None:
        stats["iterations"] = run.iterations
    Theta = run.Z.double().cpu().numpy()
    Theta = 0.5 * (Theta + Theta.T)
    W = np.linalg.inv(Theta)
    return W, Theta


def scale_data(X: np.ndarray):
    """Standardize columns: return (means, sds, normalized X)
    (``S.scale`` of the covariance package, app/Main.hs:261)."""
    mu = X.mean(axis=0)
    sd = X.std(axis=0, ddof=1)
    return mu, sd, (X - mu) / sd


def rescale_cov(sd: np.ndarray, sigma_norm: np.ndarray) -> np.ndarray:
    """Covariance of standardized data -> covariance of raw data."""
    return sigma_norm * np.outer(sd, sd)


def rescale_precision(sd: np.ndarray, prec_norm: np.ndarray) -> np.ndarray:
    """Precision of standardized data -> precision of raw data."""
    return prec_norm / np.outer(sd, sd)
