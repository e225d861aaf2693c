"""Multivariate-normal approximations of the phylogenetic likelihood.

Port of ``mcmcdate_tpu/ops/mvn.py``.  :class:`LikelihoodData` is the
same host description as the JAX package's (copied, because that module
imports JAX).  A ``sparse`` precision (the graphical lasso's, ``prepare``)
is stored dense and evaluated as ``full``, as in the JAX package.  A
``banded`` precision is stored as the upper band of its Cholesky factor in
the internal pre-order layout and evaluated by kernel B1
(``ops/banded.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels.band_matmul import band_matmul
from ..kernels.whiten import whiten
from ..utils import device as devices
from .dists import LN_SQRT_2PI

FULL = "full"
SPARSE = "sparse"
BANDED = "banded"
UNIVARIATE = "univariate"
NONE = "none"


@dataclass(frozen=True)
class LikelihoodData:
    """Static (host) likelihood data produced by ``prepare``: for the MVN
    kinds ``precision`` is the inverted covariance, ``chol_precision`` its
    lower Cholesky factor and ``log_det_sigma`` the covariance's log
    determinant; for ``univariate`` ``variances`` holds the per-branch
    variances.  ``precision_assoc`` keeps a sparse precision's association
    list for ``.data`` round trips.  For ``banded``, ``band_chol`` is the
    upper band of ``L`` with ``P_internal = L L'`` (``band_chol[i, t] =
    L[i, i+t]``, ``t = 0..bandwidth``) in the internal pre-order layout,
    and ``band_perm`` maps the reference branch order into it
    (``d_internal = d_ref[band_perm]``)."""

    kind: str
    mu: Optional[np.ndarray] = None
    precision: Optional[np.ndarray] = None
    chol_precision: Optional[np.ndarray] = None
    log_det_sigma: Optional[float] = None
    variances: Optional[np.ndarray] = None
    precision_assoc: Optional[tuple] = None
    band_chol: Optional[np.ndarray] = None
    bandwidth: Optional[int] = None
    band_perm: Optional[np.ndarray] = None

    @staticmethod
    def none() -> "LikelihoodData":
        return LikelihoodData(kind=NONE)

    @staticmethod
    def full(mu, precision, log_det_sigma) -> "LikelihoodData":
        precision = np.asarray(precision, dtype=np.float64)
        return LikelihoodData(
            kind=FULL,
            mu=np.asarray(mu, dtype=np.float64),
            precision=precision,
            chol_precision=np.linalg.cholesky(precision),
            log_det_sigma=float(log_det_sigma),
        )

    @staticmethod
    def sparse(mu, precision, log_det_sigma, assoc=None) -> "LikelihoodData":
        precision = np.asarray(precision, dtype=np.float64)
        return LikelihoodData(
            kind=SPARSE,
            mu=np.asarray(mu, dtype=np.float64),
            precision=precision,
            chol_precision=np.linalg.cholesky(precision),
            log_det_sigma=float(log_det_sigma),
            precision_assoc=tuple(assoc) if assoc is not None else None,
        )

    @staticmethod
    def banded(mu, band_chol, log_det_sigma, perm) -> "LikelihoodData":
        """The banded precision of ``prepare "banded W"``: ``mu`` in the
        reference branch order, ``band_chol`` and the band's layout in the
        internal order given by ``perm``."""
        band_chol = np.asarray(band_chol, dtype=np.float64)
        return LikelihoodData(
            kind=BANDED,
            mu=np.asarray(mu, dtype=np.float64),
            log_det_sigma=float(log_det_sigma),
            band_chol=band_chol,
            bandwidth=int(band_chol.shape[1] - 1),
            band_perm=np.asarray(perm, dtype=np.int64),
        )

    @staticmethod
    def univariate(mu, variances) -> "LikelihoodData":
        return LikelihoodData(
            kind=UNIVARIATE,
            mu=np.asarray(mu, dtype=np.float64),
            variances=np.asarray(variances, dtype=np.float64),
        )

    @property
    def dim(self) -> int:
        return 0 if self.mu is None else len(self.mu)


def mvn_log_density(dx, chol_precision, log_det_sigma):
    """log N(dx; 0, Sigma) per chain via the precision Cholesky factor: the
    quadratic form ``||dx @ L||^2`` is the whiten kernel's epilogue."""
    k = dx.shape[-1]
    _, quad = whiten(dx, chol_precision)
    return -LN_SQRT_2PI * k - 0.5 * (log_det_sigma + quad)


def univariate_log_density(dx, variances, log_var_sum):
    k = dx.shape[-1]
    quad = torch.sum(dx * dx / variances, dim=-1)
    return -LN_SQRT_2PI * k - 0.5 * (log_var_sum + quad)


def make_log_likelihood(data: LikelihoodData, dtype=None, device="cuda"):
    """``log_lik(distances [C, D]) -> [C]`` closed over the static data, on
    the card unless ``device`` says otherwise; ``dtype=None``: float32 on a
    CUDA device, float64 on the CPU."""
    device = devices.resolve(device)
    dtype = devices.float_dtype(device, dtype)
    if data.kind == NONE:
        def f_none(d):
            return d.new_zeros(d.shape[:-1])

        return f_none
    if data.kind == BANDED:
        from . import banded

        wb = banded.default_block_size(int(data.bandwidth))
        L3 = torch.as_tensor(banded.blocks_from_upper_band(data.band_chol, wb), dtype=dtype,
                             device=device)
        perm = torch.as_tensor(data.band_perm, device=device)
        mu_int = torch.as_tensor(data.mu[data.band_perm], dtype=dtype, device=device)
        log_det = float(data.log_det_sigma)
        D = int(data.band_chol.shape[0])

        def f_banded(d):
            # (d - mu) L with mu subtracted in the kernel, sum y^2 its epilogue.
            _, quad = band_matmul(d[:, perm].contiguous(), L3, sub=mu_int, upper=True)
            return -LN_SQRT_2PI * D - 0.5 * (log_det + quad)

        return f_banded
    mu = torch.as_tensor(data.mu, dtype=dtype, device=device)
    if data.kind in (FULL, SPARSE):
        chol = torch.as_tensor(data.chol_precision, dtype=dtype, device=device)
        log_det = float(data.log_det_sigma)

        def f_mvn(d):
            return mvn_log_density(d - mu, chol, log_det)

        return f_mvn
    if data.kind == UNIVARIATE:
        var = torch.as_tensor(data.variances, dtype=dtype, device=device)
        log_var_sum = float(np.sum(np.log(data.variances)))

        def f_uni(d):
            return univariate_log_density(d - mu, var, log_var_sum)

        return f_uni
    raise ValueError(f"Unknown likelihood kind {data.kind!r}")
