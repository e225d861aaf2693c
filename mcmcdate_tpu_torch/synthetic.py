"""Synthetic model and chain batch, built as ``bench.py`` builds its model
(which imports JAX): a random ultrametric tree, Gamma(5, 0.2) branch rates
per chain and a full-MVN likelihood with a well-conditioned random
precision Cholesky factor, or a banded one estimated from correlated
samples.  It exercises the compute path, not the statistics."""

from __future__ import annotations

import numpy as np
import torch

from .models.dating import DatingModel
from .models.state import init_state
from .ops import banded, mvn
from .tree.flat import FlatTopology
from .utils.simulate import random_ultrametric_tree

# The banded kind's samples: SAMPLES_PER_W per unit of bandwidth (each
# window regression has bandwidth predictors), correlated along the
# internal layout as an AR(1) process of coefficient AR_RHO and standard
# deviation NOISE_SD (a well-conditioned precision: each entry's
# conditional variance is (1 - AR_RHO^2) NOISE_SD^2).
SAMPLES_PER_W = 4
AR_RHO = 0.6
NOISE_SD = 0.2


def _banded_likelihood(rng, topo, k: int, bandwidth: int) -> mvn.LikelihoodData:
    """A banded likelihood in the internal layout: the Cholesky banding
    estimator of ``prepare "banded W"`` over samples around a random mean
    whose neighbouring entries (a pre-order's tree-adjacent branches) are
    correlated."""
    n = SAMPLES_PER_W * max(bandwidth, 16)
    mu = rng.uniform(0.05, 0.5, size=k)
    e = rng.normal(size=(n, k))
    noise = np.empty((n, k))
    noise[:, 0] = e[:, 0]
    for i in range(1, k):
        noise[:, i] = AR_RHO * noise[:, i - 1] + np.sqrt(1.0 - AR_RHO ** 2) * e[:, i]
    _, band, log_det = banded.estimate_banded_chol(mu + NOISE_SD * noise, bandwidth)
    perm = topo.ref_to_internal_perm
    mu_ref = np.empty(k)
    mu_ref[perm] = mu
    return mvn.LikelihoodData.banded(mu_ref, band, log_det, perm)


def build(n_taxa: int, n_chains: int, dtype=torch.float32, device="cuda", seed: int = 0,
          kind: str = mvn.FULL, bandwidth: int = 128, **model_kw):
    """``(model, batch)``; ``kind`` is ``"full"`` or ``"banded"`` (of
    ``bandwidth``); ``model_kw`` go to :class:`DatingModel` (clock,
    calibrations, constraints, braces)."""
    rng = np.random.default_rng(seed)
    tree = random_ultrametric_tree(rng, n_taxa)
    topo = FlatTopology.from_tree(tree)
    k = topo.n - 2
    if kind == mvn.BANDED:
        data = _banded_likelihood(rng, topo, k, bandwidth)
    elif kind == mvn.FULL:
        chol = np.tril(rng.normal(size=(k, k)) / np.sqrt(k)) + np.eye(k) * 2.0
        data = mvn.LikelihoodData(
            kind=mvn.FULL,
            mu=rng.uniform(0.05, 0.5, size=k),
            precision=chol @ chol.T,
            chol_precision=chol,
            log_det_sigma=float(-2.0 * np.log(np.diag(chol)).sum()),
        )
    else:
        raise ValueError(f"synthetic.build: kind must be full or banded, not {kind!r}")
    model = DatingModel(topo=topo, likelihood=data, device=device, dtype=dtype, **model_kw)
    batch = init_state(tree, topo, n_chains, dtype=dtype, device=device)
    r = rng.gamma(5.0, 0.2, size=(n_chains, topo.n))
    r[:, 0] = 1.0
    return model, batch.replace(rates=torch.as_tensor(r, dtype=dtype, device=device))
