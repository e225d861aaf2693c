"""Synthetic full-MVN model and chain batch, built as ``bench.py`` builds
its model (which imports JAX): a random ultrametric tree, a
well-conditioned random precision Cholesky factor and Gamma(5, 0.2)
branch rates per chain.  It exercises the compute path, not the
statistics."""

from __future__ import annotations

import numpy as np
import torch

from .models.dating import DatingModel
from .models.state import init_state
from .ops import mvn
from .tree.flat import FlatTopology
from .utils.simulate import random_ultrametric_tree


def build(n_taxa: int, n_chains: int, dtype=torch.float32, device="cuda", seed: int = 0,
          **model_kw):
    """``(model, batch)``; ``model_kw`` go to :class:`DatingModel` (clock,
    calibrations, constraints, braces)."""
    rng = np.random.default_rng(seed)
    tree = random_ultrametric_tree(rng, n_taxa)
    topo = FlatTopology.from_tree(tree)
    k = topo.n - 2
    chol = np.tril(rng.normal(size=(k, k)) / np.sqrt(k)) + np.eye(k) * 2.0
    data = mvn.LikelihoodData(
        kind=mvn.FULL,
        mu=rng.uniform(0.05, 0.5, size=k),
        precision=chol @ chol.T,
        chol_precision=chol,
        log_det_sigma=float(-2.0 * np.log(np.diag(chol)).sum()),
    )
    model = DatingModel(topo=topo, likelihood=data, device=device, dtype=dtype, **model_kw)
    batch = init_state(tree, topo, n_chains, dtype=dtype, device=device)
    r = rng.gamma(5.0, 0.2, size=(n_chains, topo.n))
    r[:, 0] = 1.0
    return model, batch.replace(rates=torch.as_tensor(r, dtype=dtype, device=device))
