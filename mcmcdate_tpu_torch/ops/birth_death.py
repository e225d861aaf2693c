"""Birth-death prior on ultrametric time trees over a chain batch.

Port of ``mcmcdate_tpu/ops/birth_death.py``: the closed-form extinction
probability makes every branch factor an independent per-node expression
(see the JAX module for the derivation of the scaled form).

Unlike the JAX module, the terms are evaluated in float64 whatever the
state's dtype and rounded once at the end.  Just above the near-critical
threshold (|la - mu| a few float32 ulps of la, e.g. 1.9e-6 at la = 30) the
standard formula's denominator ``la (c - 1) + (mu - c la) z`` cancels to
about ``-(la - mu)``, far below float32's rounding of its operands: in
float32 each inner node's term is then off by about +2.  In float64 the
same inputs lose nothing that matters.
"""

from __future__ import annotations

import math

import torch

from .dists import maybe_any

EPS_NEAR_CRITICAL = 1e-6


def _de_factors(la, mu, c, dt):
    """log D and E at the top of a branch of length ``dt`` whose bottom
    state is summarized by ``c``; all arguments broadcast."""
    d = la - mu
    abs_d = torch.abs(d)
    near = abs_d < EPS_NEAR_CRITICAL

    c1 = c - 1.0
    t_pos = abs_d * dt
    z = torch.exp(-t_pos)
    pos = d > 0
    la_c1 = la * c1
    mu_cla = mu - c * la
    mu_c1 = mu * c1
    p = torch.where(pos, la_c1, la_c1 * z)
    q = torch.where(pos, mu_cla * z, mu_cla)
    r = torch.where(pos, mu_c1, mu_c1 * z)
    denom = p + q
    nonzero = denom != 0
    denom_safe = torch.where(nonzero, denom, 1.0)
    d_safe = torch.where(d == 0, 1.0, d)
    log_d = torch.where(
        nonzero,
        2.0 * torch.log(torch.abs(d_safe)) - t_pos - 2.0 * torch.log(torch.abs(denom_safe)),
        -math.inf,
    )
    e = (r + q) / denom_safe
    if not maybe_any(near):
        return log_d, e

    # Near-critical series (computeDENearCritical).
    y_nc = mu_cla * dt
    nom_d_nc = 1.0 - d * dt
    denom_nc = 1.0 + y_nc
    denom_nc_safe = torch.where(denom_nc == 0, 1.0, denom_nc)
    log_d_nc = torch.where(
        (nom_d_nc > 0) & (denom_nc != 0),
        torch.log(torch.where(nom_d_nc > 0, nom_d_nc, 1.0))
        - 2.0 * torch.log(torch.abs(denom_nc_safe)),
        -math.inf,
    )
    e_nc = (c + y_nc) / denom_nc_safe
    return torch.where(near, log_d_nc, log_d), torch.where(near, e_nc, e)


def extinction_at(la, mu, rho, h):
    """Closed-form E(h) given sampling probability ``rho`` at height 0."""
    _, e = _de_factors(la, mu, 1.0 - rho, h)
    return e


def birth_death_terms(heights, parent, is_leaf, la, mu, rho):
    """Per-node log contributions plus a validity term: ``[C, N + 1]`` in
    the dtype of ``heights``, evaluated in float64.

    ``heights`` is ``[C, N]``, ``la`` and ``mu`` are ``[C]``, ``rho`` a
    float; ``parent`` and ``is_leaf`` are ``[N]`` tensors."""
    dtype = heights.dtype
    f64 = torch.float64
    heights = heights.to(f64)
    la = la.to(f64)[:, None]
    mu = mu.to(f64)[:, None]
    rho_t = torch.as_tensor(rho, dtype=f64, device=heights.device)
    hp = heights[:, parent]
    dt = hp - heights
    e_at = extinction_at(la, mu, rho_t, heights)
    c = torch.where(is_leaf, 1.0 - rho_t, e_at)
    log_d, _ = _de_factors(la, mu, c, dt)
    log_d = torch.where(dt > 0, log_d, -math.inf)
    log_boundary = torch.where(is_leaf, torch.log(rho_t), torch.log(la))
    non_root = parent >= 0
    per_node = torch.where(non_root, log_d + log_boundary, 0.0).to(dtype)
    # A +inf term is a numerical artifact; map it to a rejection.
    per_node = torch.where(per_node == math.inf, -math.inf, per_node)
    valid = (la >= 0) & (mu >= 0) & (rho_t > 0) & (rho_t <= 1)
    vterm = torch.where(valid, 0.0, -math.inf).to(dtype)
    return torch.cat([per_node, vterm], dim=1)


def birth_death_log(heights, parent, is_leaf, la, mu, rho):
    """Log birth-death prior per chain, ``[C]``; NaN totals are -inf."""
    total = torch.sum(birth_death_terms(heights, parent, is_leaf, la, mu, rho), dim=-1)
    return torch.where(torch.isnan(total), -math.inf, total)
