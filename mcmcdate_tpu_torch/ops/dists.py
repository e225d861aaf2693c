"""Log-density primitives and proposal samplers on torch tensors.

Port of ``mcmcdate_tpu/ops/dists.py``.  Every function broadcasts over a
leading chain axis.  The samplers take their random draws as arguments (a
uniform for the truncated normal, a standard-gamma variate for the gamma
scale kernel), so tests can feed both packages the same numbers; callers
draw them from a ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

LN_SQRT_2PI = 0.9189385332046727  # log(sqrt(2*pi))


def _t(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _finite(x):
    """``isfinite`` for floats in two elementwise passes (NaN and +-inf
    compare false)."""
    return torch.abs(x) < math.inf


def exponential_logpdf(rate, x):
    """Exponential distribution with given rate (mean ``1/rate``)."""
    return torch.where(x >= 0, torch.log(_t(rate, x)) - rate * x, -math.inf)


def _log1pmx(u):
    """``log(1+u) - u``, accurate near ``u = 0``."""
    small = torch.abs(u) < 0.35
    us = torch.where(small, u, 0.0)
    ser = -(us * us) * (
        1.0 / 2.0
        - us * (1.0 / 3.0 - us * (1.0 / 4.0 - us * (1.0 / 5.0 - us * (
            1.0 / 6.0 - us * (1.0 / 7.0 - us / 8.0)))))
    )
    ub = torch.where(small, 0.5, u)  # dead-branch guard for log
    return torch.where(small, ser, torch.log1p(ub) - ub)


def maybe_any(mask) -> bool:
    """False only when ``mask`` is all false and on the CPU: a dead branch
    may then be skipped without changing any value.  On a card the check
    would cost a host sync, so the branch is always evaluated there."""
    return mask.device.type != "cpu" or bool(mask.any())


def gamma_logpdf(shape, scale, x):
    """Gamma distribution with given shape and SCALE (mean = shape*scale),
    with the Stirling-cancelled form for shape > 100 (see the JAX
    package's docstring for the derivation)."""
    shape = _t(shape, x)
    scale = _t(scale, x)
    ok = (x > 0) & _finite(x) & _finite(shape) & (shape > 0)
    xs = torch.where(ok, x, 1.0)
    ks = torch.where(ok, shape, 1.0)
    lp = (ks - 1.0) * torch.log(xs) - xs / scale - ks * torch.log(scale) - torch.lgamma(ks)
    big = ks > 1e2
    if maybe_any(big):
        kb = torch.where(big, ks, 1e2)
        m = kb * scale
        d = xs / m
        stable = (
            0.5 * torch.log(kb)
            - LN_SQRT_2PI
            - torch.log(m)
            - torch.log(d)
            + kb * _log1pmx(d - 1.0)
            - 1.0 / (12.0 * kb)
        )
        lp = torch.where(big, stable, lp)
    return torch.where(ok, lp, -math.inf)


def gamma_mean_variance_logpdf(mean, variance, x):
    """Gamma parameterized by mean and variance (shape=m^2/v, scale=v/m)."""
    shape = mean * mean / variance
    scale = variance / mean
    return gamma_logpdf(shape, scale, x)


def normal_logpdf(mean, sd, x):
    z = (x - mean) / sd
    return -LN_SQRT_2PI - torch.log(_t(sd, x)) - 0.5 * z * z


def log_normal_mean_param_logpdf(mean, variance, x):
    """Log-normal parameterized by its actual mean and the variance of the
    underlying normal."""
    ok = (x > 0) & _finite(x)
    xs = torch.where(ok, x, 1.0)
    t = -(LN_SQRT_2PI + torch.log(xs * torch.sqrt(_t(variance, x))))
    b = torch.log(xs / mean) + 0.5 * variance
    e = -b * b / (2.0 * variance)
    return torch.where(ok, t + e, -math.inf)


def _truncnorm_log_z(mean, sd, a, b):
    """log(Phi(beta) - Phi(alpha)), computed stably in the tails."""
    alpha = (a - mean) / sd
    beta = (b - mean) / sd
    flip = alpha + beta > 0
    lo = torch.where(flip, -beta, alpha)
    hi = torch.where(flip, -alpha, beta)
    llo = torch.special.log_ndtr(lo)
    lhi = torch.special.log_ndtr(hi)
    diff = torch.clamp(llo - lhi, max=0.0)
    tiny = torch.finfo(diff.dtype).tiny
    return lhi + torch.log1p(-torch.exp(diff) + tiny)


def truncated_normal_logpdf(mean, sd, a, b, x):
    inside = (x >= a) & (x <= b)
    lp = normal_logpdf(mean, sd, x) - _truncnorm_log_z(mean, sd, a, b)
    return torch.where(inside, lp, -math.inf)


def truncated_normal_sample(u, mean, sd, tune, a, b):
    """Draw from TruncNormal(mean, tune*sd, a, b) by inverting the CDF at
    the uniform ``u`` and return ``(value, log_mhg)``, where ``log_mhg`` is
    ``log q(y->x) - log q(x->y)``.  ``mean``, ``a`` and ``b`` broadcast
    against ``u`` (bounds may be infinite); the value is clamped strictly
    inside the interval, as in the JAX package."""
    x = truncated_normal_draw(u, mean, sd, tune, a, b)
    return x, truncated_normal_lq(mean, sd, tune, a, b, x)


def truncated_normal_draw(u, mean, sd, tune, a, b):
    """The value alone of :func:`truncated_normal_sample`."""
    mean, a, b, tune = (torch.broadcast_to(_t(v, u), u.shape) for v in (mean, a, b, tune))
    s = tune * sd
    alpha = (a - mean) / s
    beta = (b - mean) / s
    pa = torch.special.ndtr(alpha)
    pb = torch.special.ndtr(beta)
    p = pa + u * (pb - pa)
    fi = torch.finfo(u.dtype)
    x = mean + s * torch.special.ndtri(torch.clamp(p, fi.tiny, 1.0 - 10 * fi.eps))
    eps = 32 * fi.eps
    width = torch.where(_finite(b - a), b - a, s)
    lo = torch.where(_finite(a), a + eps * width, -math.inf)
    hi = torch.where(_finite(b), b - eps * width, math.inf)
    return torch.minimum(torch.maximum(x, lo), hi)


def truncated_normal_lq(mean, sd, tune, a, b, x):
    """The ``log_mhg`` of :func:`truncated_normal_sample` for the value
    ``x``: ``log q(x->mean) - log q(mean->x)``."""
    mean, a, b, tune = (torch.broadcast_to(_t(v, x), x.shape) for v in (mean, a, b, tune))
    # Forward and reverse kernel densities in one pass: row 0 is
    # log q(mean -> x), row 1 log q(x -> mean).
    lq = truncated_normal_logpdf(torch.stack([mean, x]), tune * sd, a, b, torch.stack([x, mean]))
    return lq[1] - lq[0]


def bold_tune(tune, u_bold=None, bold_p=0.0, bold_factor=8.0):
    """The bold contrary mixture's tuning (the JAX ``_mega_range_contra`` and
    ``_glob_step``'s sub_contra, ``engine/fast_sweep.py:1599-1615,
    1123-1134``): ``bold_factor * tune`` where ``u_bold < bold_p``, else
    ``tune``; ``u_bold`` None: ``tune``.  A state-independent mixture, so
    the truncated normal's forward and reverse densities take the same
    tuning."""
    if u_bold is None:
        return tune
    return tune * torch.where(u_bold < bold_p,
                              torch.as_tensor(bold_factor, dtype=tune.dtype, device=tune.device),
                              1.0)


def gamma_scale_sample(g, shape, tune):
    """Multiplicative factor ``u = g * tune/shape`` where ``g`` is a
    standard-gamma draw of shape ``shape/tune`` (so ``u`` has mean 1), and
    the base log MHG factor ``log g(1/u) - log g(u) - 2 log u``.

    Returns ``(u, log_mhg_base, log_u)``; a proposal that scales ``n_up``
    coordinates by ``u`` and ``n_down`` by ``1/u`` adds
    ``(n_up - n_down) * log u``."""
    u = g * (tune / _t(shape, g))
    return (u, *gamma_scale_lq(u, shape, tune))


def gamma_scale_lq(u, shape, tune):
    """``(log_mhg_base, log_u)`` of :func:`gamma_scale_sample` for the
    factor ``u``."""
    shape = _t(shape, u)
    k = shape / tune
    theta = tune / shape
    log_u = torch.log(u)
    # Forward and reverse densities in one pass: rows g(u) and g(1/u).
    log_g = gamma_logpdf(k, theta, torch.stack([u, 1.0 / u]))
    return log_g[1] - log_g[0] - 2.0 * log_u, log_u


def standard_gamma(shape, generator):
    """Standard-gamma draws of the given per-chain shapes from ``generator``
    (on the shapes' device)."""
    return torch._standard_gamma(shape, generator=generator)
