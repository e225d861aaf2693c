"""Convergence diagnostics: split R-hat and effective sample size.

The reference relies on external R scripts for R-hat and bulk/tail ESS
(bench/comparison_with_mcmctree/README.md:265-269); here they are built in
and vectorized over parameters, following Vehtari et al. (2021): rank
normalization, split chains, Geyer initial monotone sequence ESS.
"""

from __future__ import annotations

import numpy as np


def _split_chains(x: np.ndarray) -> np.ndarray:
    """[draws, chains] -> [draws//2, 2*chains]."""
    n = x.shape[0] // 2
    return np.concatenate([x[:n], x[n : 2 * n]], axis=1)


def rank_normalize(x: np.ndarray) -> np.ndarray:
    """Rank-normalize draws (all chains pooled) to standard normal scores."""
    from math import sqrt

    shape = x.shape
    flat = x.reshape(-1)
    ranks = np.argsort(np.argsort(flat)) + 1
    u = (ranks - 0.375) / (flat.size + 0.25)
    # inverse normal CDF via erfinv-free approximation (Acklam) would be
    # overkill; use numpy's special path through scipy-free formula:
    z = _ndtri(u)
    return z.reshape(shape)


def _ndtri(p):
    """Inverse standard normal CDF (Peter Acklam's rational approximation)."""
    p = np.asarray(p, dtype=np.float64)
    a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
    b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00]
    plow, phigh = 0.02425, 1 - 0.02425
    out = np.empty_like(p)
    lo = p < plow
    hi = p > phigh
    mid = ~(lo | hi)
    q = np.sqrt(-2 * np.log(np.where(lo, p, 0.5)))
    out[lo] = (
        ((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]
    )[lo] / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)[lo]
    q = p - 0.5
    r = q * q
    out[mid] = (
        (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q
    )[mid] / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)[mid]
    q = np.sqrt(-2 * np.log1p(-np.where(hi, p, 0.5)))
    out[hi] = -(
        ((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]
    )[hi] / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)[hi]
    return out


def rhat(x: np.ndarray) -> float:
    """Split rank-normalized R-hat for draws ``[draws, chains]``."""
    z = rank_normalize(x)
    z = _split_chains(z)
    n, m = z.shape
    chain_means = z.mean(axis=0)
    b = n * chain_means.var(ddof=1)
    w = z.var(axis=0, ddof=1).mean()
    var_plus = (n - 1) / n * w + b / n
    return float(np.sqrt(var_plus / w))


def _autocovariance(x: np.ndarray) -> np.ndarray:
    n = len(x)
    x = x - x.mean()
    f = np.fft.rfft(x, 2 * n)
    acov = np.fft.irfft(f * np.conj(f))[:n].real / n
    return acov


def ess(x: np.ndarray) -> float:
    """Bulk ESS for draws ``[draws, chains]`` (Geyer initial monotone)."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    x = _split_chains(x)
    n, m = x.shape
    acovs = np.stack([_autocovariance(x[:, j]) for j in range(m)], axis=1)
    chain_var = acovs[0] * n / (n - 1)
    mean_var = chain_var.mean()
    var_plus = mean_var * (n - 1) / n + x.mean(axis=0).var(ddof=1) if m > 1 else mean_var
    rho = 1.0 - (mean_var - acovs.mean(axis=1)) / var_plus
    # Geyer pairs.
    pair = rho[: 2 * (n // 2)].reshape(-1, 2).sum(axis=1)
    # Initial positive + monotone decreasing sequence.
    pos = pair > 0
    k = np.argmax(~pos) if not pos.all() else len(pair)
    pair = pair[:k]
    pair = np.minimum.accumulate(pair) if len(pair) else pair
    tau = -1.0 + 2.0 * pair.sum()
    tau = max(tau, 1.0 / np.log10(n * m + 10))
    return float(n * m / tau)


def ess_tail(x: np.ndarray) -> float:
    """Tail ESS (Vehtari et al. 2021, sec. 4.3): the minimum of the
    effective sample sizes of the 5% and 95% quantile indicator draws,
    measuring sampling efficiency in the distribution tails (the
    reference's validation workflow reports bulk AND tail ESS,
    bench/comparison_with_mcmctree/README.md:265-269)."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    out = []
    for q in (0.05, 0.95):
        ind = (x <= np.quantile(x, q)).astype(np.float64)
        if ind.std() == 0.0:
            out.append(float(x.size))
        else:
            out.append(ess(ind))
    return float(min(out))


def summarize(samples: dict, log=print) -> dict:
    """Per-parameter mean/sd/ESS/R-hat table for ``{name: [draws, chains]}``."""
    out = {}
    for name, x in samples.items():
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[:, None]
        finite = np.all(np.isfinite(x))
        constant = finite and np.all(x == x.ravel()[0])
        out[name] = dict(
            mean=float(x.mean()) if finite else float(x[np.isfinite(x)].mean())
            if np.any(np.isfinite(x)) else float("nan"),
            sd=float(x.std()) if finite else float("nan"),
            ess=float(x.size) if constant else (ess(x) if finite else float("nan")),
            ess_tail=float(x.size) if constant
            else (ess_tail(x) if finite else float("nan")),
            rhat=float("nan") if (constant or not finite or x.shape[1] < 2)
            else rhat(x),
        )
        s = out[name]
        log(
            f"{name:>24s}  mean {s['mean']:+.5g}  sd {s['sd']:.5g}  "
            f"ESS {s['ess']:.0f}  tail-ESS {s['ess_tail']:.0f}  "
            f"R-hat {s['rhat']:.4f}"
        )
    return out
