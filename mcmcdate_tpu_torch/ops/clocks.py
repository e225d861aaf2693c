"""Relaxed molecular clock priors on the rate tree over a chain batch.

Port of ``mcmcdate_tpu/ops/clocks.py``.  Rates and time lengths are
``[C, N]``, the variance ``[C]``; the root (stem) entry is masked.
"""

from __future__ import annotations

import math

import torch

from .dists import gamma_mean_variance_logpdf, log_normal_mean_param_logpdf

UNCORRELATED_GAMMA = "UncorrelatedGamma"
UNCORRELATED_LOG_NORMAL = "UncorrelatedLogNormal"
UNCORRELATED_WHITE_NOISE = "UncorrelatedWhiteNoise"
AUTOCORRELATED_GAMMA = "AutocorrelatedGamma"
AUTOCORRELATED_LOG_NORMAL = "AutocorrelatedLogNormal"

# Order fixes the model ids the prior-terms kernel switches on.
MODELS = (
    UNCORRELATED_GAMMA,
    UNCORRELATED_LOG_NORMAL,
    UNCORRELATED_WHITE_NOISE,
    AUTOCORRELATED_GAMMA,
    AUTOCORRELATED_LOG_NORMAL,
)


def relaxed_clock_terms(model: str, rates, time_lengths, non_root, mean, variance):
    """Per-branch log contributions plus a validity term: ``[C, N + 1]``."""
    v = variance[:, None]
    if model == UNCORRELATED_GAMMA:
        lp = gamma_mean_variance_logpdf(mean, v, rates)
        tmask = torch.ones_like(rates, dtype=torch.bool)
    elif model == UNCORRELATED_LOG_NORMAL:
        lp = log_normal_mean_param_logpdf(mean, v, rates)
        tmask = torch.ones_like(rates, dtype=torch.bool)
    elif model in (UNCORRELATED_WHITE_NOISE, AUTOCORRELATED_GAMMA,
                   AUTOCORRELATED_LOG_NORMAL):
        t = torch.where(time_lengths > 0, time_lengths, 1.0)
        if model == UNCORRELATED_WHITE_NOISE:
            lp = gamma_mean_variance_logpdf(mean, v / t, rates)
        elif model == AUTOCORRELATED_GAMMA:
            lp = gamma_mean_variance_logpdf(mean, v * t, rates)
        else:
            lp = log_normal_mean_param_logpdf(mean, v * t, rates)
        tmask = time_lengths > 0
    else:
        raise ValueError(f"Unknown relaxed clock model: {model!r}")
    lp = torch.where(tmask, lp, -math.inf)
    per_branch = torch.where(non_root, lp, 0.0)
    vterm = torch.where(v > 0, 0.0, -math.inf).to(rates.dtype)
    return torch.cat([per_branch, vterm], dim=1)


def relaxed_clock_log(model: str, rates, time_lengths, non_root, mean, variance):
    """Total clock log density per chain, ``[C]``."""
    terms = relaxed_clock_terms(model, rates, time_lengths, non_root, mean, variance)
    total = torch.sum(terms[:, :-1], dim=-1)
    return torch.where(variance > 0, total, -math.inf)
