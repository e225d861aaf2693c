"""Soft node priors: calibrations, order constraints and braces.

Port of ``mcmcdate_tpu/ops/node_priors.py``.  The ``*Set`` dataclasses are
host NumPy descriptions, copied here because the JAX module imports JAX;
their fields and defaults are the same.  The densities take ``[C, N]``
relative heights and the ``[C]`` absolute height multiplier.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

SQRT_2_OVER_PI = 0.7978845608028654


@dataclass(frozen=True)
class CalibrationSet:
    """Node-age calibrations; ``lower`` is 0 and ``upper`` +inf where a
    bound is absent.  Bounds are absolute times."""

    node: np.ndarray  # int32[K]
    lower: np.ndarray  # f64[K]
    lower_pm: np.ndarray  # f64[K]
    upper: np.ndarray  # f64[K]
    upper_pm: np.ndarray  # f64[K]
    names: Tuple[str, ...] = ()
    paths: Tuple[Tuple[int, ...], ...] = ()

    @property
    def n(self) -> int:
        return len(self.node)

    @staticmethod
    def empty() -> "CalibrationSet":
        z = np.zeros(0)
        return CalibrationSet(np.zeros(0, np.int32), z, z, z, z)


@dataclass(frozen=True)
class ConstraintSet:
    """Node order constraints (young < old)."""

    young: np.ndarray  # int32[K]
    old: np.ndarray  # int32[K]
    pm: np.ndarray  # f64[K]
    names: Tuple[str, ...] = ()

    @property
    def n(self) -> int:
        return len(self.young)

    @staticmethod
    def empty() -> "ConstraintSet":
        return ConstraintSet(np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0))


@dataclass(frozen=True)
class BraceSet:
    """Braces (node sets with tied heights); ``node`` is padded with -1."""

    node: np.ndarray  # int32[B, max_nodes]
    sd: np.ndarray  # f64[B]
    names: Tuple[str, ...] = ()

    @property
    def n(self) -> int:
        return len(self.sd)

    @staticmethod
    def empty() -> "BraceSet":
        return BraceSet(np.zeros((0, 1), np.int32), np.zeros(0))


def _f(a, like):
    return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)


def _i(a, like):
    return torch.as_tensor(np.asarray(a, np.int64), device=like.device)


def _calibration_terms(cal, heights, height_mult):
    h = heights[:, _i(cal.node, heights)]
    hm = height_mult[:, None]
    lo = _f(cal.lower, heights) / hm
    upper = _f(cal.upper, heights)
    # An absent upper bound (+inf) is divided as 0, so that its masked term
    # has a finite gradient in the absolute height (the JAX module's is NaN,
    # ROADMAP.md Queue 3); every value is the same.
    hi = torch.where(torch.isfinite(upper), upper, 0.0) / hm
    s_lo = SQRT_2_OVER_PI * _f(cal.lower_pm, heights)
    s_hi = SQRT_2_OVER_PI * _f(cal.upper_pm, heights)
    below = torch.clamp(lo - h, min=0.0)
    above = torch.clamp(h - hi, min=0.0)
    s_lo_safe = torch.where(s_lo > 0, s_lo, 1.0)
    s_hi_safe = torch.where(s_hi > 0, s_hi, 1.0)
    lp = -0.5 * (below / s_lo_safe) ** 2 - 0.5 * torch.where(
        torch.isfinite(upper / hm), (above / s_hi_safe) ** 2, 0.0
    )
    return lp, h, hm


def _constraint_terms(con, heights):
    hy = heights[:, _i(con.young, heights)]
    ho = heights[:, _i(con.old, heights)]
    s = SQRT_2_OVER_PI * _f(con.pm, heights)
    viol = torch.clamp(hy - ho, min=0.0)
    return -0.5 * (viol / s) ** 2


def _brace_terms(br, heights):
    """``[C, B, W]`` per braced-node terms (zero on padding)."""
    idx = _i(br.node, heights)
    mask = idx >= 0
    h = heights[:, torch.clamp(idx, min=0)]
    counts = torch.sum(mask, dim=1)
    hmean = torch.sum(torch.where(mask, h, 0.0), dim=2) / counts
    s = _f(br.sd, heights)[:, None]
    return torch.where(mask, -0.5 * ((h - hmean[:, :, None]) / s) ** 2, 0.0)


def calibrations_log(cal, heights, height_mult):
    """Log density of all calibrations per chain."""
    if cal.n == 0:
        return torch.zeros_like(height_mult)
    lp, h, _ = _calibration_terms(cal, heights, height_mult)
    valid = (height_mult > 0) & torch.all(h >= 0, dim=1)
    return torch.where(valid, torch.sum(lp, dim=1), -math.inf)


def constraints_log(con, heights):
    if con.n == 0:
        return torch.zeros_like(heights[:, 0])
    return torch.sum(_constraint_terms(con, heights), dim=1)


def braces_log(br, heights):
    if br.n == 0:
        return torch.zeros_like(heights[:, 0])
    return torch.sum(_brace_terms(br, heights), dim=(1, 2))


def calibrate_constrain_brace_log(cal, con, br, heights, height_mult):
    return (
        calibrations_log(cal, heights, height_mult)
        + constraints_log(con, heights)
        + braces_log(br, heights)
    )


def calibrate_constrain_brace_terms(cal, con, br, heights, height_mult):
    """Per-item log contributions ``[C, K + K' + B]`` (one summed term per
    brace); their sum equals :func:`calibrate_constrain_brace_log`."""
    parts = []
    if cal.n:
        lp, h, hm = _calibration_terms(cal, heights, height_mult)
        valid = (hm > 0) & (h >= 0)
        parts.append(torch.where(valid, lp, -math.inf))
    if con.n:
        parts.append(_constraint_terms(con, heights))
    if br.n:
        parts.append(torch.sum(_brace_terms(br, heights), dim=2))
    if not parts:
        return heights.new_zeros((heights.shape[0], 0))
    return torch.cat(parts, dim=1)
