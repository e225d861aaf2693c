"""The dating model: prior, likelihood and posterior over a chain batch.

Port of ``mcmcdate_tpu/models/dating.py``.  Static data stays on the host
(NumPy); the tensors the densities need live on ``device`` in ``dtype``.
The flat prior-term vector goes through kernel K1 (``prior_terms``) and
the whitened residual through kernel K2 (``whiten``), or under the banded
kind kernel B1 (``band_matmul``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional

import numpy as np
import torch

from ..kernels.band_matmul import band_matmul
from ..kernels.prior_terms import kernel_arrays as prior_kernel_arrays, prior_terms
from ..kernels.whiten import whiten
from ..ops import banded, birth_death, clocks, heights as H, mvn, node_priors
from ..ops.dists import exponential_logpdf, gamma_logpdf
from ..tree import DeviceTopology
from ..utils import device as devices
from .state import State


@dataclass(eq=False)
class DatingModel:
    """Static model description (``getMcmcProps``) bound to a device.

    ``topo`` may be given as a flat topology (the port's ``FlatTopology``
    or the JAX package's); it is wrapped in a :class:`DeviceTopology` on
    ``device``: the card unless the caller asks for the CPU (no card:
    :class:`~..utils.device.NoCardError`).  ``dtype=None``: float32 on a
    CUDA device, float64 on the CPU."""

    topo: DeviceTopology
    likelihood: mvn.LikelihoodData
    clock: str = clocks.UNCORRELATED_GAMMA
    calibrations: node_priors.CalibrationSet = field(
        default_factory=node_priors.CalibrationSet.empty
    )
    constraints: node_priors.ConstraintSet = field(
        default_factory=node_priors.ConstraintSet.empty
    )
    braces: node_priors.BraceSet = field(default_factory=node_priors.BraceSet.empty)
    mean_root_height: float = 1.0
    device: str = "cuda"
    dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        self.device = devices.resolve(self.device)
        self.dtype = devices.float_dtype(self.device, self.dtype)
        if not isinstance(self.topo, DeviceTopology):
            self.topo = DeviceTopology(self.topo, self.device)

    @property
    def calibrations_available(self) -> bool:
        return self.calibrations.n > 0

    # -- prior components (each mirrors a monitor column) ----------------

    def log_prior_cal_con_brace(self, state: State):
        return node_priors.calibrate_constrain_brace_log(
            self.calibrations, self.constraints, self.braces, state.heights, state.height
        )

    def log_prior_birth_death(self, state: State):
        lp_rates = exponential_logpdf(1.0, state.birth) + exponential_logpdf(1.0, state.death)
        lp_tree = birth_death.birth_death_log(
            state.heights, self.topo.parent_t, self.topo.is_leaf_t,
            state.birth, state.death, 1.0,
        )
        return lp_rates + lp_tree

    def log_prior_relaxed_clock(self, state: State):
        lp_mean = exponential_logpdf(self.mean_root_height, state.rate_mean)
        lp_var = gamma_logpdf(1.5, 1.0 / 6.0, state.rate_var)
        tl = H.branch_lengths(state.heights, self.topo.parent_t)
        lp_tree = clocks.relaxed_clock_log(
            self.clock, state.rates, tl, self.topo.non_root_t, 1.0, state.rate_var
        )
        return lp_mean + lp_var + lp_tree

    def log_prior(self, state: State):
        return (
            self.log_prior_cal_con_brace(state)
            + self.log_prior_birth_death(state)
            + self.log_prior_relaxed_clock(state)
        )

    # -- prior term blocks: [scalars(4), bd(N+1), clock(N+1), nodes(nn)] --

    def term_scalars(self, state: State):
        return torch.stack(
            [
                exponential_logpdf(1.0, state.birth),
                exponential_logpdf(1.0, state.death),
                exponential_logpdf(self.mean_root_height, state.rate_mean),
                gamma_logpdf(1.5, 1.0 / 6.0, state.rate_var),
            ],
            dim=1,
        )

    def term_bd(self, state: State):
        return birth_death.birth_death_terms(
            state.heights, self.topo.parent_t, self.topo.is_leaf_t,
            state.birth, state.death, 1.0,
        )

    def term_clock(self, state: State):
        tl = H.branch_lengths(state.heights, self.topo.parent_t)
        return clocks.relaxed_clock_terms(
            self.clock, state.rates, tl, self.topo.non_root_t, 1.0, state.rate_var
        )

    def term_nodes(self, state: State):
        return node_priors.calibrate_constrain_brace_terms(
            self.calibrations, self.constraints, self.braces, state.heights, state.height
        )

    @property
    def term_block_sizes(self):
        n = self.topo.n
        nn = self.calibrations.n + self.constraints.n + self.braces.n
        return (4, n + 1, n + 1, nn)

    @cached_property
    def prior_kernel_arrays(self) -> dict:
        """Static arrays in the layout kernel K1 reads."""
        return prior_kernel_arrays(self)

    def log_prior_terms(self, state: State):
        """Flat ``[C, T]`` vector of log prior terms (kernel K1);
        ``sum == log_prior``.  Acceptance ratios are taken term by term so
        untouched contributions cancel exactly in f32."""
        return prior_terms(self, state)

    # -- likelihood ------------------------------------------------------

    @cached_property
    def _log_lik_fn(self):
        return mvn.make_log_likelihood(self.likelihood, self.dtype, self.device)

    def log_likelihood(self, state: State):
        if self.likelihood.kind == mvn.NONE:
            return torch.zeros_like(state.height)
        return self._log_lik_fn(H.distances_from_state(state, self.topo))

    # Internal (pre-order) likelihood layout: mu and the precision factor
    # permuted once on the host, so sub-tree proposals touch entry 0 plus
    # one contiguous range of distances.
    @cached_property
    def mu_internal(self) -> Optional[np.ndarray]:
        if self.likelihood.kind == mvn.NONE:
            return None
        return self.likelihood.mu[self.topo.ref_to_internal_perm]

    @cached_property
    def chol_internal(self) -> Optional[np.ndarray]:
        """Lower Cholesky of the internally permuted precision (f64; a
        sparse precision is stored dense and taken as a full one); ``None``
        for the univariate, banded and none kinds (no O(D^2) matrix)."""
        if self.likelihood.kind not in (mvn.FULL, mvn.SPARSE):
            return None
        perm = self.topo.ref_to_internal_perm
        prec = self.likelihood.precision[np.ix_(perm, perm)]
        return np.linalg.cholesky(prec)

    @cached_property
    def band_L3_internal(self) -> Optional[np.ndarray]:
        """Banded kind: the block-tridiagonal form ``[nb, 3, wb, wb]`` of the
        upper-banded ``L`` (``P_internal = L L'``, f64).  The band was
        estimated in the internal layout at ``prepare``; the stored
        permutation must be this topology's."""
        if self.likelihood.kind != mvn.BANDED:
            return None
        if not np.array_equal(np.asarray(self.likelihood.band_perm),
                              self.topo.ref_to_internal_perm):
            raise ValueError("banded likelihood data was prepared for a different topology "
                             "(internal permutation mismatch)")
        wb = banded.default_block_size(int(self.likelihood.bandwidth))
        return banded.blocks_from_upper_band(self.likelihood.band_chol, wb)

    @cached_property
    def inv_sd_internal(self) -> Optional[np.ndarray]:
        """Univariate kind: per-distance ``1/sd`` in the internal layout."""
        if self.likelihood.kind != mvn.UNIVARIATE:
            return None
        perm = self.topo.ref_to_internal_perm
        return 1.0 / np.sqrt(self.likelihood.variances[perm])

    def _dev(self, a):
        return None if a is None else torch.as_tensor(a, dtype=self.dtype, device=self.device)

    @cached_property
    def mu_internal_t(self):
        return self._dev(self.mu_internal)

    @cached_property
    def chol_internal_t(self):
        return self._dev(self.chol_internal)

    @cached_property
    def band_L3_internal_t(self):
        return self._dev(self.band_L3_internal)

    @cached_property
    def inv_sd_internal_t(self):
        return self._dev(self.inv_sd_internal)

    def whitened_residual_internal(self, state: State):
        """Internal-layout whitened residual ``y = (d - mu) L`` ``[C, D]``
        (kernel K2 for the full kind, B1 for the banded one); empty for the
        none kind."""
        if self.likelihood.kind == mvn.NONE:
            return state.heights.new_zeros((state.n_chains, 0))
        d = H.distances_internal(state, self.topo)
        if self.likelihood.kind == mvn.UNIVARIATE:
            return (d - self.mu_internal_t) * self.inv_sd_internal_t
        if self.likelihood.kind == mvn.BANDED:
            y, _ = band_matmul(d.contiguous(), self.band_L3_internal_t, sub=self.mu_internal_t,
                               upper=True)
            return y
        y, _ = whiten(d, self.chol_internal_t, sub=self.mu_internal_t)
        return y

    @property
    def log_lik_const(self) -> float:
        """Constant part of the log likelihood (normalization)."""
        if self.likelihood.kind == mvn.NONE:
            return 0.0
        c = -0.9189385332046727 * self.likelihood.dim
        if self.likelihood.kind == mvn.UNIVARIATE:
            return c - 0.5 * float(np.sum(np.log(self.likelihood.variances)))
        return c - 0.5 * float(self.likelihood.log_det_sigma)

    # -- posterior -------------------------------------------------------

    def log_posterior(self, state: State):
        out = self.log_prior(state) + self.log_likelihood(state)
        return torch.where(torch.isnan(out), -math.inf, out)
