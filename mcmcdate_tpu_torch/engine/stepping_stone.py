"""Marginal likelihood by stepping-stone sampling.

Port of ``mcmcdate_tpu/engine/stepping_stone.py``; with ``hamiltonian``
the in-cycle NUTS move runs in every stone (target prior + beta_k
likelihood), in the slow windows of the burn-ins and in sampling.  The
reference (``marginalLikelihood`` with ``SteppingStoneSampling``: 128
points, 4000 iterations a point, repetitive burn-in) runs the points one
after the other; here, as in the JAX package, the beta ladder is the chain
axis: all K points run at once as one chain batch, each chain's likelihood
tempered by its own ``beta_k = (k / (K-1))^(1/alpha)`` (``alpha = 0.3``,
Xie et al. 2011) in every decision of the sweep (the kernels read it from
a ``[C]`` vector).  The estimator telescopes

    log Z = sum_k log (1/n) sum_iters exp((beta_{k+1} - beta_k) * loglik_k)

with a log-sum-exp a point.

The reference also anneals along the path, each stone starting from the
previous stone's state.  With all stones in flight a short cascade before
the burn-in reproduces that: rung j sweeps the whole ladder
``CASCADE_SWEEPS`` times and then seeds stone j+1 from stone j.  The JAX
package runs the K-1 rungs as one scanned program; the port runs them as a
host loop, each rung's sweeps (which rebuild the sweep's carry at their
start) followed by one launch of the ``cascade_seed`` kernel.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.cascade_seed import cascade_seed
from ..models.dating import DatingModel
from ..models.state import State
from . import proposals as props
from .chains import CHUNK, ChainRunner, RunSettings, new_key, split_key
from .hmc import NutsInCycle
from .mh import BurnInSettings, tune_step

N_POINTS = 128
N_POINTS_PROF = 12
ITERATIONS_ML = 4000
ALPHA = 0.3
CASCADE_SWEEPS = 3  # sweeps a rung in the annealed-init cascade

REPETITIVE_BURN_IN = BurnInSettings([20, 40, 60, 80], [100] * 6)
REPETITIVE_BURN_IN_PROF = BurnInSettings([10, 20], [30, 40])


def beta_ladder(k: int = N_POINTS, alpha: float = ALPHA) -> np.ndarray:
    return (np.arange(k) / (k - 1)) ** (1.0 / alpha)


@dataclass
class MarginalLikelihoodResult:
    log_marginal_likelihood: float
    betas: np.ndarray
    mean_log_lik_per_point: np.ndarray


def stepping_stone_log_z(ll: np.ndarray, betas: np.ndarray) -> float:
    """The stepping-stone estimate of log Z from ``ll`` ``[iterations,
    K]``, the log likelihood of each point's samples, and the ladder
    ``betas`` ``[K]``: point k's samples bridge beta_k to beta_{k+1}."""
    b = np.asarray(betas)
    dbeta = b[1:] - b[:-1]
    x = ll[:, :-1] * dbeta[None, :]
    m = x.max(axis=0)
    log_ratios = m + np.log(np.mean(np.exp(x - m), axis=0))
    return float(log_ratios.sum())


def annealed_cascade(sweeps_fn, batch: State, tuning, key, betas, n_points: int,
                     cascade_sweeps: int = CASCADE_SWEEPS) -> State:
    """The annealed-init cascade: for rung j = 0 .. K-2, ``cascade_sweeps``
    sweeps of every stone at its own beta, then stone j+1 seeded from stone
    j (:func:`~..kernels.cascade_seed.cascade_seed`), so every stone starts
    from a state reached by annealing up the ladder.  ``sweeps_fn(batch,
    tuning, seed, n_sweeps, beta=betas)`` returns a tuple whose first
    element is the swept batch (the ``sweeps`` contract); each rung's seed
    comes from the ``uint32[2]`` ``key`` (:func:`~.chains.split_key`)."""
    for j in range(n_points - 1):
        key, seed = split_key(key)
        batch = sweeps_fn(batch, tuning, seed, cascade_sweeps, beta=betas)[0]
        cascade_seed(batch, j)
    return batch


def run_marginal_likelihood(model: DatingModel, init: State, settings: RunSettings, *,
                            profile: bool = False, hamiltonian: bool = False,
                            annealed_init: bool = True, log=print) -> MarginalLikelihoodResult:
    """The ``marginal-likelihood`` entry point: the ladder's points as one
    chain batch on ``settings.device``, the cascade, burn-in and repetitive
    burn-in windows with tuning, then sampling with each point's log
    likelihood collected every sweep."""
    table = props.build_proposal_table(model.topo, model.braces, model.calibrations_available)
    n_points = N_POINTS_PROF if profile else N_POINTS
    iters = settings.iterations if settings.iterations else ITERATIONS_ML
    # The fiber DE is not a stepping-stone move (the JAX package never calls
    # it there); the bold mixture and the fiber node-slide run in every
    # sweep.
    runner = ChainRunner(model, table, dataclasses.replace(settings, n_chains=n_points),
                         log=log, de_refused="marginal-likelihood does not run it")
    betas = torch.as_tensor(beta_ladder(n_points), dtype=runner.dtype, device=runner.device)
    batch, tuning = runner.init_chains(init)
    key = new_key(settings.seed if settings.seed is not None else 42)
    kern = runner.kern
    if annealed_init and n_points > 1:
        t0 = time.perf_counter()
        key, seed = split_key(key)
        batch = annealed_cascade(kern.sweeps, batch, tuning, new_key(seed), betas, n_points,
                                 CASCADE_SWEEPS)
        if runner.device.type == "cuda":
            torch.cuda.synchronize(runner.device)
        log(f"annealed-init cascade: {n_points - 1} rungs x {CASCADE_SWEEPS} sweeps in "
            f"{time.perf_counter() - t0:.1f}s (one cascade_seed launch a rung)")

    # NUTS per stone: each chain's target is prior + beta_k likelihood; the
    # runner adapts it as run's burn-in does.
    if hamiltonian:
        runner.nuts = NutsInCycle(model, dtype=runner.dtype)
    nuts = runner.nuts
    burn = REPETITIVE_BURN_IN_PROF if profile else REPETITIVE_BURN_IN
    # The initial burn-in, then the repetitive one, each point's chain at
    # its own beta (the reference's repetitive burn-in a point, all points
    # at once).
    bi = BurnInSettings.profiling() if profile else settings.burn_in
    log(f"stepping stones: {n_points} points x {iters} iterations, "
        f"burn-in {bi.total} + repetitive {burn.total}")
    schedule = ([("fast", w) for w in bi.fast] + [("slow", w) for w in bi.slow]
                + [("fast", w) for w in burn.fast] + [("slow", w) for w in burn.slow])
    for kind, w in schedule:
        acc_s = tot_s = 0
        # Fast windows run without the NUTS move (the MHG policy of burn_in).
        with_nuts = nuts is not None and kind == "slow"
        for _ in range(max(1, w // CHUNK)):
            key, seed = split_key(key)
            out = kern.sweeps(batch, tuning, seed, CHUNK, beta=betas,
                              nuts=nuts if with_nuts else None)
            batch = out[0]
            acc_s = acc_s + out[3]
            tot_s = tot_s + out[4]
            if with_nuts:
                runner._nuts_astats.append(float(out[6].mean()))
        tuning = tune_step(tuning, acc_s.to(runner.dtype), tot_s.to(runner.dtype),
                           runner.targets, tune_max=runner.tune_max)
        runner.adapt_nuts(batch)
    runner.finalize_nuts()

    # Sampling: every point's log likelihood after each sweep.
    lls = []
    it = 0
    t0 = time.perf_counter()
    while it < iters:
        key, seed = split_key(key)
        out = kern.sweeps(batch, tuning, seed, CHUNK, beta=betas,
                          collect=lambda s, lp_pr, lp_lik: lp_lik, nuts=nuts)
        batch = out[0]
        lls.append(torch.stack(out[5]).cpu().numpy())  # [CHUNK, n_points]
        it += CHUNK
    ll = np.concatenate(lls, axis=0)
    log(f"sampling: {it} iterations x {n_points} points in {time.perf_counter() - t0:.1f}s")
    b = betas.cpu().numpy()
    log_z = stepping_stone_log_z(ll, b)
    log(f"log marginal likelihood (stepping stone): {log_z:.4f}")
    return MarginalLikelihoodResult(log_marginal_likelihood=log_z, betas=b,
                                    mean_log_lik_per_point=ll.mean(axis=0))
