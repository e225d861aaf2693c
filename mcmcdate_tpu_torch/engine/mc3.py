"""MC3 (Metropolis-coupled MCMC, parallel tempering).

Port of ``mcmcdate_tpu/engine/mc3.py`` (the reference's ``mc3 (MC3Settings
(NChains 4) (SwapPeriod 2) (NSwaps 3))``).  The temperatures are one more
batch axis: the chain batch is ``[groups * N_TEMPS]``, chain ``g * N_TEMPS +
k`` running at ``beta_k`` of its group's ladder (``beta_0 = 1``, ``beta_{k+1}
= beta_k / (1 + dt_k)``), which tempers both the prior and the likelihood of
every decision of the sweep (``sweeps(beta=, beta_prior=)``: each chain's
temperature from a ``[C]`` vector in every decision kernel).  Each chunk
of ``SWAP_PERIOD`` sweeps ends with one swap move: ``N_SWAPS`` adjacent-pair
exchanges a group, kernel M1 ``mc3_swap`` (``kernels/mc3_swap.py``), which
permutes the groups' states in place; the tuning stays with its
temperature slot.  The swap's untempered log posteriors are the sweep's
carried ``lp_pr + lp_lik``, which ``sweeps`` returns (the JAX package
evaluates ``model.log_posterior`` afresh; the two differ by the carry's
float32 rounding).  Each rung's ``dt_k`` is tuned from its own pair's swap
rate after every burn-in window.  Only the cold chains (slot 0 of each
group) are monitored: group 0's in the monitor files, all groups' pooled
for the diagnostics.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..kernels.mc3_swap import mc3_swap
from ..models.dating import DatingModel
from ..models.state import State
from . import checkpoint as ckpt
from . import proposals as props
from .chains import ChainRunner, RunSettings, _slim_outs, new_key, split_key
from .hmc import NutsInCycle
from .mh import tune_step
from .monitor import MonitorWriter

N_TEMPS = 4
SWAP_PERIOD = 2
N_SWAPS = 3
DELTA_T = 0.1  # beta_k = 1 / (1 + DELTA_T * k); auto-tuned during burn-in
SWAP_TARGET = 0.3  # target per-attempt swap acceptance for dt tuning
DT_MIN, DT_MAX = 0.01, 2.0

SCALARS = ("birth", "death", "height", "rate_mean", "rate_var", "lp_post")


def temperature_ladder(n_temps: int = N_TEMPS, dt: float = DELTA_T) -> np.ndarray:
    return 1.0 / (1.0 + dt * np.arange(n_temps))


def ladder_of(dts) -> np.ndarray:
    """The ladder of rung gaps ``dts`` ``[T - 1]``: ``beta_0 = 1``,
    ``beta_{k+1} = beta_k / (1 + dt_k)``."""
    return np.concatenate([[1.0], 1.0 / np.cumprod(1.0 + np.asarray(dts, np.float64))])


def swap_draws(gen, n_groups: int, n_temps: int = N_TEMPS, n_swaps: int = N_SWAPS,
               dtype=torch.float32):
    """One swap move's draws on ``gen``'s device: each draw's pair, its lower
    slot uniform in ``[0, n_temps - 1)`` (int32), and its accept uniform,
    both ``[n_swaps, n_groups]``."""
    pair = torch.randint(0, n_temps - 1, (n_swaps, n_groups), generator=gen, dtype=torch.int32,
                         device=gen.device)
    u = torch.rand((n_swaps, n_groups), generator=gen, dtype=dtype, device=gen.device)
    return pair, u


def make_swap_fn(n_groups: int, n_temps: int = N_TEMPS):
    """The swap move of ``n_groups`` groups of ``n_temps`` slots:
    ``swap(batch, U, pair, u, betas) -> (batch, accept [S, G], pair_acc,
    pair_tot)``, in place.  ``U`` ``[G T]`` holds the chains' untempered log
    posteriors, ``pair`` and ``u`` the draws (:func:`swap_draws`), ``betas``
    ``[T]`` the ladder.  A swap between slots ``p`` and ``p + 1`` of a group
    exchanges their states, accepted with ``min(1, exp((beta_p - beta_{p+1})
    (U_{p+1} - U_p)))`` (the JAX ``make_swap_fn``); M1 on the card, its
    plain version on the CPU."""
    def swap(batch: State, U, pair, u, betas):
        if pair.shape[1] != n_groups or betas.shape[0] != n_temps:
            raise ValueError(f"swap: draws for {pair.shape[1]} groups and a ladder of "
                             f"{betas.shape[0]}, expected {n_groups} x {n_temps}")
        accept, pair_acc, pair_tot = mc3_swap(batch, U, pair, u, betas)
        return batch, accept, pair_acc, pair_tot

    return swap


def run_mc3(model: DatingModel, init: State, settings: RunSettings, *, hamiltonian: bool = False,
            continue_from=None, log=print) -> ChainRunner:
    """Full MC3 run: burn-in with tuning (of the proposals and of the
    ladder), then sampling with swaps, monitors of the cold chain, the
    checkpoint and the pooled cold chains' diagnostics.

    ``settings.n_chains`` is the number of independent MC3 groups; the
    batch is ``n_chains * N_TEMPS`` chains.  ``continue_from = (state,
    tuning, key, iteration)`` resumes an MC3 save (the reference's
    ``mc3Load``): burn-in is skipped, the ladder comes from the saved
    ``mc3_dt``, the monitors append and the saved cold-chain trace is
    preloaded.  Returns the runner; its ``mc3`` holds the final ``dt`` per
    rung, the per-pair swap rates and counts (accepted, attempted) of the
    run and the rates of sampling alone, the mean swap rate of sampling and
    the ``dt`` after each burn-in window."""
    table = props.build_proposal_table(model.topo, model.braces, model.calibrations_available)
    n_groups = settings.n_chains
    total = n_groups * N_TEMPS
    # The fiber DE is not an MC3 move (the JAX run_mc3 never calls it); the
    # bold mixture and the fiber node-slide run in every sweep, at each
    # chain's prior temperature.
    runner = ChainRunner(model, table, dataclasses.replace(settings, n_chains=total), log=log,
                         de_refused="MC3 does not run it")
    kern, dtype, device = runner.kern, runner.dtype, runner.device
    dt_ladder = np.full(N_TEMPS - 1, DELTA_T)
    if continue_from is not None:
        saved = ckpt.load_arrays(settings.analysis_name, ("mc3_dt",), in_dir=settings.out_dir)
        if "mc3_dt" in saved:
            dt_saved = np.asarray(saved["mc3_dt"], np.float64)
            dt_ladder = np.full(N_TEMPS - 1, float(dt_saved)) if dt_saved.ndim == 0 else dt_saved

    def betas_of(dts):
        return torch.as_tensor(np.tile(ladder_of(dts), n_groups), dtype=dtype, device=device)

    betas = betas_of(dt_ladder)
    if continue_from is not None:
        state0, tuning0, key, start_it = continue_from
        batch = state0.to(device=device, dtype=dtype)
        if batch.n_chains != total:
            raise SystemExit(f"MC3 continue: saved batch has {batch.n_chains} chains, expected "
                             f"{total} ({n_groups} groups x {N_TEMPS})")
        tuning = torch.as_tensor(tuning0, dtype=dtype, device=device)
        key = np.asarray(key, np.uint32)
    else:
        start_it = 0
        batch, tuning = runner.init_chains(init)
        key = new_key(settings.seed if settings.seed is not None else 42)
    swap = make_swap_fn(n_groups, N_TEMPS)

    nuts = None
    if hamiltonian:
        # The move rides in every heated chain's cycle: chain k's target is
        # beta_k (prior + likelihood) + the root Jacobian.
        nuts = runner.nuts = NutsInCycle(model, dtype=dtype)
        if continue_from is not None:
            nuts.restore(ckpt.load_arrays(settings.analysis_name, ("nuts_eps", "nuts_inv_mass"),
                                          in_dir=settings.out_dir))

    monitor = MonitorWriter(model, settings.analysis_name, settings.out_dir,
                            period=settings.monitor_period, log=log).open(
        mode="a" if continue_from is not None else "w")
    mc3_meta = {"mc3": True, "n_groups": n_groups, "n_temps": N_TEMPS}
    if hamiltonian:
        mc3_meta["hamiltonian"] = True
    cold_idx = np.arange(n_groups) * N_TEMPS
    cold_draws = {k: [] for k in SCALARS}
    if continue_from is not None:
        # The saved cold-chain trace comes first, so that the diagnostics
        # cover the whole run.
        for k, arr in (ckpt.load_trace(settings.analysis_name, in_dir=settings.out_dir)
                       or {}).items():
            arr = np.asarray(arr)
            if arr.ndim == 2 and arr.shape[1] == n_groups:
                cold_draws.setdefault(k, []).append(arr)

    def do_checkpoint(it):
        arrays = dict(nuts.state_arrays()) if nuts is not None else {}
        arrays["mc3_dt"] = np.asarray(dt_ladder)
        ckpt.save(settings.analysis_name, batch, tuning, key, it, table.n_proposals,
                  out_dir=settings.out_dir, extra=mc3_meta, extra_arrays=arrays)
        trace = {k: np.concatenate(v, axis=0) for k, v in cold_draws.items() if v}
        if trace:
            ckpt.save_trace(settings.analysis_name, trace, out_dir=settings.out_dir)

    # Swap counts of the whole run per adjacent pair (on the device).
    pair_acc = torch.zeros(N_TEMPS - 1, dtype=torch.int64, device=device)
    pair_tot = torch.zeros(N_TEMPS - 1, dtype=torch.int64, device=device)

    def phase(n_iters, tune_every, collect_monitor, start, use_nuts=True):
        """``n_iters`` iterations in chunks of SWAP_PERIOD sweeps and a swap;
        returns the mean swap rate and each pair's rate in this phase."""
        nonlocal batch, tuning, key
        it = start
        next_save = it + settings.save_period
        acc_sum = tot_sum = 0
        acc0, tot0 = pair_acc.clone(), pair_tot.clone()
        swaps = torch.zeros((), dtype=torch.int64, device=device)
        n_swaps = 0
        astats = []
        with_nuts = nuts is not None and use_nuts
        while it < start + n_iters:
            t0 = time.perf_counter()
            key, seed = split_key(key)
            key, swap_seed = split_key(key)
            out = kern.sweeps(batch, tuning, seed, SWAP_PERIOD,
                              collect=runner._collect if collect_monitor else None, beta=betas,
                              beta_prior=betas, nuts=nuts if with_nuts else None)
            batch, lp_pr, lp_lik, acc, tot, outs = out[:6]
            if with_nuts:
                astats.append(float(out[6].mean()))
            gen = torch.Generator(device=device).manual_seed(swap_seed)
            pair, u = swap_draws(gen, n_groups, dtype=dtype)
            batch, accept, pa, pt = swap(batch, lp_pr + lp_lik, pair, u, betas[:N_TEMPS])
            swaps += accept.sum()
            n_swaps += accept.numel()
            pair_acc.add_(pa)
            pair_tot.add_(pt)
            acc_sum = acc_sum + acc
            tot_sum = tot_sum + tot
            if collect_monitor:
                stacked = _slim_outs({k: torch.stack([o[k] for o in outs]) for k in outs[0]})
                rows = {k: v.cpu().numpy() for k, v in stacked.items()}
                monitor.write_rows(it, {k: v[:, 0] for k, v in rows.items()})
                for nm in SCALARS:
                    cold_draws[nm].append(rows[nm][:, cold_idx])
                ages = rows["ages_diag"][:, cold_idx]
                for j, lbl in enumerate(runner.diag_labels):
                    cold_draws.setdefault(f"age[{lbl}]", []).append(ages[:, :, j])
            runner.sweep_seconds.append((time.perf_counter() - t0) / SWAP_PERIOD)
            it += SWAP_PERIOD
            if tune_every and (it - start) % tune_every == 0:
                runner.accepted += int(acc_sum.sum())
                runner.attempted += int(tot_sum.sum())
                tuning = tune_step(tuning, acc_sum.to(dtype), tot_sum.to(dtype), runner.targets,
                                   tune_max=runner.tune_max)
                acc_sum = tot_sum = 0
                if with_nuts and astats:
                    nuts.adapt(float(np.mean(astats)), nuts.coords.to_vector(batch).cpu().numpy())
                    astats = []
            if collect_monitor and it >= next_save:
                do_checkpoint(it)
                next_save = it + settings.save_period
        if not isinstance(acc_sum, int):
            runner.accepted += int(acc_sum.sum())
            runner.attempted += int(tot_sum.sum())
        if astats:
            runner._nuts_astats.extend(astats)
        window = ((pair_acc - acc0).double() / (pair_tot - tot0).clamp(min=1).double()).cpu()
        return (float(swaps) / n_swaps if n_swaps else 0.0), window.numpy()

    ladder0 = ladder_of(dt_ladder)
    log(f"MC3: {n_groups} groups x {N_TEMPS} temperatures "
        f"(betas {ladder0.round(3).tolist()})")
    dt_history = []
    if continue_from is None:
        bi = settings.burn_in
        log(f"burn-in: {bi.total} iterations")
        done = 0
        # Fast windows run without the NUTS move (the MHG policy).
        for kind, windows in (("fast", bi.fast), ("slow", bi.slow)):
            for w in windows:
                sr, pr = phase(w, tune_every=w, collect_monitor=False, start=done,
                               use_nuts=kind == "slow")
                done += w
                # Each rung's gap widens when its own pair swaps too easily
                # and shrinks when it stalls (target SWAP_TARGET); the
                # reference's ladder is static.
                dt_ladder = np.clip(dt_ladder * np.exp(0.5 * (pr - SWAP_TARGET)), DT_MIN, DT_MAX)
                dt_history.append(dt_ladder.copy())
                betas = betas_of(dt_ladder)
                log(f"burn-in [{kind}] window {w}: {done}/{bi.total}, swap rate {sr:.2f}, "
                    f"dt {np.round(dt_ladder, 3).tolist()}")
        if nuts is not None:
            nuts.finalize_adaptation()
            im = np.asarray(nuts.inv_mass)
            log(f"NUTS adaptation: eps {nuts.eps:.5f}, "
                f"inv_mass [{im.min():.3g}, {im.max():.3g}]")
    else:
        log(f"Continuing MC3 from iteration {start_it}.")
    sr, sampling = phase(settings.iterations, tune_every=0, collect_monitor=True, start=start_it)
    # The per-pair rates of the whole run (the JAX package's log counts the
    # burn-in's swaps too).
    rates = (pair_acc.double() / pair_tot.clamp(min=1).double()).cpu().numpy()
    pairs = " ".join(f"{i}<->{i + 1}: {rates[i]:.2f}" for i in range(N_TEMPS - 1))
    log(f"sampling done; swap acceptance rate {sr:.2f} (per temperature pair: {pairs})")
    do_checkpoint(start_it + settings.iterations)
    monitor.close()
    if runner._nuts_astats:
        log(f"NUTS in-cycle move: mean acceptance statistic "
            f"{float(np.mean(runner._nuts_astats)):.3f} over {len(runner._nuts_astats)} chunks "
            f"(eps {nuts.eps:.5f})")
        runner._nuts_astats = []
    # The pooled cold chains are the diagnostics' ensemble.
    if any(v for v in cold_draws.values()):
        runner._write_diagnostics(cold_draws)
    runner.mc3 = dict(dt=np.asarray(dt_ladder), pair_rates=rates, sampling_pair_rates=sampling,
                      pair_counts=(pair_acc.cpu().numpy(), pair_tot.cpu().numpy()),
                      swap_rate=sr, dt_history=dt_history)
    return runner
