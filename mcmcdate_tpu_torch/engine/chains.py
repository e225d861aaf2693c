"""High-level MCMC orchestration: burn-in, sampling, monitors, checkpoints.

Port of ``mcmcdate_tpu/engine/chains.py`` for MHG on one device, with the
ticket-batched ``FastSweeps`` by default and the sequential ``MHKernel``
as the fallback, chosen as the JAX package chooses, and the in-cycle NUTS
move of ``--hamiltonian`` (``engine/hmc.py``; in the slow burn-in windows
and in sampling).  FastSweeps takes the optional bold contrary mixture and
fiber node-slide (``--bold-contra``, ``--bold-factor``, ``--fiber-slide``),
and with ``--fiber-de`` and at least 4 chains the fiber-DE rounds
(``engine/ensemble.py``) run after every chunk of ``run`` and ``continue``.
MC3 runs its own loop over this runner (``engine/mc3.py``), without the
fiber DE, as the JAX package does; the device mesh stays in the JAX
package for now.  The sampler's random streams derive
from a ``uint32[2]`` key that is split once per sweep chunk and saved in
the checkpoint.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..models.dating import DatingModel
from ..models.state import FIELDS, State
from ..ops import mvn
from . import checkpoint as ckpt
from . import proposals as props
from .diagnostics import summarize
from .ensemble import FiberDE
from .fast_sweep import UNIVARIATE_DENSE_MAX, FastSweeps, env_default
from .hmc import NutsInCycle
from .mh import BurnInSettings, MHKernel, tune_step
from .monitor import MonitorWriter

CHUNK = 10  # sweeps per chunk; all reference schedules are multiples


def new_key(seed: int) -> np.ndarray:
    """The ``uint32[2]`` RNG key of a seed (laid out like a JAX PRNG key)."""
    return np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def split_key(key) -> tuple:
    """``(next_key, seed)``: a fresh key and a 63-bit seed, both derived
    from ``key`` alone."""
    words = np.random.SeedSequence([int(k) for k in np.asarray(key)]).generate_state(4)
    return words[:2].astype(np.uint32), (int(words[2]) << 31) ^ int(words[3])


def _slim_outs(outs):
    """Slice the per-node monitor leaves to chain 0 on the device before the
    host copy: only chain 0's heights and rates go to the tree monitors;
    scalar leaves keep all chains for the cross-chain diagnostics."""
    if not isinstance(outs, dict):
        return outs
    slim = dict(outs)
    for k in ("heights", "rates"):
        if k in slim:
            slim[k] = slim[k][:, :1]
    return slim


def _diag_node_subset(model: DatingModel, max_nodes: int = 16):
    """Node subset whose ages feed the cross-chain diagnostics: the root,
    up to half the budget of calibrated nodes, then the largest inner
    subtrees."""
    topo = model.topo
    labels = {0: "root"}
    take = [0]
    cal = model.calibrations
    if cal.n:
        for i in np.linspace(0, cal.n - 1, min(cal.n, max_nodes // 2)).astype(int):
            nd = int(np.asarray(cal.node)[i])
            if nd not in labels:
                labels[nd] = (cal.names[i] if cal.names else f"node{nd}")
                take.append(nd)
    sizes = np.asarray(topo.n_nodes_subtree)
    inner = [int(i) for i in np.asarray(topo.inner_nodes) if i != 0]
    for i in sorted(inner, key=lambda j: -int(sizes[j])):
        if len(take) >= max_nodes:
            break
        if i not in labels:
            labels[i] = f"node{i}"
            take.append(i)
    return np.asarray(take, np.int32), [labels[i] for i in take]


@dataclass
class RunSettings:
    """Mirrors the reference ``Settings``."""

    analysis_name: str
    burn_in: BurnInSettings = field(default_factory=BurnInSettings.default)
    iterations: int = 8000
    n_chains: int = 4
    monitor_period: int = 2
    save_period: int = 1000  # checkpoint every this many iterations
    out_dir: str = "."
    seed: Optional[int] = None
    dtype: str = "float32"
    beta: float = 1.0  # likelihood temperature of every decision
    fast_sweep: bool = True  # ticket-batched sweep (engine/fast_sweep.py)
    device: str = "cuda"
    # The optional moves (FastSweeps' and the fiber DE's; None: the
    # MCMCDATE_BOLD_P, MCMCDATE_BOLD_FACTOR, MCMCDATE_FIBER_SLIDE and
    # MCMCDATE_FIBER_DE variables, else off and a factor of 8).  fiber_de:
    # rounds after each chunk, round(N) for N >= 1, one with probability N
    # below 1.
    bold_contra: Optional[float] = None
    bold_factor: Optional[float] = None
    fiber_slide: Optional[float] = None
    fiber_de: Optional[float] = None


def sweep_extras(out: tuple, nuts: bool, fiber: bool) -> dict:
    """The outputs of ``sweeps`` after its first six, by name: ``"nuts"``
    (the NUTS move's acceptance statistics ``[n, C]``) and ``"fiber"`` (the
    fiber phase's acceptance a sweep ``[n]``, NaN where the phase was
    skipped), as far as the call ran them."""
    return dict(zip([k for k, on in (("nuts", nuts), ("fiber", fiber)) if on], out[6:]))


class ChainRunner:
    """Runs burn-in and sampling of one model and proposal table."""

    def __init__(self, model: DatingModel, table: props.ProposalTable,
                 settings: RunSettings, log=print, de_refused: Optional[str] = None):
        """``de_refused``: why the caller does not run the fiber DE (MC3,
        the stepping stones), logged in its place when it is asked for."""
        self.model = model
        self.table = table
        self.s = settings
        self.log = log
        univariate_too_big = (model.likelihood.kind == mvn.UNIVARIATE
                              and model.likelihood.dim > UNIVARIATE_DENSE_MAX)
        if settings.fast_sweep and not univariate_too_big:
            # The univariate kind rides the batched sweep as a dense diagonal
            # up to UNIVARIATE_DENSE_MAX dims; beyond that the sequential
            # sweep avoids the O(N^2) diagonal.
            self.kern = FastSweeps(model, table, bold_p=settings.bold_contra,
                                   bold_factor=settings.bold_factor,
                                   fiber_slide=settings.fiber_slide)
            if self.kern.bold_p > 0:
                log(f"bold contrary kernels: p={self.kern.bold_p:g}, "
                    f"factor={self.kern.bold_factor:g}")
            if self.kern.fiber_slide_p > 0:
                log(f"fiber node-slide phase: p={self.kern.fiber_slide_p:g}")
        else:
            self.kern = MHKernel(model, table)
        # The optional moves' acceptances, by name: the fiber phase's of each
        # sweep it ran, the fiber DE's of each round.
        self._extra_accs = {}
        self.fiber_de = env_default(settings.fiber_de, "MCMCDATE_FIBER_DE", 0.0)
        self.de_move = None
        if self.fiber_de > 0:
            if de_refused is None and settings.n_chains < 4:
                de_refused = f"it needs at least 4 chains, the run has {settings.n_chains}"
            if de_refused is None:
                self.de_move = FiberDE(model)
                log(f"fiber-DE ensemble phase: {self.fiber_de:g} round(s)/chunk over "
                    f"{settings.n_chains} chains")
            else:
                log(f"fiber DE: not applied ({de_refused})")
        self.dtype = getattr(torch, settings.dtype)
        self.device = torch.device(settings.device)
        self.targets = torch.as_tensor(table.target_rates(), dtype=self.dtype,
                                       device=self.device)
        self.tune_max = torch.as_tensor(table.tune_max(), dtype=self.dtype, device=self.device)
        self.diag_idx, self.diag_labels = _diag_node_subset(model)
        self._diag_idx_dev = torch.as_tensor(self.diag_idx.astype(np.int64),
                                             device=self.device)
        # Cross-chain draw history ({name: [arrays of [T, chains]]}),
        # persisted as the trace sidecar at every checkpoint.
        self._draws_hist: dict = {}
        # Wall seconds per sweep of every chunk run, and the accepted and
        # attempted proposals of the whole run (all chains).
        self.sweep_seconds: list = []
        self.accepted = 0
        self.attempted = 0
        self.nuts = None  # a NutsInCycle, set by run_analysis with hamiltonian
        self._nuts_astats: list = []
        self.mc3 = None  # an MC3 run's ladder and swap rates (engine/mc3.py)

    def _collect(self, state: State, lp_pr, lp_lik):
        """One sweep's monitor row for every chain.  The sweep updates the
        state in place, so the state leaves are copies."""
        m = self.model
        return dict(
            birth=state.birth.clone(),
            death=state.death.clone(),
            height=state.height.clone(),
            rate_mean=state.rate_mean.clone(),
            rate_var=state.rate_var.clone(),
            heights=state.heights.clone(),
            rates=state.rates.clone(),
            lp_post=lp_pr + self.s.beta * lp_lik,
            lp_prior=lp_pr,
            lp_lik=lp_lik,
            lp_cal=m.log_prior_cal_con_brace(state),
            lp_bd=m.log_prior_birth_death(state),
            lp_clock=m.log_prior_relaxed_clock(state),
            # Absolute ages of the diagnostic node subset, for ALL chains.
            ages_diag=state.heights[:, self._diag_idx_dev] * state.height[:, None],
        )

    def init_chains(self, state: State, jitter_rates: bool = True):
        """Broadcast the initial state over chains; ``jitter_rates`` draws
        each chain's initial branch rates from Gamma(5, 0.2) (see the JAX
        package) so that tuning cannot collapse the rate variance and the
        chains start apart."""
        C = self.s.n_chains
        batch = State(**{
            k: getattr(state, k)[:1].expand((C,) + getattr(state, k).shape[1:])
            .to(device=self.device, dtype=self.dtype).contiguous()
            for k in FIELDS
        })
        if jitter_rates:
            rng = np.random.default_rng(self.s.seed or 0)
            r = rng.gamma(5.0, 0.2, size=(C, self.model.topo.n))
            r[:, 0] = 1.0  # stem entry unused
            batch = batch.replace(rates=torch.as_tensor(r, dtype=self.dtype, device=self.device))
        tuning = torch.ones((C, self.table.n_proposals), dtype=self.dtype, device=self.device)
        return batch, tuning

    def _run_window(self, batch, tuning, key, n_sweeps, collect=False, use_nuts=None):
        """Run ``n_sweeps`` (a multiple of CHUNK, padded up) sweeps; returns
        the batch, the key, the summed accept and attempt counts and the
        collected rows per chunk (host arrays, monitor leaves slimmed).
        ``use_nuts`` says whether the NUTS move runs (default: whenever the
        runner has one); each chunk's mean acceptance statistic is kept for
        the adaptation and the log."""
        with_nuts = self.nuts is not None if use_nuts is None else use_nuts
        n_chunks = max(1, (n_sweeps + CHUNK - 1) // CHUNK)
        acc_sum = tot_sum = 0
        outs_all = []
        for _ in range(n_chunks):
            key, seed = split_key(key)
            if self.de_move is not None:
                key, de_seed = split_key(key)
            t0 = time.perf_counter()
            out = self.kern.sweeps(
                batch, tuning, seed, CHUNK,
                collect=self._collect if collect else None, beta=self.s.beta,
                nuts=self.nuts if with_nuts else None,
            )
            batch, _, _, acc, tot, outs = out[:6]
            extras = sweep_extras(out, with_nuts, getattr(self.kern, "fiber_slide_p", 0.0) > 0)
            if "nuts" in extras:
                self._nuts_astats.append(float(extras["nuts"].mean()))
            if "fiber" in extras:
                a = extras["fiber"].cpu().numpy()
                self._extra_accs.setdefault("fiber node-slide", []).extend(
                    a[~np.isnan(a)].tolist())
            if self.de_move is not None:
                self._de_rounds(batch, de_seed)
            acc_sum = acc_sum + acc
            tot_sum = tot_sum + tot
            self.accepted += int(acc.sum())
            self.attempted += int(tot.sum())
            if collect:
                stacked = _slim_outs({k: torch.stack([o[k] for o in outs]) for k in outs[0]})
                outs_all.append({k: v.cpu().numpy() for k, v in stacked.items()})
            self.sweep_seconds.append((time.perf_counter() - t0) / CHUNK)
        return batch, key, acc_sum, tot_sum, outs_all

    def _de_rounds(self, batch, seed: int):
        """The fiber-DE rounds after a chunk (the JAX ``_fiber_de_phase``):
        round(N) rounds for N >= 1, else one round with probability N (a
        gate drawn on the host); ``batch`` is updated in place and each
        round's acceptance kept."""
        gen = torch.Generator(device=batch.heights.device).manual_seed(seed)
        p = self.fiber_de
        if p >= 1:
            n = int(round(p))
        else:
            n = int(np.random.default_rng(seed).random() < p)
        rates = [self.de_move(batch, gen) for _ in range(n)]
        if rates:
            self._extra_accs.setdefault("fiber DE", []).extend(
                torch.stack(rates).cpu().tolist())

    def burn_in(self, batch, tuning, key):
        """Custom auto-tuning windows (BurnInWithCustomAutoTuning)."""
        bi = self.s.burn_in
        done = 0
        t0 = time.time()
        for kind, windows in (("fast", bi.fast), ("slow", bi.slow)):
            for w in windows:
                # Fast windows run without the NUTS move, like the engine's
                # fast-proposal-only windows.
                batch, key, acc, tot, _ = self._run_window(
                    batch, tuning, key, w, use_nuts=self.nuts is not None and kind == "slow")
                tuning = tune_step(tuning, acc.to(self.dtype), tot.to(self.dtype),
                                   self.targets, tune_max=self.tune_max)
                self.adapt_nuts(batch)
                done += w
                rate = float(acc.to(self.dtype).sum()) / max(float(tot.to(self.dtype).sum()),
                                                             1.0)
                self.log(
                    f"burn-in [{kind}] window {w}: {done}/{bi.total} iterations, "
                    f"acceptance {rate:.3f}, {time.time() - t0:.1f}s elapsed"
                )
        self.finalize_nuts()
        return batch, tuning, key

    def adapt_nuts(self, batch):
        """After a window with the NUTS move: the step size by dual averaging
        on the window's mean acceptance statistic, the inverse mass from the
        chains' coordinate variances."""
        if self.nuts is None or not self._nuts_astats:
            return
        vecs = self.nuts.coords.to_vector(batch).cpu().numpy()
        self.nuts.adapt(float(np.mean(self._nuts_astats)), vecs)
        self._nuts_astats = []

    def finalize_nuts(self):
        """The adapted step size for sampling, logged with the inverse
        mass's range."""
        if self.nuts is None:
            return
        self.nuts.finalize_adaptation()
        im = np.asarray(self.nuts.inv_mass)
        self.log(f"NUTS adaptation: eps {self.nuts.eps:.5f}, "
                 f"inv_mass [{im.min():.3g}, {im.max():.3g}]")

    def sample(self, batch, tuning, key, iterations, monitor: Optional[MonitorWriter],
               start_iteration: int = 0, on_checkpoint: Optional[Callable] = None):
        """Sampling phase with monitors (chain 0), cross-chain scalar draws
        for the convergence diagnostics and periodic checkpoints."""
        it = start_iteration
        t0 = time.time()
        next_save = it + self.s.save_period
        scalar_names = ("birth", "death", "height", "rate_mean", "rate_var", "lp_post")
        draws = self._draws_hist
        for k in scalar_names:
            draws.setdefault(k, [])
        while it < start_iteration + iterations:
            n = min(CHUNK, start_iteration + iterations - it)
            batch, key, acc, tot, outs_all = self._run_window(batch, tuning, key, n,
                                                              collect=True)
            if monitor is not None:
                for outs in outs_all:
                    # leaves are [sweeps, chains, ...]; monitor chain 0.
                    monitor.write_rows(it, {k: v[:, 0] for k, v in outs.items()})
                    for k2 in scalar_names:
                        draws[k2].append(outs[k2])
                    for j, lbl in enumerate(self.diag_labels):
                        draws.setdefault(f"age[{lbl}]", []).append(outs["ages_diag"][:, :, j])
            it += n
            if on_checkpoint is not None and it >= next_save:
                on_checkpoint(batch, tuning, key, it)
                next_save = it + self.s.save_period
        if monitor is not None:
            monitor.flush()
        self.log(
            f"sampling: {iterations} iterations x {self.s.n_chains} chains in "
            f"{time.time() - t0:.1f}s"
        )
        if self.nuts is not None and self._nuts_astats:
            self.log(f"NUTS in-cycle move: mean acceptance statistic "
                     f"{float(np.mean(self._nuts_astats)):.3f} over "
                     f"{len(self._nuts_astats)} chunks (eps {self.nuts.eps:.5f})")
            self._nuts_astats = []
        for nm, accs in self._extra_accs.items():
            if accs:
                self.log(f"{nm}: mean acceptance {float(np.mean(accs)):.3f} "
                         f"over {len(accs)} phase sweeps")
        self._extra_accs = {}
        self._write_diagnostics(draws)
        return batch, tuning, key

    def trace_arrays(self) -> dict:
        """Full cross-chain draw history as ``{name: [draws, chains]}``."""
        return {k: np.concatenate(v, axis=0) for k, v in self._draws_hist.items() if v}

    def preload_trace(self, trace: Optional[dict]):
        """Seed the draw history from a saved trace (``continue``): the final
        diagnostics then cover the whole run, not just post-continue draws."""
        if not trace:
            return
        C = self.s.n_chains
        for k, arr in trace.items():
            arr = np.asarray(arr)
            if arr.ndim == 2 and arr.shape[1] == C:
                self._draws_hist.setdefault(k, []).append(arr)
            else:
                self.log(
                    f"trace: dropping {k} (saved chains {arr.shape} do not "
                    f"match the current {C}-chain run)"
                )

    # Fraction of the sampling draws dropped before R-hat/ESS (residual
    # post-burn-in drift otherwise dominates split R-hat on long runs).
    DIAG_DROP_FRACTION = 0.25

    def _write_diagnostics(self, draws):
        """Cross-chain R-hat and bulk/tail ESS of the scalar parameters and
        the diagnostic node ages, logged and written to
        ``<analysis>.diagnostics.tsv``."""
        if not draws or not next(iter(draws.values())):
            return
        samples = {k: np.concatenate(v, axis=0) for k, v in draws.items() if v}
        drop = int(next(iter(samples.values())).shape[0] * self.DIAG_DROP_FRACTION)
        samples = {k: v[drop:] for k, v in samples.items()}
        if drop:
            self.log(f"diagnostics: dropping the first {drop} draws "
                     f"({self.DIAG_DROP_FRACTION:.0%}) as residual warmup")
        self.log("convergence diagnostics (all chains):")
        table = summarize(samples, log=self.log)
        path = f"{self.s.out_dir}/{self.s.analysis_name}.diagnostics.tsv"
        with open(path, "w") as fh:
            fh.write("Parameter\tMean\tSD\tESS\tTailESS\tRhat\n")
            for k, s in table.items():
                fh.write(
                    f"{k}\t{s['mean']:.6g}\t{s['sd']:.6g}\t{s['ess']:.1f}\t"
                    f"{s['ess_tail']:.1f}\t{s['rhat']:.4f}\n"
                )


def run_analysis(model: DatingModel, init: State, settings: RunSettings, *,
                 init_from: Optional[tuple] = None, continue_from: Optional[tuple] = None,
                 hamiltonian: bool = False, log=print) -> ChainRunner:
    """The ``run`` and ``continue`` entry point: burn-in, a checkpoint,
    sampling with monitors, a final checkpoint.  ``init_from = (state,
    tuning, same_cycle)`` warm-starts from a previous save; ``continue_from
    = (state, tuning, key, it)`` resumes a saved run: no burn-in, the
    monitors reopened in append mode with iterations numbered after ``it``,
    the saved trace preloaded.  ``hamiltonian`` adds the in-cycle NUTS move
    (its step size and inverse mass saved in the checkpoint, restored on
    ``continue``).  Returns the runner (its ``sweep_seconds`` hold the wall
    time per sweep of every chunk)."""
    table = props.build_proposal_table(model.topo, model.braces, model.calibrations_available)
    runner = ChainRunner(model, table, settings, log=log)
    if hamiltonian:
        runner.nuts = NutsInCycle(model, dtype=runner.dtype)
    key = new_key(settings.seed if settings.seed is not None else 42)

    def do_checkpoint(batch, tuning, k, it):
        nuts = runner.nuts
        ckpt.save(settings.analysis_name, batch, tuning, k, it, table.n_proposals,
                  out_dir=settings.out_dir,
                  extra={"hamiltonian": True} if nuts is not None else None,
                  extra_arrays=nuts.state_arrays() if nuts is not None else None)
        trace = runner.trace_arrays()
        if trace:
            ckpt.save_trace(settings.analysis_name, trace, out_dir=settings.out_dir)
        log(f"checkpoint at iteration {it}")

    def writer():
        return MonitorWriter(model, settings.analysis_name, settings.out_dir,
                             period=settings.monitor_period, log=log)

    if continue_from is not None:
        state0, tuning0, key, start_it = continue_from
        batch = state0.to(device=runner.device, dtype=runner.dtype)
        tuning = torch.as_tensor(tuning0, dtype=runner.dtype, device=runner.device)
        runner.preload_trace(ckpt.load_trace(settings.analysis_name, in_dir=settings.out_dir))
        if runner.nuts is not None:
            runner.nuts.restore(ckpt.load_arrays(settings.analysis_name,
                                                 ("nuts_eps", "nuts_inv_mass"),
                                                 in_dir=settings.out_dir))
        monitor = writer().open(mode="a")
    else:
        start_it = 0
        if init_from is not None:
            # Warm start: reuse the saved batch; reuse tuning and a reduced
            # burn-in only when the cycle shape matches.
            state0, tuning0, same_cycle = init_from
            _, tuning = runner.init_chains(init)
            batch = state0.to(device=runner.device, dtype=runner.dtype)
            if batch.n_chains == 1:  # single saved chain -> broadcast
                batch, _ = runner.init_chains(batch, jitter_rates=False)
            if same_cycle and tuning0 is not None:
                tuning = torch.as_tensor(tuning0, dtype=runner.dtype, device=runner.device)
                if tuning.dim() == 1:
                    tuning = tuning.expand(settings.n_chains, -1).contiguous()
                settings.burn_in = BurnInSettings.informed()
        else:
            batch, tuning = runner.init_chains(init)
        monitor = writer().open()
        log(f"burn-in: {settings.burn_in.total} iterations")
        batch, tuning, key = runner.burn_in(batch, tuning, key)
        do_checkpoint(batch, tuning, key, 0)
    batch, tuning, key = runner.sample(batch, tuning, key, settings.iterations, monitor,
                                       start_iteration=start_it, on_checkpoint=do_checkpoint)
    do_checkpoint(batch, tuning, key, start_it + settings.iterations)
    monitor.close()
    return runner
