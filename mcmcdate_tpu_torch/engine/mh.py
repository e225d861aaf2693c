"""Metropolis-Hastings-Green sampler: the sequential sweep, auto-tuning,
burn-in schedules.

Port of ``mcmcdate_tpu/engine/mh.py`` (without the in-cycle NUTS move).  A
sweep runs the weight-expanded proposal tickets in a random order that is
drawn on the host and shared by all chains, so every ticket is one Python
dispatch on its proposal kind: no ticket reads a device value back.  Per
ticket: the proposal (plain torch over the chain axis), the prior terms
(kernel K1), the incremental whitened residual by the proposal's
likelihood class (kernel K2), the root-branch Jacobian, then accept and
select in place (kernel K3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from ..kernels.accept_select import accept_select
from ..kernels.whiten import range_rows, whiten
from ..models.dating import DatingModel
from ..models.state import FIELDS, State
from ..ops import mvn
from ..ops.dists import standard_gamma
from ..ops.heights import distances_internal, log_jacobian_root_branch
from . import proposals as props

# Tuning bounds; unbounded tuning is pathological for gamma-kernel scale
# proposals (see the JAX module).
TUNE_MIN = 1e-3
TUNE_MAX = 1e2


@dataclass
class Carry:
    """What a sweep carries per chain besides the state: the prior terms
    ``[C, T]``, the internal-layout distances ``d`` and whitened residual
    ``y`` ``[C, D]`` (None without a likelihood) and the accept counts
    ``[C, P]``."""

    batch: State
    terms: torch.Tensor
    d: Optional[torch.Tensor]
    y: Optional[torch.Tensor]
    acc: torch.Tensor


class MHKernel:
    """Sweep kernel for a model and proposal table.  Entry points take a
    chain-batched state and per-chain tuning ``[C, P]``."""

    def __init__(self, model: DatingModel, table: props.ProposalTable):
        self.model = model
        self.table = table
        kind = model.likelihood.kind
        if kind in (mvn.SPARSE, mvn.BANDED):
            raise NotImplementedError(mvn.NOT_PORTED.format(kind))
        self.use_lik = kind != mvn.NONE
        self.diag_lik = kind == mvn.UNIVARIATE
        self.rows = [None] * table.n_proposals
        if self.use_lik and not self.diag_lik:
            D = model.likelihood.dim
            dev = model.device
            d_class = table.d_class
            for p in range(table.n_proposals):
                dc = props.DC_FULL if d_class is None else int(d_class[p])
                if dc == props.DC_GATHER:
                    rows = [int(r) for r in table.didx[p]]
                elif dc in props.D_BUCKETS:
                    rows = range_rows(int(table.d_lo[p]), props.D_BUCKETS[dc], D)
                else:
                    continue
                self.rows[p] = torch.as_tensor(rows, dtype=torch.int32, device=dev)

    def _d_class(self, pidx: int) -> int:
        if self.table.d_class is None:  # hand-built tables: recompute fully
            return props.DC_FULL
        return int(self.table.d_class[pidx])

    def ticket_step(self, carry: Carry, tuning, pidx: int, draw, u_acc):
        """Run proposal row ``pidx`` on every chain with the given draws
        (the kernel's uniform or standard-gamma ``[C]`` and the accept
        uniform ``[C]``); updates ``carry`` in place and returns the
        accept mask."""
        m = self.model
        t = self.table
        kind = int(t.kind[pidx])
        state_new, log_mhg = props.KERNELS[kind](
            carry.batch, draw, tuning[:, pidx], int(t.node[pidx]), int(t.aux[pidx]),
            float(t.par[pidx]), m.topo, m.braces,
        )
        terms2 = m.log_prior_terms(state_new)
        d_lik = d_new = dy = None
        if self.use_lik:
            dc = self._d_class(pidx)
            if self.diag_lik:
                # Diagonal model: the whitening is elementwise, every class
                # collapses to one expression.
                d_new = distances_internal(state_new, m.topo)
                dy = (d_new - carry.d) * m.inv_sd_internal_t
                d_lik = -0.5 * torch.sum(dy * (2.0 * carry.y + dy), dim=-1)
            elif dc == props.DC_FULL:
                d_new = distances_internal(state_new, m.topo)
                dy, d_lik = whiten(d_new, m.chol_internal_t, sub=m.mu_internal_t, y=carry.y,
                                   minus_y=True)
            elif dc != props.DC_INV:
                d_new = distances_internal(state_new, m.topo)
                dy, d_lik = whiten(d_new - carry.d, m.chol_internal_t, rows=self.rows[pidx],
                                   y=carry.y)
        lj = None
        if t.root_jac[pidx]:
            lj = (log_jacobian_root_branch(state_new, m.topo)
                  - log_jacobian_root_branch(carry.batch, m.topo))
        return accept_select(
            carry.terms, terms2, log_mhg, u_acc, carry.batch, state_new, carry.acc, pidx,
            d_lik=d_lik, lj=lj, d=carry.d, d_new=d_new, y=carry.y, dy=dy,
        )

    def init_carry(self, batch: State) -> Carry:
        """Carried quantities of a fresh batch (a copy: sweeps update it
        in place)."""
        m = self.model
        batch = State(**{k: getattr(batch, k).clone() for k in FIELDS})
        d = y = None
        if self.use_lik:
            d = distances_internal(batch, m.topo)
            y = m.whitened_residual_internal(batch)
        acc = torch.zeros((batch.n_chains, self.table.n_proposals), dtype=torch.int32,
                          device=batch.heights.device)
        return Carry(batch, m.log_prior_terms(batch), d, y, acc)

    def lp_of(self, carry: Carry):
        """Per-chain log prior and log likelihood from the carried terms."""
        lp_pr = torch.sum(carry.terms, dim=-1)
        if carry.y is None:
            return lp_pr, torch.zeros_like(lp_pr)
        lp_lik = self.model.log_lik_const - 0.5 * torch.sum(carry.y * carry.y, dim=-1)
        return lp_pr, lp_lik

    def sweeps(self, batch: State, tuning, seed: int, n: int,
               collect: Optional[Callable] = None):
        """``n`` sweeps of the chain batch.  ``seed`` seeds the ticket order
        (drawn on the host) and the per-chain draws (drawn on the batch's
        device).  ``collect(batch, lp_pr, lp_lik) -> dict of [C, ...]``
        runs after each sweep.  Returns ``(batch, lp_pr, lp_lik, acc, tot,
        outs)`` with ``outs`` the list of per-sweep collections."""
        device = batch.heights.device
        host_gen = torch.Generator().manual_seed(seed)
        gen = torch.Generator(device=device).manual_seed(seed)
        carry = self.init_carry(batch)
        C = batch.n_chains
        outs = []
        for _ in range(n):
            self.sweep_once(carry, tuning, host_gen, gen)
            if collect is not None:
                outs.append(collect(carry.batch, *self.lp_of(carry)))
        tot = (torch.as_tensor(self.table.weight, dtype=torch.int32, device=device) * n
               ).expand(C, -1)
        return (carry.batch, *self.lp_of(carry), carry.acc, tot, outs)

    def sweep_once(self, carry: Carry, tuning, host_gen, gen):
        """One pass over the weight-expanded tickets on ``carry`` (in
        place), in an order drawn from the host generator ``host_gen``,
        with the per-chain draws from ``gen``."""
        t = self.table
        C, dtype, device = tuning.shape[0], carry.terms.dtype, carry.terms.device
        tickets = torch.as_tensor(t.tickets)
        order = tickets[torch.randperm(len(tickets), generator=host_gen)].tolist()
        u_prop = torch.rand((len(order), C), generator=gen, dtype=dtype, device=device)
        u_acc = torch.rand((len(order), C), generator=gen, dtype=dtype, device=device)
        for j, pidx in enumerate(order):
            if int(t.kind[pidx]) in props.GAMMA_KINDS:
                draw = standard_gamma(float(t.par[pidx]) / tuning[:, pidx], gen)
            else:
                draw = u_prop[j]
            self.ticket_step(carry, tuning, pidx, draw, u_acc[j])


def tune_step(tuning, acc, tot, targets, rate=1.0, tune_max=None):
    """Multiplicative tuning update toward the dimension-dependent target
    acceptance, ``t <- t * exp(rate * (acc_rate - target))``, clipped to
    ``[TUNE_MIN, tune_max]``.  Works on ``[C, P]`` or ``[P]``."""
    observed = acc / torch.clamp(tot, min=1)
    new = tuning * torch.exp(rate * (observed - targets))
    hi = TUNE_MAX if tune_max is None else tune_max
    return torch.minimum(torch.clamp(new, min=TUNE_MIN), torch.as_tensor(hi, dtype=new.dtype,
                                                                         device=new.device))


# Burn-in schedules (app/Definitions.hs:420-437).
BURN_IN_FAST = [10, 10] + list(range(10, 131, 10))
BURN_IN_SLOW = list(range(100, 401, 20))
BURN_IN_INFORMED_SLOW = [100, 100, 100, 200, 300, 400, 400]
BURN_IN_PROF_FAST = [10, 10]
BURN_IN_PROF_SLOW = [20, 20]
ITERATIONS = 8000
ITERATIONS_PROF = 50


@dataclass
class BurnInSettings:
    fast: List[int]
    slow: List[int]

    @staticmethod
    def default() -> "BurnInSettings":
        return BurnInSettings(list(BURN_IN_FAST), list(BURN_IN_SLOW))

    @staticmethod
    def informed() -> "BurnInSettings":
        return BurnInSettings([], list(BURN_IN_INFORMED_SLOW))

    @staticmethod
    def profiling() -> "BurnInSettings":
        return BurnInSettings(list(BURN_IN_PROF_FAST), list(BURN_IN_PROF_SLOW))

    @property
    def total(self) -> int:
        return sum(self.fast) + sum(self.slow)
