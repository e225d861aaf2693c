"""Metropolis-Hastings-Green sampler: the sequential sweep, auto-tuning,
burn-in schedules.

Port of ``mcmcdate_tpu/engine/mh.py``, with the in-cycle NUTS move after
each sweep (``sweeps(nuts=)``, ``engine/hmc.py``).  A
sweep runs the weight-expanded proposal tickets in a random order that is
drawn on the host and shared by all chains, so the host splits the order
into runs from the table's static likelihood classes without reading any
device value back.  A run of tickets whose likelihood update is local (all
of them without a likelihood or under the univariate kind; under a full MVN
the distance-invariant and gather classes; under the banded kind the
distance-invariant class) is one launch of T3 ``ticket_scan``; a full-MVN
ticket of the dense or range classes is T1 ``ticket_prologue``, K2
``whiten`` for its ``dy`` and K3 ``accept_select``
(``kernels/ticket_step.py``, ``kernels/accept_select.py``), and under the
banded kind every ticket that moves distances is T1, B1 ``band_matmul``
(``dy = delta L`` over the blocks its rows reach) and K3.  The draws come
per chunk of at most ``CHUNK`` tickets: one uniform call for the
proposals, one for the accepts and one standard-gamma call over the
chunk's gamma tickets.  No ticket recomputes the prior terms whole: the
sweep carries them, with each chain's count of NaN or -inf terms (the JAX
package's invalid rule reads the whole new term vector), each chain's
likelihood temperature ``beta``, which tempers the likelihood delta of
every decision (``MHKernel.sweeps(beta=)``; the stepping-stone ladder),
and each chain's prior temperature ``beta_prior``, which tempers the prior
delta (``sweeps(beta_prior=)``; MC3's ladder, ``engine/mc3.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from ..kernels.accept_select import accept_select
from ..kernels.band_matmul import band_matmul
from ..kernels.ticket_step import CHUNK, LIK_FULL, TicketDraws, TicketTable, count_bad, \
    ticket_prologue, ticket_scan
from ..kernels.whiten import range_rows, whiten
from ..models.dating import DatingModel
from ..models.state import FIELDS, State
from ..ops import banded
from ..ops.dists import standard_gamma
from ..ops.heights import distances_internal
from . import proposals as props

# Tuning bounds; unbounded tuning is pathological for gamma-kernel scale
# proposals (see the JAX module).
TUNE_MIN = 1e-3
TUNE_MAX = 1e2


@dataclass
class Carry:
    """What a sweep carries per chain besides the state: the prior terms
    ``[C, T]``, the internal-layout distances ``d`` and whitened residual
    ``y`` ``[C, D]`` (None without a likelihood), the accept counts
    ``[C, P]``, the number of NaN or -inf terms ``nbad`` (int32 ``[C]``;
    counted at the sweep's start where None), and the likelihood and prior
    temperatures ``beta`` and ``beta_prior`` ``[C]`` of every decision
    (None: 1)."""

    batch: State
    terms: torch.Tensor
    d: Optional[torch.Tensor]
    y: Optional[torch.Tensor]
    acc: torch.Tensor
    nbad: Optional[torch.Tensor] = None
    beta: Optional[torch.Tensor] = None
    beta_prior: Optional[torch.Tensor] = None


def chain_beta(beta, C: int, dtype, device) -> torch.Tensor:
    """The per-chain temperature ``[C]`` (likelihood or prior) of ``beta``:
    None (a ones vector), a number, or a ``[C]`` tensor; in ``dtype`` on
    ``device``."""
    if beta is None:
        return torch.ones(C, dtype=dtype, device=device)
    beta = torch.as_tensor(beta, dtype=dtype, device=device)
    if beta.dim() == 0:
        return beta.expand(C).contiguous()
    if beta.shape != (C,):
        raise ValueError(f"beta must be a number or [{C}], got {tuple(beta.shape)}")
    return beta.contiguous()


class MHKernel:
    """Sweep kernel for a model and proposal table.  Entry points take a
    chain-batched state and per-chain tuning ``[C, P]``."""

    def __init__(self, model: DatingModel, table: props.ProposalTable):
        self.model = model
        self.table = table
        self.tt = TicketTable(model, table)
        self.use_lik = self.tt.lik != 0
        # K2's row lists of the full-MVN gather and range classes (int32).
        self.rows = [None] * table.n_proposals
        # B1's output blocks of a banded ticket: those its class rows reach.
        self.band_win = None
        if self.tt.banded:
            nb, _, wb, _ = model.band_L3_internal.shape
            self.band_win = [banded.block_window(int(lo), int(hi), wb, nb, upper=True)
                             for lo, hi in self.tt.band_rows]
        elif self.tt.lik == LIK_FULL:
            D = model.likelihood.dim
            for p in range(table.n_proposals):
                dc = int(self.tt.d_class[p])
                if dc == props.DC_GATHER:
                    rows = [int(r) for r in self.tt.didx[p]]
                elif dc in props.D_BUCKETS:
                    rows = range_rows(int(self.tt.d_lo[p]), props.D_BUCKETS[dc], D)
                else:
                    continue
                self.rows[p] = torch.as_tensor(rows, dtype=torch.int32, device=model.device)
        self.par = np.asarray(table.par, np.float64)

    def _k2(self, carry: Carry, pidx: int, pro):
        """K2's ``(dy, d_lik)`` of a full-MVN ticket, B1's under the banded
        kind (None, None for ``DC_INV``)."""
        m = self.model
        dc = int(self.tt.d_class[pidx])
        if self.tt.lik != LIK_FULL or dc == props.DC_INV:
            return None, None
        if self.tt.banded:
            return band_matmul(pro.delta, m.band_L3_internal_t, window=self.band_win[pidx],
                               y=carry.y, upper=True, x_rows=self.tt.band_rows[pidx])
        if dc == props.DC_FULL:
            return whiten(pro.d_new, m.chol_internal_t, sub=m.mu_internal_t, y=carry.y,
                          minus_y=True)
        return whiten(pro.delta, m.chol_internal_t, rows=self.rows[pidx], y=carry.y)

    def _one(self, carry: Carry, tuning, dr: TicketDraws, j: int):
        """Ticket ``j`` of ``dr`` alone: T1, K2 where the row needs it, K3.
        Returns the accept mask."""
        pidx = int(dr.order_host[j])
        pro = ticket_prologue(self.tt, carry, tuning, dr, j)
        dy, d_lik = self._k2(carry, pidx, pro)
        return accept_select(self.tt, carry, tuning, dr, j, pro, dy, d_lik)

    def ticket_step(self, carry: Carry, tuning, pidx: int, draw, u_acc):
        """Run proposal row ``pidx`` on every chain with the given draws
        (the kernel's uniform or standard-gamma ``[C]`` and the accept
        uniform ``[C]``); updates ``carry`` in place and returns the
        accept mask."""
        if carry.nbad is None:
            carry.nbad = count_bad(carry.terms)
        return self._one(carry, tuning, TicketDraws.single(pidx, draw, u_acc), 0)

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
        terms = m.log_prior_terms(batch)
        return Carry(batch, terms, d, y, acc, count_bad(terms))

    def lp_of(self, carry: Carry):
        """Per-chain log prior and log likelihood from the carried terms."""
        lp_pr = torch.sum(carry.terms, dim=-1)
        if carry.y is None:
            return lp_pr, torch.zeros_like(lp_pr)
        lp_lik = self.model.log_lik_const - 0.5 * torch.sum(carry.y * carry.y, dim=-1)
        return lp_pr, lp_lik

    def sweeps(self, batch: State, tuning, seed: int, n: int,
               collect: Optional[Callable] = None, beta=None, nuts=None, beta_prior=None):
        """``n`` sweeps of the chain batch.  ``seed`` seeds the ticket order
        (drawn on the host) and the per-chain draws (drawn on the batch's
        device).  ``collect(batch, lp_pr, lp_lik) -> dict of [C, ...]``
        runs after each sweep.  ``beta`` and ``beta_prior`` temper the
        likelihood and the prior in every decision (``log alpha =
        beta_prior d_pr + beta d_lik + lmhg + lj``, the JAX step's
        ``engine/mh.py:194``; the root Jacobian and the proposal ratio are
        not tempered): each a number or a per-chain ``[C]`` vector (None:
        1).  ``lp_pr`` and ``lp_lik`` are untempered.  Returns ``(batch, lp_pr,
        lp_lik, acc, tot, outs)`` with ``outs`` the list of per-sweep
        collections, and with ``nuts`` (a :class:`~.hmc.NutsInCycle`: the
        in-cycle NUTS move after each sweep, every chain at its
        temperatures) a seventh element, the move's acceptance statistics
        ``[n, C]``."""
        device = batch.heights.device
        host_gen = torch.Generator().manual_seed(seed)
        gen = torch.Generator(device=device).manual_seed(seed)
        carry = self.init_carry(batch)
        C = batch.n_chains
        carry.beta = chain_beta(beta, C, batch.heights.dtype, device)
        # None stays None: the kernels read a cached ones vector, the plain
        # versions skip the product.
        carry.beta_prior = (None if beta_prior is None
                            else chain_beta(beta_prior, C, batch.heights.dtype, device))
        outs, astats = [], []
        for _ in range(n):
            self.sweep_once(carry, tuning, host_gen, gen)
            if nuts is not None:
                astats.append(self.nuts_phase(carry, nuts, gen))
            if collect is not None:
                outs.append(collect(carry.batch, *self.lp_of(carry)))
        tot = (torch.as_tensor(self.table.weight, dtype=torch.int32, device=device) * n
               ).expand(C, -1)
        ret = (carry.batch, *self.lp_of(carry), carry.acc, tot, outs)
        return ret if nuts is None else ret + (torch.stack(astats),)

    def nuts_phase(self, carry: Carry, nuts, gen):
        """The in-cycle NUTS move after a sweep, then the carried terms
        (K1), distances and whitened residual rebuilt from the moved state
        (one full recompute a sweep, as the JAX package does).  Returns the
        acceptance statistics ``[C]``."""
        m = self.model
        astat = nuts(carry.batch, gen, beta_lik=carry.beta, beta_prior=carry.beta_prior)
        carry.terms = m.log_prior_terms(carry.batch)
        carry.nbad = count_bad(carry.terms)
        if carry.y is not None:
            carry.d = distances_internal(carry.batch, m.topo)
            carry.y = m.whitened_residual_internal(carry.batch)
        return astat

    def draws(self, order: np.ndarray, tuning, gen) -> TicketDraws:
        """The draws of ``order``'s tickets: two ``[C, n]`` uniform calls
        (proposals, accepts) and one standard-gamma call over the gamma
        tickets, whose shapes ``par / tune`` come from one gather."""
        C, dtype, device = tuning.shape[0], tuning.dtype, tuning.device
        n = len(order)
        gcols = np.nonzero(self.tt.gamma[order])[0]
        gidx_host = np.full(n, -1, np.int32)
        gidx_host[gcols] = np.arange(len(gcols), dtype=np.int32)
        # T3's windows (the card only: the plain versions take one ticket at
        # a time), in the same copy.
        lead = self.tt.windows(order) if device.type == "cuda" else np.ones(n, np.int32)
        host = np.concatenate([order, gidx_host, lead, order[gcols]]).astype(np.int32)
        dev = torch.as_tensor(host, device=device)
        u = torch.rand((C, n), generator=gen, dtype=dtype, device=device)
        u_acc = torch.rand((C, n), generator=gen, dtype=dtype, device=device)
        g = None
        if len(gcols):
            par = torch.as_tensor(self.par[order[gcols]], dtype=dtype, device=device)
            g = standard_gamma(par / tuning.index_select(1, dev[3 * n:]), gen)
        return TicketDraws(order, dev[:n], u, g, gidx_host, dev[n:2 * n], u_acc,
                           dev[2 * n:3 * n] if device.type == "cuda" else None)

    def sweep_once(self, carry: Carry, tuning, host_gen, gen, given=None):
        """One pass over the weight-expanded tickets on ``carry`` (in
        place), in an order drawn from the host generator ``host_gen``, with
        the per-chain draws from ``gen``, in chunks of at most ``CHUNK``
        tickets.  ``given = (order, draws, u_acc)`` replaces the order
        (table rows ``[n]``) and the draws (each ticket's uniform or
        standard-gamma draw and its accept uniform, ``[C, n]``).  The
        decisions take the temperatures ``carry.beta`` and
        ``carry.beta_prior``."""
        if carry.nbad is None:
            carry.nbad = count_bad(carry.terms)
        if given is not None:
            order, draws, u_acc = given
            order = np.asarray(order, np.int32)
        else:
            order = np.asarray(self.table.tickets, np.int32)[
                torch.randperm(self.table.n_tickets, generator=host_gen).numpy()]
        for c0 in range(0, len(order), CHUNK):
            part = order[c0:c0 + CHUNK]
            if given is None:
                dr = self.draws(part, tuning, gen)
            else:
                sl = slice(c0, c0 + len(part))
                dev = torch.as_tensor(np.concatenate([part, self.tt.windows(part)]),
                                      device=tuning.device)
                dr = TicketDraws(part, dev[:len(part)], draws[:, sl].contiguous(), None, None,
                                 None, u_acc[:, sl].contiguous(), dev[len(part):])
            for j0, nj, run in self.tt.segments(part):
                self.segment(carry, tuning, dr, j0, nj, run)

    def segment(self, carry: Carry, tuning, dr: TicketDraws, j0: int, nj: int, run: bool):
        """Tickets ``j0 .. j0+nj`` of ``dr``: a run (T3), or one ticket that
        breaks a run (T1, K2, K3)."""
        if run:
            ticket_scan(self.tt, carry, tuning, dr, j0, nj)
        else:
            self._one(carry, tuning, dr, j0)


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
