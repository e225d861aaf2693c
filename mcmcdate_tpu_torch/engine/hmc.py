"""NUTS on the masked flat state: the in-cycle move of ``--hamiltonian``.

Port of ``mcmcdate_tpu/engine/hmc.py``.  The free coordinates
(:class:`FlatCoords`) and the target (the prior, the tempered likelihood
and the root-branch Jacobian) are the JAX package's.  The sampler is the
same iterative multinomial NUTS with the full binary-tree stopping rule
and biased progressive sampling, batched over the chains: one host loop
over the doublings (:func:`nuts_kernel`), each doubling ``2^k`` leapfrog
steps of kernel H1 ``nuts_leapfrog_prologue``, the product ``z = r P`` and
kernel H2 ``nuts_leapfrog_epilogue``, then kernel H3 ``nuts_merge``
(``kernels/nuts_step.py``); the host reads ``stop.all()`` once a doubling,
the counterpart of the vmapped ``while_loop`` that ends when every chain
stops.  A chain that has stopped is frozen, as under vmap.  On the CPU the
kernels' plain versions run, whose gradient is ``torch.autograd``.

Every random number comes from a draws object (:class:`NutsDraws` from the
sweep's device generator, or :class:`NutsReplay` with given arrays): the
momenta's normals, and per doubling the directions, the leaves' take
uniforms and the merge uniform.  Step size adapts by dual averaging toward
0.8 acceptance, the diagonal inverse mass from the chains' variances
(:class:`NutsInCycle`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.band_matmul import band_matmul
from ..kernels.nuts_step import NutsCheck, NutsWork, nuts_consts, nuts_leapfrog_epilogue, \
    nuts_leapfrog_epilogue_plain, nuts_leapfrog_prologue, nuts_leapfrog_prologue_plain, \
    nuts_merge, nuts_merge_plain
from ..models.dating import DatingModel
from ..models.state import State
from ..ops import banded, mvn
from ..ops.heights import log_jacobian_root_branch

MAX_DEPTH = 8
TARGET_ACCEPT = 0.8


# ---------------------------------------------------------------------------
# Masked flatten / unflatten
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class FlatCoords:
    """Mapping between a batched State and the free-coordinate vectors
    ``[C, dim]``: birth, death, rate_mean, rate_var, the absolute height
    when calibrated, the non-root inner nodes' heights, the non-root
    rates (the JAX package's order)."""

    model: DatingModel
    calibrated: bool

    @property
    def height_idx(self) -> np.ndarray:
        return np.asarray([i for i in self.model.topo.inner_nodes if i != 0], np.int32)

    @property
    def rate_idx(self) -> np.ndarray:
        return np.arange(1, self.model.topo.n, dtype=np.int32)

    @property
    def off_h(self) -> int:
        return 4 + int(self.calibrated)

    @property
    def off_r(self) -> int:
        return self.off_h + len(self.height_idx)

    @property
    def dim(self) -> int:
        return self.off_r + len(self.rate_idx)

    def _idx(self, device):
        cache = self.__dict__.setdefault("_idx_cache", {})
        if device not in cache:
            cache[device] = tuple(torch.as_tensor(a.astype(np.int64), device=device)
                                  for a in (self.height_idx, self.rate_idx))
        return cache[device]

    def to_vector(self, state: State):
        hi, ri = self._idx(state.heights.device)
        parts = [state.birth[:, None], state.death[:, None], state.rate_mean[:, None],
                 state.rate_var[:, None]]
        if self.calibrated:
            parts.append(state.height[:, None])
        parts += [state.heights.index_select(1, hi), state.rates.index_select(1, ri)]
        return torch.cat(parts, dim=1)

    def from_vector(self, state: State, v) -> State:
        """A new State: ``state`` with its free coordinates from ``v``
        (differentiable in ``v``)."""
        hi, ri = self._idx(state.heights.device)
        o, r = self.off_h, self.off_r
        return state.replace(
            birth=v[:, 0], death=v[:, 1], rate_mean=v[:, 2], rate_var=v[:, 3],
            height=v[:, 4] if self.calibrated else state.height,
            heights=state.heights.index_copy(1, hi, v[:, o:r]),
            rates=state.rates.index_copy(1, ri, v[:, r:]))

    def write_vector(self, state: State, v) -> None:
        """Set ``state``'s free coordinates from ``v``, in place."""
        hi, ri = self._idx(state.heights.device)
        o, r = self.off_h, self.off_r
        for k, name in enumerate(("birth", "death", "rate_mean", "rate_var")):
            getattr(state, name).copy_(v[:, k])
        if self.calibrated:
            state.height.copy_(v[:, 4])
        state.heights.index_copy_(1, hi, v[:, o:r])
        state.rates.index_copy_(1, ri, v[:, r:])


def make_log_density(model: DatingModel, coords: FlatCoords, template: State, beta=1.0):
    """The plain log target ``f(v) -> [C]`` on free-coordinate vectors
    ``[C, dim]``, including the root-branch Jacobian (HTarget); NaN maps to
    -inf.  ``beta`` (a number or ``[C]``) tempers the likelihood."""

    def f(v):
        s = coords.from_vector(template, v)
        lp = model.log_prior(s) + beta * model.log_likelihood(s)
        lp = lp + log_jacobian_root_branch(s, model.topo)
        return torch.where(torch.isnan(lp), -math.inf, lp)

    return f


def value_and_grad(f, v):
    """``(f(v), grad f(v))`` per chain by ``torch.autograd``."""
    with torch.enable_grad():
        x = v.detach().requires_grad_(True)
        y = f(x)
        g, = torch.autograd.grad(y.sum(), x)
    return y.detach(), g


def _leapfrog(grad_fn, inv_mass, eps, q, p, g):
    p_half = p + 0.5 * eps * g
    q_new = q + eps * inv_mass * p_half
    g_new = grad_fn(q_new)
    p_new = p_half + 0.5 * eps * g_new
    return q_new, p_new, g_new


# ---------------------------------------------------------------------------
# NUTS
# ---------------------------------------------------------------------------


class NutsDraws:
    """A trajectory's random numbers from ``gen``: the momenta's normals
    ``[C, dim]``, then per doubling one ``[C, 2 + 2^k]`` uniform call (the
    direction, the merge uniform, the leaves' take uniforms)."""

    def __init__(self, gen: torch.Generator, C: int, dim: int, dtype, device):
        self.gen, self.C, self.dim, self.dtype, self.device = gen, C, dim, dtype, device

    def momenta(self):
        return torch.randn((self.C, self.dim), generator=self.gen, dtype=self.dtype,
                           device=self.device)

    def doubling(self, k: int):
        """``(go_right [C] bool, u_leaf [C, 2^k], u_merge [C])``."""
        u = torch.rand((self.C, 2 + 2 ** k), generator=self.gen, dtype=self.dtype,
                       device=self.device)
        return u[:, 0] < 0.5, u[:, 2:], u[:, 1]


class NutsReplay:
    """Given random numbers: ``normals`` ``[C, dim]``, ``go_right`` ``[C,
    max_depth]`` bool, ``u_leaf`` ``[C, max_depth, 2^(max_depth-1)]`` and
    ``u_merge`` ``[C, max_depth]`` (tensors on the chains' device)."""

    def __init__(self, normals, go_right, u_leaf, u_merge):
        self.normals, self.go_right, self.u_leaf, self.u_merge = normals, go_right, u_leaf, u_merge

    def momenta(self):
        return self.normals

    def doubling(self, k: int):
        return (self.go_right[:, k].contiguous(), self.u_leaf[:, k, :2 ** k].contiguous(),
                self.u_merge[:, k].contiguous())


class NutsMove:
    """One batched NUTS trajectory per chain through H1, the product, H2
    and H3, with the buffers of the last chain count kept."""

    def __init__(self, model: DatingModel, max_depth: Optional[int] = None):
        self.model = model
        self.max_depth = MAX_DEPTH if max_depth is None else max_depth
        self.coords = FlatCoords(model, model.calibrations_available)
        self.nc = nuts_consts(model, self.coords)
        kind = model.likelihood.kind
        self.P = self.P3 = None
        if kind == mvn.BANDED:
            pband = banded.pband_from_chol_upper(model.likelihood.band_chol)
            wb = model.band_L3_internal_t.shape[2]
            self.P3 = torch.as_tensor(banded.blocks_from_sym_band(pband, wb), dtype=model.dtype,
                                      device=model.device)
        elif kind in (mvn.FULL, mvn.SPARSE):
            perm = model.topo.ref_to_internal_perm
            prec = np.asarray(model.likelihood.precision, np.float64)[np.ix_(perm, perm)]
            self.P = torch.as_tensor(prec, dtype=model.dtype, device=model.device)
        self._work: Optional[NutsWork] = None

    def work(self, C: int, dtype, device) -> NutsWork:
        w = self._work
        if w is None or w.C != C or w.q_new.dtype != dtype or w.q_new.device != device:
            m = self.model
            w = self._work = NutsWork(C, self.coords.dim, m.topo.n, m.likelihood.dim,
                                      self.nc.n_slots, self.max_depth, dtype, device)
        return w

    def product(self, w: NutsWork) -> None:
        """``z = r P``: one ``torch.mm`` (full and sparse kinds) or one B1
        launch (banded); nothing under the univariate kind (H2 forms ``z``)
        or without a likelihood."""
        if self.P is not None:
            torch.mm(w.r, self.P, out=w.z)
        elif self.P3 is not None:
            w.z.copy_(band_matmul(w.r, self.P3)[0])

    def trajectory(self, state: State, q0, eps: float, inv_mass, draws, beta_lik=None,
                   beta_prior=None, check: Optional[NutsCheck] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One trajectory per chain from ``q0`` ``[C, dim]`` (``state`` holds
        the fixed coordinates).  Returns ``(q', accept_stat, n_steps)``, the
        proposal a view of the work buffers.  With ``check`` every launch
        is also run through its plain version (:class:`NutsCheck`)."""
        C = q0.shape[0]
        dt, dev = q0.dtype, q0.device
        w = self.work(C, dt, dev)
        ones = torch.ones(C, dtype=dt, device=dev)
        bl = ones if beta_lik is None else torch.as_tensor(beta_lik, dtype=dt, device=dev
                                                           ).expand(C).contiguous()
        bp = ones if beta_prior is None else torch.as_tensor(beta_prior, dtype=dt, device=dev
                                                             ).expand(C).contiguous()
        inv_mass = torch.as_tensor(inv_mass, dtype=dt, device=dev).contiguous()
        args = (self.nc, w, state, eps, inv_mass, bl, bp)

        def launch(which, kernel, plain, *a, u=None, **kw):
            if check is None:
                kernel(*a, **kw)
            else:
                check.run(which, lambda: kernel(*a, **kw), lambda: plain(*a, **kw), u,
                          kw.get("leaf", 0), kw.get("dirs"), inv_mass)

        pro = ("prologue", nuts_leapfrog_prologue, nuts_leapfrog_prologue_plain)
        epi = ("epilogue", nuts_leapfrog_epilogue, nuts_leapfrog_epilogue_plain)
        w.q_new.copy_(q0)
        launch(*pro, *args, normals=draws.momenta())
        self.product(w)
        launch(*epi, *args)
        for k in range(self.max_depth):
            dirs, u_leaf, u_merge = draws.doubling(k)
            for i in range(2 ** k):
                launch(*pro, *args, dirs=dirs)
                self.product(w)
                launch(*epi, *args, dirs=dirs, u_leaf=u_leaf[:, i], leaf=i, u=u_leaf[:, i])
            launch("merge", nuts_merge, nuts_merge_plain, w, inv_mass, u_merge)
            if bool(w.stop.all()):
                break
        astat = w.sum_acc / torch.clamp(w.n_steps, min=1).to(dt)
        return w.q_prop, astat, w.n_steps


def nuts_kernel(model: DatingModel, max_depth: Optional[int] = None):
    """Returns ``step(state, q0, eps, inv_mass, draws, beta_lik=None,
    beta_prior=None) -> (q', accept_stat, n_steps)``, every ``[C, ...]``:
    the JAX package's ``nuts_kernel`` batched over the chains, on the
    target ``beta_prior log prior + beta_lik log L + log Jacobian`` with
    the fixed coordinates from ``state`` (``max_depth`` None:
    :data:`MAX_DEPTH`)."""
    mv = NutsMove(model, max_depth)

    def step(state, q0, eps, inv_mass, draws, beta_lik=None, beta_prior=None):
        q, a, n = mv.trajectory(state, q0, eps, inv_mass, draws, beta_lik, beta_prior)
        return q.clone(), a, n.clone()

    return step


def make_in_cycle_move(model: DatingModel, max_depth: Optional[int] = None):
    """NUTS as an in-cycle move, once per sweep (Definitions.hs:274-278).

    Returns ``(move, coords)``: ``move(batch, gen, eps, inv_mass,
    beta_lik=None, beta_prior=None, draws=None) -> accept_stat [C]`` runs
    one trajectory per chain and writes the proposals into ``batch`` in
    place; ``beta_lik`` and ``beta_prior`` are numbers or ``[C]`` vectors
    (None: 1), the draws come from ``gen`` unless ``draws`` is given;
    ``max_depth`` None: :data:`MAX_DEPTH`."""
    mv = NutsMove(model, max_depth)
    coords = mv.coords

    def move(batch: State, gen, eps, inv_mass, beta_lik=None, beta_prior=None, draws=None):
        q0 = coords.to_vector(batch)
        if draws is None:
            draws = NutsDraws(gen, q0.shape[0], coords.dim, q0.dtype, q0.device)
        q, astat, _ = mv.trajectory(batch, q0, float(eps), inv_mass, draws, beta_lik,
                                    beta_prior)
        coords.write_vector(batch, q)
        return astat

    return move, coords


# ---------------------------------------------------------------------------
# Adaptation
# ---------------------------------------------------------------------------


@dataclass
class DualAveraging:
    """Nesterov dual averaging of log step size (Hoffman & Gelman 2014)."""

    mu: float
    log_eps_bar: float = 0.0
    h_bar: float = 0.0
    count: int = 0
    gamma: float = 0.05
    t0: float = 10.0
    kappa: float = 0.75

    @staticmethod
    def init(eps0: float) -> "DualAveraging":
        return DualAveraging(mu=float(np.log(10.0 * eps0)))

    def update(self, accept_stat: float) -> Tuple[float, "DualAveraging"]:
        c = self.count + 1
        eta = 1.0 / (c + self.t0)
        h_bar = (1 - eta) * self.h_bar + eta * (TARGET_ACCEPT - accept_stat)
        log_eps = self.mu - np.sqrt(c) / self.gamma * h_bar
        w = c ** (-self.kappa)
        log_eps_bar = w * log_eps + (1 - w) * self.log_eps_bar
        new = DualAveraging(self.mu, log_eps_bar, h_bar, c, self.gamma, self.t0, self.kappa)
        return float(np.exp(log_eps)), new

    @property
    def final_eps(self) -> float:
        return float(np.exp(self.log_eps_bar))


class NutsInCycle:
    """Host-side adaptation around :func:`make_in_cycle_move`: the step
    size adapts by dual averaging toward 0.8 acceptance in the burn-in
    windows, the diagonal inverse mass from the chains' coordinate
    variances (HTuneLeapfrog + HTuneAllMasses, Hamiltonian.hs:62-63)."""

    def __init__(self, model: DatingModel, dtype=torch.float32):
        self.model = model
        self.move, self.coords = make_in_cycle_move(model)
        self.dtype = dtype
        self.eps = 0.01
        self.da = DualAveraging.init(self.eps)
        self.inv_mass = np.ones(self.coords.dim)

    def params(self):
        return (float(self.eps),
                torch.as_tensor(self.inv_mass, dtype=self.dtype, device=self.model.device))

    def adapt(self, accept_stat: float, warmup_vectors=None):
        self.eps, self.da = self.da.update(accept_stat)
        if warmup_vectors is not None and len(warmup_vectors) >= 4:
            self.inv_mass = np.var(np.asarray(warmup_vectors), axis=0) + 1e-6

    def finalize_adaptation(self):
        self.eps = self.da.final_eps

    def __call__(self, batch: State, gen, beta_lik=None, beta_prior=None):
        """One in-cycle move of ``batch`` (in place) at the current
        parameters; returns the acceptance statistics ``[C]``."""
        return self.move(batch, gen, *self.params(), beta_lik, beta_prior)

    # -- checkpoint plumbing -------------------------------------------

    def state_arrays(self) -> dict:
        return {"nuts_eps": np.asarray(self.eps), "nuts_inv_mass": np.asarray(self.inv_mass)}

    def restore(self, arrays: dict):
        if "nuts_eps" in arrays:
            self.eps = float(arrays["nuts_eps"])
            self.da = DualAveraging.init(self.eps)
        if "nuts_inv_mass" in arrays:
            self.inv_mass = np.asarray(arrays["nuts_inv_mass"])


class NUTSProposal(NutsInCycle):
    """NUTS as an extra move in the sampling loop (weight 1 in the cycle,
    Definitions.hs:276-278) at likelihood temperature ``beta``: the
    in-cycle move and its adaptation, stepped on its own."""

    def __init__(self, model: DatingModel, settings=None, beta=1.0):
        super().__init__(model)
        self.beta = beta

    def build(self, template: State):
        self.dtype = template.heights.dtype
        return self

    def step(self, batch: State, gen) -> float:
        """One move of ``batch`` in place; returns the mean acceptance
        statistic."""
        return float(self(batch, gen, beta_lik=self.beta).mean())
