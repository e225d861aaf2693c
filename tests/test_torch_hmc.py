"""The port's NUTS pieces against the JAX package's ``engine/hmc.py`` on the
CPU at float64: ``FlatCoords`` both ways, the plain target and its
gradient (``torch.autograd``) against ``jax.grad`` of ``make_log_density``
for the five clocks and the full, univariate, banded and none kinds (with
a near-critical chain and an invalid one), ``DualAveraging``, and one
leapfrog step through the H1 → product → H2 wrappers' CPU path (their
plain versions) against ``_leapfrog`` and the log density."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcdate_tpu.engine import hmc as jhmc
from mcmcdate_tpu.models import DatingModel as JModel, init_state as j_init
from mcmcdate_tpu.models.state import State as JState
from mcmcdate_tpu.ops import heights as JH, mvn as jmvn
from mcmcdate_tpu.tree import FlatTopology
from mcmcdate_tpu.utils.simulate import random_ultrametric_tree
from mcmcdate_tpu_torch.engine import hmc
from mcmcdate_tpu_torch.kernels import nuts_step as NS
from mcmcdate_tpu_torch.models import from_numpy
from mcmcdate_tpu_torch.ops import banded as tb, clocks
from torch_fast_common import close, likelihood, node_priors

LEAVES = 10
C = 6
KINDS = ("full", "uni", "banded", "none")


def _banded(rng, topo, d0):
    """A banded likelihood (bandwidth 3) estimated from samples around
    ``d0``, in both packages."""
    k = topo.n - 2
    perm = topo.ref_to_internal_perm
    xs = d0[perm] * rng.uniform(0.9, 1.1, size=k) + 0.02 * rng.normal(size=(40, k))
    mu_int, band, log_det = tb.estimate_banded_chol(xs, 3)
    mu = np.empty(k)
    mu[perm] = mu_int
    return jmvn.LikelihoodData.banded(mu, band, log_det, perm)


class Fix:
    """One model in both packages and a perturbed chain batch: with
    ``critical`` the last chain is near-critical (λ - μ = 1e-8 λ), with
    ``invalid`` its last inner node sits above its parent.  The JAX model
    takes an absent calibration bound as 1e300 instead of +inf (the same
    values): the JAX gradient in the absolute height is NaN with +inf
    (ROADMAP.md Queue 3), the port's is not."""

    def __init__(self, kind="full", clock=clocks.UNCORRELATED_GAMMA, priors=False, seed=5,
                 invalid=False, critical=True):
        rng = np.random.default_rng(seed)
        tree = random_ultrametric_tree(rng, LEAVES)
        topo = FlatTopology.from_tree(tree)
        self.topo = topo
        s0 = j_init(tree, topo)
        d0 = np.asarray(JH.distances_from_state(s0, topo))
        data = _banded(rng, topo, d0) if kind == "banded" else likelihood(kind, topo, d0, rng)
        kw = dict(clock=clock)
        jkw = dict(kw)
        if priors:
            kw.update(zip(("calibrations", "constraints", "braces"), node_priors(topo)))
            cal = kw["calibrations"]
            jkw.update(kw, calibrations=dataclasses.replace(
                cal, upper=np.where(np.isfinite(cal.upper), cal.upper, 1e300)))
        self.jm = JModel(topo=topo, likelihood=data, mean_root_height=1.2, **jkw)
        h = np.asarray(s0.heights)[None].repeat(C, 0) * rng.uniform(0.9, 1.0, size=(C, 1))
        h[:, 0] = 1.0
        h[:, topo.is_leaf] = 0.0
        st = dict(heights=h, rates=rng.gamma(20.0, 0.05, size=(C, topo.n)),
                  birth=rng.uniform(0.5, 2, C), death=rng.uniform(0.1, 1, C),
                  height=rng.uniform(1.0, 1.4, C), rate_mean=rng.uniform(0.8, 1.2, C),
                  rate_var=rng.uniform(0.05, 0.5, C))
        if critical:
            st["death"][-1] = st["birth"][-1] * (1.0 - 1e-8)
        if invalid:
            a = [int(i) for i in topo.inner_nodes if i][-1]
            st["heights"][-1, a] = st["heights"][-1, topo.parent[a]] + 0.01
        self.state = st
        self.pm, self.ps = from_numpy(topo, data, st, mean_root_height=1.2, device="cpu", **kw)
        self.coords = hmc.FlatCoords(self.pm, self.pm.calibrations_available)
        self.jcoords = jhmc.FlatCoords(self.jm, self.jm.calibrations_available)

    def jstate(self):
        return JState(**{k: jnp.asarray(v) for k, v in self.state.items()})

    def q0(self):
        return self.coords.to_vector(self.ps)


@functools.lru_cache(maxsize=None)
def fix(kind="full", clock=clocks.UNCORRELATED_GAMMA, priors=False, invalid=False,
        critical=True):
    return Fix(kind, clock, priors, invalid=invalid, critical=critical)


def jax_value_grad(f, beta=1.0):
    """The JAX target's value and ``jax.grad`` per chain at the port's
    coordinates (each chain's fixed coordinates its own)."""

    def one(s, v, b):
        lp = jhmc.make_log_density(f.jm, f.jcoords, s, b)
        return lp(v), jax.grad(lp)(v)

    b = jnp.broadcast_to(jnp.asarray(beta, jnp.float64), (C,))
    return jax.jit(jax.vmap(one))(f.jstate(), jnp.asarray(f.q0().numpy()), b)


@pytest.mark.parametrize("priors", [False, True])
def test_flat_coords_match_jax(priors):
    f = fix("full", priors=priors)
    assert f.coords.dim == f.jcoords.dim
    assert f.coords.calibrated == priors
    v = f.q0()
    close(v, jax.vmap(f.jcoords.to_vector)(f.jstate()), tol=0)
    v2 = v + 0.01 * torch.arange(v.numel(), dtype=v.dtype).reshape(v.shape) / v.numel()
    back = f.coords.from_vector(f.ps, v2)
    jback = jax.vmap(f.jcoords.from_vector)(f.jstate(), jnp.asarray(v2.numpy()))
    for k in f.state:
        close(getattr(back, k), getattr(jback, k), tol=0)
    close(f.coords.to_vector(back), v2, tol=0)
    s = type(f.ps)(**{k: getattr(f.ps, k).clone() for k in f.state})
    f.coords.write_vector(s, v2)
    for k in f.state:
        close(getattr(s, k), getattr(back, k), tol=0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("clock", clocks.MODELS)
def test_target_and_gradient_match_jax(kind, clock):
    """Value and gradient at rtol 1e-10 of each chain's scale, with a
    tempered likelihood (β per chain) and, under the full kind and the
    default clock, the node priors too."""
    f = fix(kind, clock, priors=kind == "full" and clock == clocks.UNCORRELATED_GAMMA)
    beta = np.linspace(0.2, 1.0, C)
    jv, jg = jax_value_grad(f, beta)
    tgt = hmc.make_log_density(f.pm, f.coords, f.ps, torch.as_tensor(beta))
    v, g = hmc.value_and_grad(tgt, f.q0())
    assert np.isfinite(np.asarray(jv)).all() and torch.isfinite(g).all()
    close(v, jv)
    for c in range(C):
        close(g[c], jg[c])


def test_invalid_chain_target_is_minus_inf():
    """A chain with a negative branch: -inf in both packages, and the
    other chains' values and gradients unchanged."""
    f = fix("full", invalid=True)
    jv, jg = jax_value_grad(f)
    v, g = hmc.value_and_grad(hmc.make_log_density(f.pm, f.coords, f.ps), f.q0())
    assert float(v[-1]) == float(jv[-1]) == -np.inf
    close(v[:-1], jv[:-1])
    for c in range(C - 1):
        close(g[c], jg[c])


def test_dual_averaging_matches_jax():
    a, b = hmc.DualAveraging.init(0.01), jhmc.DualAveraging.init(0.01)
    for stat in (0.1, 0.95, 0.5, 0.8, 0.0, 1.0, 0.66):
        ea, a = a.update(stat)
        eb, b = b.update(stat)
        assert ea == eb
        assert (a.mu, a.log_eps_bar, a.h_bar, a.count) == (b.mu, b.log_eps_bar, b.h_bar,
                                                           b.count)
    assert a.final_eps == b.final_eps


@pytest.mark.parametrize("kind", KINDS)
def test_leapfrog_step_matches_jax(kind):
    """H1 → product → H2 (the wrappers' CPU path) for one step in each
    chain's direction from an init, against ``_leapfrog`` with
    ``jax.grad`` and the log density at ``q'``, β_lik and β_prior per
    chain.  No near-critical chain: a step takes it just out of the
    series' range, where the standard formula's derivatives in λ and μ
    lose about 1e-9 of their scale to rounding (a condition number of
    λ / |λ - μ|) in either package."""
    f = fix(kind, priors=kind == "full", critical=False)
    rng = np.random.default_rng(11)
    mv = hmc.NutsMove(f.pm)
    q0 = f.q0()
    dim = f.coords.dim
    inv_mass = torch.as_tensor(rng.uniform(0.5, 2.0, dim) * 1e-3)
    normals = torch.as_tensor(rng.normal(size=(C, dim)))
    bl = torch.as_tensor(np.linspace(0.3, 1.0, C))
    bp = torch.as_tensor(np.linspace(1.0, 0.5, C))
    dirs = torch.as_tensor(rng.uniform(size=C) < 0.5)
    eps = 0.02
    w = mv.work(C, q0.dtype, q0.device)
    args = (mv.nc, w, f.ps, eps, inv_mass, bl, bp)
    w.q_new.copy_(q0)
    NS.nuts_leapfrog_prologue(*args, normals=normals)
    mv.product(w)
    NS.nuts_leapfrog_epilogue(*args)
    NS.nuts_leapfrog_prologue(*args, dirs=dirs)
    mv.product(w)
    NS.nuts_leapfrog_epilogue(*args, dirs=dirs, u_leaf=torch.full((C,), 0.5), leaf=0)

    def one(s, q, p, b_l, b_p, sg):
        def lp(v):
            st = f.jcoords.from_vector(s, v)
            x = b_p * f.jm.log_prior(st) + b_l * f.jm.log_likelihood(st)
            x = x + JH.log_jacobian_root_branch(st, f.topo)
            return jnp.where(jnp.isnan(x), -jnp.inf, x)

        im = jnp.asarray(inv_mass.numpy())
        g0 = jax.grad(lp)(q)
        q1, p1, g1 = jhmc._leapfrog(jax.grad(lp), im, sg * eps, q, p, g0)
        return q1, p1, g1, lp(q1), lp(q)

    p0 = normals / torch.sqrt(inv_mass)
    sg = torch.where(dirs, 1.0, -1.0).to(torch.float64)
    jq, jp, jg, jl, jl0 = jax.jit(jax.vmap(one))(
        f.jstate(), *(jnp.asarray(x.numpy()) for x in (q0, p0, bl, bp, sg)))
    d = dirs.long()
    ar = torch.arange(C)
    close(w.q_new, jq)
    close(w.ends_q[d, ar], jq)
    close(w.ends_p[d, ar], jp)
    for c in range(C):
        close(w.ends_g[d[c], c], jg[c])
    close(w.logp, jl)
    # The port's plain _leapfrog with the autograd gradient agrees too.
    tgt = hmc.make_log_density(f.pm, f.coords, f.ps, bl)

    def grad(v):
        return hmc.value_and_grad(lambda x: tgt(x) + (bp - 1.0) * f.pm.log_prior(
            f.coords.from_vector(f.ps, x)), v)[1]

    q1, p1, _ = hmc._leapfrog(grad, inv_mass, 0.02 * sg[:, None], q0, p0, grad(q0))
    close(q1, jq)
    close(p1, jp)
    # The other end still holds the start.
    close(w.ends_q[1 - d, ar], q0)
    close(w.h0, jl0 - 0.5 * jnp.sum(jnp.asarray(p0.numpy()) ** 2 * inv_mass.numpy(), axis=1))
    assert w.n_steps.tolist() == [1] * C
