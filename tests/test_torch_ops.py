"""Parity of the PyTorch port's ``ops/`` with the JAX package, on the CPU.

The same inputs, made from a NumPy seed, go through the JAX function (x64,
as ``conftest.py`` sets it) and the port's counterpart (float64).  Every
deterministic function must agree to ``rtol=1e-12``; the samplers receive
the very draws the JAX samplers take from their keys.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcmcdate_tpu.ops import birth_death as jbd, clocks as jclocks, dists as jd
from mcmcdate_tpu.ops import mvn as jmvn, node_priors as jnp_
from mcmcdate_tpu.tree import FlatTopology
from mcmcdate_tpu.utils.simulate import random_ultrametric_tree
from mcmcdate_tpu_torch.ops import birth_death as tbd, clocks as tclocks, dists as td
from mcmcdate_tpu_torch.ops import mvn as tmvn, node_priors as tnp

RTOL = 1e-12
C = 24


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def close(port, ref, rtol=RTOL, atol=0.0):
    port = np.asarray(port.detach() if isinstance(port, torch.Tensor) else port, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isfinite(port), np.isfinite(ref))
    np.testing.assert_array_equal(port[~np.isfinite(ref)], ref[~np.isfinite(ref)])
    fin = np.isfinite(ref)
    np.testing.assert_allclose(port[fin], ref[fin], rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(20261016)


def _positive(rng, n=C):
    x = rng.gamma(2.0, 0.5, size=n)
    x[:3] = [0.0, -1.0, np.inf]
    return x


def test_scalar_densities(rng):
    x = _positive(rng)
    close(td.exponential_logpdf(1.7, T(x)), jd.exponential_logpdf(1.7, jnp.asarray(x)))
    for shape, scale in ((1.5, 1.0 / 6.0), (0.7, 2.0), (250.0, 0.004), (3e7, 3e-8)):
        close(td.gamma_logpdf(shape, scale, T(x)), jd.gamma_logpdf(shape, scale, jnp.asarray(x)))
    mean = rng.uniform(0.5, 2.0, C)
    var = rng.uniform(1e-5, 2.0, C)
    close(td.gamma_mean_variance_logpdf(T(mean), T(var), T(x)),
          jd.gamma_mean_variance_logpdf(jnp.asarray(mean), jnp.asarray(var), jnp.asarray(x)))
    close(td.log_normal_mean_param_logpdf(T(mean), T(var), T(x)),
          jd.log_normal_mean_param_logpdf(jnp.asarray(mean), jnp.asarray(var), jnp.asarray(x)))
    close(td.normal_logpdf(T(mean[3:]), T(var[3:]), T(x[3:])),
          jd.normal_logpdf(jnp.asarray(mean[3:]), jnp.asarray(var[3:]), jnp.asarray(x[3:])))
    u = rng.uniform(-0.6, 0.6, C)
    close(td._log1pmx(T(u)), jd._log1pmx(jnp.asarray(u)))


def test_truncated_normal_logpdf(rng):
    mean = rng.uniform(-1, 1, C)
    sd = rng.uniform(0.01, 2, C)
    a = mean - rng.uniform(0, 3, C)
    b = mean + rng.uniform(0, 3, C)
    b[::4] = np.inf
    a[1::5] = 7.0  # far tail
    b[1::5] = 9.0
    x = rng.uniform(a, np.where(np.isfinite(b), b, a + 5))
    args = [mean, sd, a, b, x]
    close(td.truncated_normal_logpdf(*map(T, args)),
          jd.truncated_normal_logpdf(*map(jnp.asarray, args)))


def test_truncated_normal_sample_with_jax_draws(rng):
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    mean = rng.uniform(0.2, 0.8, C)
    a = mean - rng.uniform(0.0, 0.3, C)
    b = np.where(np.arange(C) % 3 == 0, np.inf, mean + rng.uniform(0.0, 0.3, C))
    tune = rng.uniform(0.1, 3.0, C)
    fn = jax.vmap(lambda k, m, t, lo, hi: jd.truncated_normal_sample(k, m, 0.05, t, lo, hi))
    x_ref, lq_ref = fn(keys, *map(jnp.asarray, (mean, tune, a, b)))
    u = jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float64))(keys)
    x, lq = td.truncated_normal_sample(T(u), T(mean), 0.05, T(tune), T(a), T(b))
    close(x, x_ref)
    close(lq, lq_ref, atol=1e-12)


def test_gamma_scale_sample_with_jax_draws(rng):
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    tune = rng.uniform(0.001, 5.0, C)
    for par in (10.0, 100.0):
        u_ref, base_ref, lu_ref = jax.vmap(
            lambda k, t: jd.gamma_scale_sample(k, par, t))(keys, jnp.asarray(tune))
        g = jax.vmap(lambda k, t: jax.random.gamma(k, par / t, dtype=jnp.float64))(
            keys, jnp.asarray(tune))
        u, base, lu = td.gamma_scale_sample(T(g), par, T(tune))
        close(u, u_ref)
        close(lu, lu_ref)
        close(base, base_ref, atol=1e-9)


def _tree_state(rng, n_leaves=12, chains=C):
    t = random_ultrametric_tree(rng, n_leaves)
    topo = FlatTopology.from_tree(t)
    parent = np.asarray(topo.parent)
    h = np.zeros((chains, topo.n))
    h[:, 0] = 1.0
    for i in range(1, topo.n):
        if not topo.is_leaf[i]:
            h[:, i] = h[:, parent[i]] * rng.uniform(0.3, 0.95, chains)
    rates = rng.gamma(5.0, 0.2, size=(chains, topo.n))
    return topo, h, rates


def test_birth_death_terms(rng):
    topo, h, _ = _tree_state(rng)
    la = rng.uniform(0.05, 4.0, C)
    mu = rng.uniform(0.0, 4.0, C)
    mu[::6] = la[::6] + 3e-7  # near-critical series
    mu[1::6] = la[1::6] + 60.0  # mu >> la
    la[2] = -0.5  # invalid rate
    h[3, 5] = h[3, int(topo.parent[5])]  # zero-length branch
    ref = jax.vmap(lambda hh, a, b: jbd.birth_death_terms(
        hh, jnp.asarray(topo.parent), jnp.asarray(topo.is_leaf), a, b, 1.0))(
        jnp.asarray(h), jnp.asarray(la), jnp.asarray(mu))
    out = tbd.birth_death_terms(T(h), torch.as_tensor(topo.parent.astype(np.int64)),
                                torch.as_tensor(topo.is_leaf), T(la), T(mu), 1.0)
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(np.asarray(ref)))
    ok = ~np.isnan(np.asarray(ref))
    close(out.numpy()[ok], np.asarray(ref)[ok], atol=1e-12)
    close(tbd.birth_death_log(T(h), torch.as_tensor(topo.parent.astype(np.int64)),
                              torch.as_tensor(topo.is_leaf), T(la), T(mu), 1.0),
          jax.vmap(lambda hh, a, b: jbd.birth_death_log(
              hh, jnp.asarray(topo.parent), jnp.asarray(topo.is_leaf), a, b, 1.0))(
              jnp.asarray(h), jnp.asarray(la), jnp.asarray(mu)), atol=1e-12)


def test_birth_death_terms_float32_near_critical(rng):
    """At float32 the port evaluates the birth-death terms in float64: one
    to three float32 ulps between birth and death (just above the
    near-critical threshold at these rates) must not add spurious prior.
    The JAX package's float32 evaluation of the same state shows the size
    of the error this guards against."""
    topo, h, _ = _tree_state(rng)
    la = rng.uniform(20.0, 32.0, C).astype(np.float32)
    ulps = np.arange(C) % 3 + 1
    mu = la.copy()
    for k in range(C):
        for _ in range(ulps[k]):
            mu[k] = np.nextafter(mu[k], np.float32(np.inf if k % 2 else -np.inf))
    assert np.all(np.abs(la.astype(np.float64) - mu) > 1e-6)
    h32 = h.astype(np.float32)
    parent = torch.as_tensor(topo.parent.astype(np.int64))
    out = tbd.birth_death_terms(torch.as_tensor(h32), parent, torch.as_tensor(topo.is_leaf),
                                torch.as_tensor(la), torch.as_tensor(mu), 1.0)
    assert out.dtype == torch.float32

    def ref(dtype):
        return np.asarray(jax.vmap(lambda hh, a, b: jbd.birth_death_terms(
            hh, jnp.asarray(topo.parent), jnp.asarray(topo.is_leaf), a, b, 1.0))(
            jnp.asarray(h32, dtype), jnp.asarray(la, dtype), jnp.asarray(mu, dtype)))

    f64 = ref(jnp.float64)
    # One float32 rounding of each term.
    close(out.numpy(), f64, rtol=1e-6, atol=1e-6)
    assert np.nanmax(np.abs(ref(jnp.float32) - f64)) > 0.5


@pytest.mark.parametrize("model", tclocks.MODELS)
def test_relaxed_clock(rng, model):
    topo, h, rates = _tree_state(rng)
    var = rng.uniform(1e-4, 2.0, C)
    var[0] = 0.0
    rates[1, 3] = 0.0
    tl = h[:, np.maximum(topo.parent, 0)] - h
    non_root = topo.parent >= 0
    for fn_t, fn_j in ((tclocks.relaxed_clock_terms, jclocks.relaxed_clock_terms),
                       (tclocks.relaxed_clock_log, jclocks.relaxed_clock_log)):
        ref = jax.vmap(lambda r, t, v: fn_j(model, r, t, jnp.asarray(non_root), 1.0, v))(
            jnp.asarray(rates), jnp.asarray(tl), jnp.asarray(var))
        out = fn_t(model, T(rates), T(tl), torch.as_tensor(non_root), 1.0, T(var))
        close(out, ref, atol=1e-9)


def test_node_priors(rng):
    topo, h, _ = _tree_state(rng)
    inner = [int(i) for i in topo.inner_nodes if i]
    cal = jnp_.CalibrationSet(
        np.asarray([0, inner[0], inner[2]], np.int32), np.asarray([1.5, 0.2, 0.0]),
        np.asarray([0.01, 0.05, 1.0]), np.asarray([3.0, np.inf, 0.4]),
        np.asarray([0.01, 1.0, 0.02]))
    con = jnp_.ConstraintSet(np.asarray([inner[1], inner[3]], np.int32),
                             np.asarray([inner[4], inner[2]], np.int32), np.asarray([0.01, 0.1]))
    br = jnp_.BraceSet(np.asarray([[inner[3], inner[5], -1], [inner[4], inner[6], inner[7]]],
                                  np.int32), np.asarray([0.02, 0.1]))
    tcal, tcon, tbr = (tnp.CalibrationSet(*[getattr(cal, f) for f in
                                             ("node", "lower", "lower_pm", "upper", "upper_pm")]),
                       tnp.ConstraintSet(con.young, con.old, con.pm),
                       tnp.BraceSet(br.node, br.sd))
    hm = rng.uniform(0.5, 3.0, C)
    hm[0] = -1.0
    ref_terms = jax.vmap(lambda hh, m: jnp_.calibrate_constrain_brace_terms(
        cal, con, br, hh, m))(jnp.asarray(h), jnp.asarray(hm))
    close(tnp.calibrate_constrain_brace_terms(tcal, tcon, tbr, T(h), T(hm)), ref_terms,
          atol=1e-12)
    ref_log = jax.vmap(lambda hh, m: jnp_.calibrate_constrain_brace_log(
        cal, con, br, hh, m))(jnp.asarray(h), jnp.asarray(hm))
    close(tnp.calibrate_constrain_brace_log(tcal, tcon, tbr, T(h), T(hm)), ref_log, atol=1e-12)
    empty = tnp.calibrate_constrain_brace_terms(
        tnp.CalibrationSet.empty(), tnp.ConstraintSet.empty(), tnp.BraceSet.empty(), T(h), T(hm))
    assert empty.shape == (C, 0)


def test_mvn_densities(rng):
    k = 9
    a = rng.normal(size=(k, k))
    sigma = a @ a.T + np.eye(k)
    mu = rng.uniform(0.1, 0.5, k)
    d = mu + rng.normal(size=(C, k)) * 0.1
    full_j = jmvn.LikelihoodData.full(mu, np.linalg.inv(sigma), np.linalg.slogdet(sigma)[1])
    full_t = tmvn.LikelihoodData.full(mu, np.linalg.inv(sigma), np.linalg.slogdet(sigma)[1])
    close(tmvn.make_log_likelihood(full_t, device="cpu")(T(d)),
          jax.vmap(jmvn.make_log_likelihood(full_j))(jnp.asarray(d)))
    var = np.diag(sigma)
    close(tmvn.make_log_likelihood(tmvn.LikelihoodData.univariate(mu, var), device="cpu")(T(d)),
          jax.vmap(jmvn.make_log_likelihood(jmvn.LikelihoodData.univariate(mu, var)))(
              jnp.asarray(d)))
    assert torch.equal(tmvn.make_log_likelihood(tmvn.LikelihoodData.none(), device="cpu")(T(d)),
                       torch.zeros(C, dtype=torch.float64))
    # The banded kind: an upper band of width 2 in a permuted layout.
    perm = rng.permutation(k)
    lb = np.column_stack([rng.uniform(1.0, 2.0, k), rng.normal(size=(k, 2)) * 0.3])
    lb_ld = 0.7
    close(tmvn.make_log_likelihood(tmvn.LikelihoodData.banded(mu, lb, lb_ld, perm),
                                   device="cpu")(T(d)),
          jax.vmap(jmvn.make_log_likelihood(jmvn.LikelihoodData.banded(mu, lb, lb_ld, perm)))(
              jnp.asarray(d)))
