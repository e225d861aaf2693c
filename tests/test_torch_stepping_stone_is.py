"""The port's stepping-stone slice as a whole on the CPU: its log Z on the
8-leaf full-MVN model of ``tests/test_stepping_stone_multivariate.py``
against that test's importance-sampling log Z, computed with the JAX
package's functions."""

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import logsumexp

from mcmcdate_tpu_torch.engine import stepping_stone as SS
from mcmcdate_tpu_torch.engine.chains import RunSettings
from mcmcdate_tpu_torch.models import DatingModel, init_state
from mcmcdate_tpu_torch.ops import mvn
from mcmcdate_tpu_torch.tree import FlatTopology
from mcmcdate_tpu_torch.tree.rose import parse_newick
from test_torch_stepping_stone import EIGHT, _quiet, one_thread  # noqa: F401


def test_slice_matches_importance_sampling(monkeypatch, one_thread):
    """The whole slice: the port's ``run_marginal_likelihood`` (profile
    ladder of 12 stones, the cascade at its 3 sweeps a rung, float64 on the
    CPU) on the 8-leaf full-MVN model of
    ``tests/test_stepping_stone_multivariate.py``, against that test's
    importance-sampling ln Z through the JAX package (2^17 samples, ESS >
    200 both ways).  Tolerance max(6 se, 1.5), as there.  Cut for time: 60
    iterations (not 600) and burn-in windows of 10 + 10 sweeps (not 60 +
    100); the IS samples are not cut."""
    import test_proposal_invariance as TI
    from mcmcdate_tpu_torch.engine import mh as TM
    from mcmcdate_tpu.models import DatingModel as JModel
    from mcmcdate_tpu.ops import mvn as jmvn
    from mcmcdate_tpu.tree import FlatTopology as JFlat, parse_newick as jparse

    jtopo = JFlat.from_tree(jparse(EIGHT))
    rng = np.random.default_rng(4)
    k = jtopo.n - 2
    a = rng.normal(size=(k, k)) / np.sqrt(k)
    sigma = a @ a.T * 0.05 + np.eye(k) * 0.05
    mu = rng.uniform(0.05, 0.35, size=k)
    prec, logdet = np.linalg.inv(sigma), np.linalg.slogdet(sigma)[1]
    jm = JModel(topo=jtopo, likelihood=jmvn.LikelihoodData.full(mu, prec, logdet))
    batch, logq = TI._sample_q(jtopo, 1 << 17, seed=21)

    def lp_ll(st):
        lp = jm.log_prior(st)
        ll = jm.log_likelihood(st)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp), jnp.where(jnp.isnan(ll), -jnp.inf, ll)

    lp, ll = jax.jit(jax.vmap(lp_ll))(batch)
    lw = np.asarray(lp) - np.asarray(logq)
    ll = np.asarray(ll)
    ok = np.isfinite(lw)
    lw, ll = lw[ok], ll[ok]
    lnz_is = logsumexp(lw + ll) - logsumexp(lw)
    wp = np.exp(lw + ll - np.max(lw + ll))
    wp /= wp.sum()
    w0 = np.exp(lw - np.max(lw))
    w0 /= w0.sum()
    ess_p, ess_0 = 1.0 / np.sum(wp * wp), 1.0 / np.sum(w0 * w0)
    se = np.sqrt(1.0 / ess_p + 1.0 / ess_0)
    assert ess_p > 200 and ess_0 > 200

    monkeypatch.setattr(TM, "BURN_IN_PROF_FAST", [10])
    monkeypatch.setattr(TM, "BURN_IN_PROF_SLOW", [])
    monkeypatch.setattr(SS, "REPETITIVE_BURN_IN_PROF", TM.BurnInSettings([10], []))
    tree = parse_newick(EIGHT)
    topo = FlatTopology.from_tree(tree)
    model = DatingModel(topo=topo, likelihood=mvn.LikelihoodData.full(mu, prec, logdet),
                        device="cpu")
    res = SS.run_marginal_likelihood(
        model, init_state(tree, topo, device="cpu"),
        RunSettings("ssmv", n_chains=1, seed=3, iterations=60, device="cpu", dtype="float64"),
        profile=True, log=_quiet)
    err = abs(res.log_marginal_likelihood - lnz_is)
    assert err < max(6 * se, 1.5), (res.log_marginal_likelihood, lnz_is, se)
    assert res.mean_log_lik_per_point[-1] > res.mean_log_lik_per_point[0]
