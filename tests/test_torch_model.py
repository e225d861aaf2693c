"""Parity of the PyTorch port's model layer with the JAX package, on the CPU.

Covers ``models/state.py``, ``models/dating.py`` and the plain versions of
kernels K1 (``prior_terms`` against ``DatingModel.log_prior_terms``) and K2
(``whiten`` against ``whitened_residual_internal`` and the incremental
likelihood classes of ``MHKernel._ticket_step``), all at float64 with
``rtol=1e-12``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcmcdate_tpu.models import DatingModel as JModel, init_state as j_init, is_valid_state
from mcmcdate_tpu.models.state import State as JState
from mcmcdate_tpu.ops import clocks as jclocks, heights as JH, mvn as jmvn, node_priors as jnp_
from mcmcdate_tpu.tree import FlatTopology
from mcmcdate_tpu.utils.simulate import random_ultrametric_tree
from mcmcdate_tpu_torch.kernels.prior_terms import prior_terms, prior_terms_plain
from mcmcdate_tpu_torch.kernels.whiten import range_rows, whiten, whiten_plain
from mcmcdate_tpu_torch.models import State, from_numpy, init_state, is_valid_state as t_valid
from mcmcdate_tpu_torch.models.state import FIELDS
from mcmcdate_tpu_torch.ops import heights as TH, mvn as tmvn

C = 16
RTOL = 1e-12


def close(port, ref, rtol=RTOL, atol=0.0):
    port = np.asarray(port.detach().numpy() if isinstance(port, torch.Tensor) else port)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(np.isfinite(port), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(port[~fin], ref[~fin])
    np.testing.assert_allclose(port[fin], ref[fin], rtol=rtol, atol=atol)


def _setup(clock=jclocks.UNCORRELATED_GAMMA, seed=5, n_leaves=14):
    rng = np.random.default_rng(seed)
    t = random_ultrametric_tree(rng, n_leaves)
    topo = FlatTopology.from_tree(t)
    k = topo.n - 2
    a = rng.normal(size=(k, k)) / np.sqrt(k)
    sigma = a @ a.T + np.eye(k) * 0.1
    data = jmvn.LikelihoodData.full(rng.uniform(0.05, 0.6, size=k), np.linalg.inv(sigma),
                                    np.linalg.slogdet(sigma)[1])
    inner = [int(i) for i in topo.inner_nodes if i]
    cal = jnp_.CalibrationSet(
        np.asarray([0, inner[1], inner[4]], np.int32), np.asarray([0.8, 0.3, 0.0]),
        np.asarray([0.01, 0.02, 1.0]), np.asarray([1.6, np.inf, 0.5]),
        np.asarray([0.01, 1.0, 0.03]), names=("root", "a", "b"))
    con = jnp_.ConstraintSet(np.asarray([inner[2]], np.int32), np.asarray([inner[3]], np.int32),
                             np.asarray([0.01]), names=("c",))
    br = jnp_.BraceSet(np.asarray([[inner[5], inner[6], -1]], np.int32), np.asarray([0.02]),
                       names=("br",))
    jm = JModel(topo=topo, likelihood=data, clock=clock, calibrations=cal, constraints=con,
                braces=br, mean_root_height=1.2)
    s0 = j_init(t, topo)
    h = np.asarray(s0.heights)[None].repeat(C, 0) * rng.uniform(0.9, 1.0, size=(C, 1))
    h[:, 0] = 1.0
    h[:, topo.is_leaf] = 0.0
    state = dict(heights=h, rates=rng.gamma(5.0, 0.2, size=(C, topo.n)),
                 birth=rng.uniform(0.2, 3, C), death=rng.uniform(0, 3, C),
                 height=rng.uniform(0.5, 2, C), rate_mean=rng.uniform(0.5, 2, C),
                 rate_var=rng.uniform(0.01, 1.5, C))
    state["death"][0] = state["birth"][0] + 2e-7
    state["rate_var"][1] = 2e-3
    pm, ps = from_numpy(topo, data, state, clock=clock, calibrations=cal, constraints=con,
                        braces=br, mean_root_height=1.2, device="cpu")
    js = JState(**{k: jnp.asarray(v) for k, v in state.items()})
    return t, topo, jm, js, pm, ps, rng


@pytest.mark.parametrize("clock", jclocks.CLI_CLOCK_MODELS + (jclocks.AUTOCORRELATED_GAMMA,))
def test_prior_terms_plain_matches_log_prior_terms(clock):
    _, _, jm, js, pm, ps, _ = _setup(clock)
    ref = jax.vmap(jm.log_prior_terms)(js)
    # atol: terms near zero inherit the rounding of O(1) intermediates
    close(prior_terms_plain(pm, ps), ref, atol=1e-12)
    close(prior_terms(pm, ps), ref, atol=1e-12)  # CPU tensors take the plain version
    assert prior_terms.launches == 0
    assert pm.term_block_sizes == jm.term_block_sizes
    for name in ("log_prior_cal_con_brace", "log_prior_birth_death",
                 "log_prior_relaxed_clock", "log_prior", "log_likelihood", "log_posterior"):
        close(getattr(pm, name)(ps), jax.vmap(getattr(jm, name))(js), atol=1e-9)


def test_whiten_plain_matches_residual_and_classes():
    _, topo, jm, js, pm, ps, rng = _setup()
    y_ref = jax.vmap(jm.whitened_residual_internal)(js)
    close(pm.whitened_residual_internal(ps), y_ref, atol=1e-13)
    assert pm.log_lik_const == jm.log_lik_const

    D = jm.likelihood.dim
    L = np.asarray(jm.chol_internal)
    mu = np.asarray(jm.mu_internal)
    Lt, mut = pm.chol_internal_t, pm.mu_internal_t
    y = np.asarray(y_ref)
    d = np.asarray(jax.vmap(lambda s: JH.distances_internal(s, topo))(js))
    d2 = d * (1.0 + 0.01 * rng.normal(size=d.shape))
    delta = d2 - d
    # br_full (engine/mh.py:154-156)
    dy_ref = (d2 - mu) @ L - y
    rows_all = torch.arange(D, dtype=torch.int32)  # the full class as an explicit row list
    dy, dl = whiten(torch.as_tensor(d2), Lt, rows=rows_all, sub=mut, y=torch.as_tensor(y),
                    minus_y=True)
    close(dy, dy_ref, atol=1e-13)
    close(dl, -0.5 * np.sum(dy_ref * (2 * y + dy_ref), axis=-1), atol=1e-12)
    # br_gather (mh.py:158-161): pad index D reads zero
    PAD = 1025
    delta_pad = np.pad(delta, ((0, 0), (0, PAD)))
    L_pad = np.concatenate([L, np.zeros((PAD, D))])
    idx = np.asarray([3, 1, D, 7], np.int32)
    dy_ref = delta_pad[:, idx] @ L_pad[idx, :]
    dy, dl = whiten(torch.as_tensor(delta), Lt, rows=torch.as_tensor(idx), y=torch.as_tensor(y))
    close(dy, dy_ref, atol=1e-13)
    close(dl, -0.5 * np.sum(dy_ref * (2 * y + dy_ref), axis=-1), atol=1e-12)
    # mk_range(B) (mh.py:163-172), a range running past the end
    for lo, B in ((1, 64), (D - 5, 64)):
        dy_ref = delta_pad[:, lo:lo + B] @ L_pad[lo:lo + B] + delta[:, 0:1] @ L[0:1, :]
        rows = torch.as_tensor(range_rows(lo, B, D), dtype=torch.int32)
        dy, dl = whiten_plain(torch.as_tensor(delta), Lt, rows=rows, y=torch.as_tensor(y))
        close(dy, dy_ref, atol=1e-13)
    with pytest.raises(ValueError):
        range_rows(0, 64, D)
    # no y: the reduction is the quadratic form
    yy, q = whiten(torch.as_tensor(d), Lt, sub=mut)
    close(q, np.sum(y * y, axis=-1), atol=1e-12)
    assert whiten.launches == 0


def test_state_init_and_validity():
    t, topo, jm, js, pm, ps, _ = _setup()
    ref = j_init(t, topo)
    port = init_state(t, topo, n_chains=3, device="cpu")
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(port, k).numpy(),
                                      np.broadcast_to(np.asarray(getattr(ref, k)),
                                                      getattr(port, k).shape))
    bad = {k: np.array(getattr(ps, k).numpy()) for k in FIELDS}
    bad["heights"][1, 3] = 2.0  # above its parent
    bad["rates"][2, 4] = -1.0
    bad["birth"][3] = 0.0
    bad["heights"][4, 0] = 0.9
    jbad = JState(**{k: jnp.asarray(v) for k, v in bad.items()})
    tbad = State.from_arrays(bad, device="cpu")
    np.testing.assert_array_equal(t_valid(tbad, topo).numpy(),
                                  np.asarray(jax.vmap(lambda s: is_valid_state(s, topo))(jbad)))
    assert not t_valid(tbad, topo)[1:5].any() and t_valid(tbad, topo)[0]


def test_distances_and_root_jacobian():
    _, topo, jm, js, pm, ps, _ = _setup()
    close(TH.distances_from_state(ps, pm.topo), jax.vmap(lambda s: JH.distances_from_state(
        s, topo))(js))
    close(TH.log_jacobian_root_branch(ps, pm.topo),
          jax.vmap(lambda s: JH.log_jacobian_root_branch(s, topo))(js))


def test_from_numpy_copies_sets_and_kinds():
    _, topo, jm, js, pm, ps, _ = _setup()
    assert pm.calibrations.names == jm.calibrations.names
    np.testing.assert_array_equal(pm.braces.node, jm.braces.node)
    assert pm.likelihood.kind == tmvn.FULL
    np.testing.assert_array_equal(pm.chol_internal, np.asarray(jm.chol_internal))
    uni = jmvn.LikelihoodData.univariate(jm.likelihood.mu, np.diag(np.linalg.inv(
        jm.likelihood.precision)))
    pu, psu = from_numpy(topo, uni, {k: np.asarray(getattr(js, k)) for k in FIELDS},
                         device="cpu")
    ju = JModel(topo=topo, likelihood=uni)
    close(pu.whitened_residual_internal(psu), jax.vmap(ju.whitened_residual_internal)(js),
          atol=1e-13)
    assert pu.chol_internal is None
