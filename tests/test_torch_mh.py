"""Parity of the PyTorch port's proposals and sequential MHG ticket step
with the JAX package, on the CPU at float64.

Every proposal kernel ``_k_*`` receives the draws the JAX kernel takes from
its key (a uniform, or a standard gamma of shape ``par / tune``); one
ticket step per proposal kind and likelihood class must give the same
accept mask and the same terms, distances and whitened residual (1e-10).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcmcdate_tpu.engine import mh as jmh, proposals as JP
from mcmcdate_tpu.models import DatingModel as JModel, init_state as j_init
from mcmcdate_tpu.models.state import State as JState
from mcmcdate_tpu.ops import heights as JH, mvn as jmvn, node_priors as jnp_
from mcmcdate_tpu.tree import FlatTopology
from mcmcdate_tpu.utils.simulate import random_ultrametric_tree
from mcmcdate_tpu_torch.engine import mh as tmh, proposals as TP
from mcmcdate_tpu_torch.models import from_numpy
from mcmcdate_tpu_torch.models.state import FIELDS

C = 12


def close(port, ref, rtol=1e-12, atol=1e-13):
    port = np.asarray(port.numpy() if isinstance(port, torch.Tensor) else port)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(np.isfinite(port), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(port[~fin], ref[~fin])
    np.testing.assert_allclose(port[fin], ref[fin], rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    t = random_ultrametric_tree(rng, 10)
    topo = FlatTopology.from_tree(t)
    k = topo.n - 2
    a = rng.normal(size=(k, k)) / np.sqrt(k)
    sigma = (a @ a.T + np.eye(k) * 0.1) * 1e-3
    s0 = j_init(t, topo)
    d0 = np.asarray(JH.distances_from_state(s0, topo))
    data = jmvn.LikelihoodData.full(d0 * rng.uniform(0.9, 1.1, k), np.linalg.inv(sigma),
                                    np.linalg.slogdet(sigma)[1])
    inner = [int(i) for i in topo.inner_nodes if i]
    cal = jnp_.CalibrationSet(np.asarray([0], np.int32), np.asarray([0.8]),
                              np.asarray([0.01]), np.asarray([1.6]), np.asarray([0.01]),
                              names=("root",))
    br = jnp_.BraceSet(np.asarray([[inner[2], inner[-1]]], np.int32), np.asarray([0.05]),
                       names=("b",))
    jm = JModel(topo=topo, likelihood=data, calibrations=cal, braces=br, mean_root_height=1.2)
    table = JP.build_proposal_table(topo, br, True)
    h = np.asarray(s0.heights)[None].repeat(C, 0) * rng.uniform(0.95, 1.0, size=(C, 1))
    h[:, 0] = 1.0
    h[:, topo.is_leaf] = 0.0
    state = dict(heights=h, rates=rng.gamma(20.0, 0.05, size=(C, topo.n)),
                 birth=rng.uniform(0.5, 2, C), death=rng.uniform(0.1, 1, C),
                 height=rng.uniform(1.0, 1.4, C), rate_mean=rng.uniform(0.8, 1.2, C),
                 rate_var=rng.uniform(0.05, 0.5, C))
    pm, ps = from_numpy(topo, data, state, calibrations=cal, braces=br, mean_root_height=1.2,
                        device="cpu")
    js = JState(**{k2: jnp.asarray(v) for k2, v in state.items()})
    tuning = rng.uniform(0.3, 3.0, size=(C, table.n_proposals))
    return topo, br, jm, js, pm, ps, table, tuning


def _draws(table, pidx, keys, tuning):
    """The draw the JAX kernel of row ``pidx`` takes from each chain's key."""
    kind = int(table.kind[pidx])
    if kind in TP.GAMMA_KINDS:
        k = float(table.par[pidx]) / jnp.asarray(tuning[:, pidx])
        return jax.vmap(lambda kk, a: jax.random.gamma(kk, a, dtype=jnp.float64))(keys, k)
    return jax.vmap(lambda kk: jax.random.uniform(kk, dtype=jnp.float64))(keys)


def _rows_per_kind(table):
    """One row per kind, every scalar selector of the scalar scale, and one
    row per likelihood class."""
    rows = {}
    for p, kind in enumerate(table.kind):
        key = (int(kind), int(table.aux[p])) if kind == JP.K_SCALE_SCALAR else int(kind)
        rows.setdefault(key, p)
        rows.setdefault(("dc", int(table.d_class[p]), int(table.kind[p])), p)
    return sorted(set(rows.values()))


def test_table_matches_jax(setup):
    topo, br, jm, js, pm, ps, table, _ = setup
    port = TP.build_proposal_table(pm.topo, pm.braces, True)
    for f in ("kind", "node", "aux", "par", "weight", "dim", "root_jac", "tickets", "d_class",
              "d_lo", "didx", "prior_class"):
        np.testing.assert_array_equal(getattr(port, f), getattr(table, f))
    assert port.names == table.names
    np.testing.assert_array_equal(port.tune_max(), table.tune_max())
    np.testing.assert_array_equal(port.target_rates(), table.target_rates())
    assert set(int(k) for k in table.kind) == set(range(JP.N_KINDS))


def test_kernels_with_injected_draws(setup):
    topo, br, jm, js, pm, ps, table, tuning = setup
    kernels = JP.make_kernel_switch(topo, br)
    keys = jax.random.split(jax.random.PRNGKey(0), C)
    for p in _rows_per_kind(table):
        kind = int(table.kind[p])
        node, aux, par = int(table.node[p]), int(table.aux[p]), float(table.par[p])
        ref_state, ref_lq = jax.vmap(lambda s, kk, tu: kernels[kind](
            s, kk, tu, jnp.int32(node), jnp.int32(aux), jnp.float64(par)))(
            js, keys, jnp.asarray(tuning[:, p]))
        draw = torch.as_tensor(np.asarray(_draws(table, p, keys, tuning)))
        new, lq = TP.KERNELS[kind](ps, draw, torch.as_tensor(tuning[:, p]), node, aux, par,
                                   pm.topo, pm.braces)
        close(lq, ref_lq, atol=1e-10)
        for f in FIELDS:
            close(getattr(new, f), getattr(ref_state, f))
            if np.array_equal(np.asarray(getattr(ref_state, f)), np.asarray(getattr(js, f))):
                # an unchanged field stays the same tensor (K3 skips it)
                assert getattr(new, f) is getattr(ps, f) or torch.equal(getattr(new, f),
                                                                        getattr(ps, f))


def test_ticket_step_per_kind(setup):
    topo, br, jm, js, pm, ps, table, tuning = setup
    jk = jmh.MHKernel(jm, table)
    step = jax.jit(jk._ticket_step(JP.make_kernel_switch(topo, br), 1.0, jnp.float64))
    terms = jax.vmap(jm.log_prior_terms)(js)
    y = jax.vmap(jm.whitened_residual_internal)(js)
    d = jax.vmap(lambda s: JH.distances_internal(s, topo))(js)
    acc = jnp.zeros((C, table.n_proposals), jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(1), C)
    tk = tmh.MHKernel(pm, TP.build_proposal_table(pm.topo, pm.braces, True))
    tuning_t = torch.as_tensor(tuning)
    n_accepts = 0
    for p in _rows_per_kind(table):
        out, _ = step((js, terms, d, y, jnp.asarray(tuning), acc, keys), jnp.int32(p))
        j_batch, j_terms, j_d, j_y, _, j_acc, _ = out
        keys2 = jax.vmap(lambda kk: jax.random.split(kk, 3))(keys)
        draw = torch.as_tensor(np.asarray(_draws(table, p, keys2[:, 1], tuning)))
        u = torch.as_tensor(np.asarray(
            jax.vmap(lambda kk: jax.random.uniform(kk, dtype=jnp.float64))(keys2[:, 2])))
        carry = tk.init_carry(ps)
        accept = tk.ticket_step(carry, tuning_t, p, draw, u)
        np.testing.assert_array_equal(accept.numpy(), np.asarray(j_acc[:, p]) == 1,
                                      err_msg=table.names[p])
        n_accepts += int(accept.sum())
        close(carry.terms, j_terms, rtol=1e-10, atol=1e-10)
        close(carry.d, j_d, rtol=1e-10, atol=1e-10)
        close(carry.y, j_y, rtol=1e-10, atol=1e-10)
        np.testing.assert_array_equal(carry.acc.numpy(), np.asarray(j_acc))
        for f in FIELDS:
            close(getattr(carry.batch, f), getattr(j_batch, f), rtol=1e-10, atol=1e-12)
    assert 0 < n_accepts < C * len(_rows_per_kind(table))


def test_tune_step_and_schedules():
    rng = np.random.default_rng(2)
    tuning = rng.uniform(0.01, 5, (4, 6))
    acc = rng.integers(0, 50, (4, 6)).astype(float)
    tot = np.full((4, 6), 50.0)
    tot[0, 0] = 0.0
    targets = rng.uniform(0.2, 0.45, 6)
    tmax = rng.uniform(1, 10, 6)
    ref = jmh.tune_step(jnp.asarray(tuning), jnp.asarray(acc), jnp.asarray(tot),
                        jnp.asarray(targets), tune_max=jnp.asarray(tmax))
    out = tmh.tune_step(*map(torch.as_tensor, (tuning, acc, tot, targets)),
                        tune_max=torch.as_tensor(tmax))
    close(out, ref)
    for name in ("default", "informed", "profiling"):
        a, b = getattr(tmh.BurnInSettings, name)(), getattr(jmh.BurnInSettings, name)()
        assert (a.fast, a.slow, a.total) == (b.fast, b.slow, b.total)
