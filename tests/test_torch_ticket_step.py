"""Parity of the sequential sweep's ticket kernels' plain versions (T1
``ticket_prologue_plain``, K3 ``accept_select_plain``, T3
``ticket_scan_plain``) and of ``MHKernel.sweep_once`` with the JAX
package's ``MHKernel._ticket_step``, on the CPU at float64.

The port receives the draws the JAX kernels take from their keys (a
uniform, or a standard gamma of shape ``par / tune``).  Every proposal kind
and likelihood class appears (the table has node priors, a brace and the
calibrated moves), under the full, univariate and no-likelihood kinds:
accept masks must be identical and the terms, distances, whitened residual
and state agree within 1e-10.
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
from mcmcdate_tpu_torch.kernels.accept_select import accept_select_plain
from mcmcdate_tpu_torch.kernels.ticket_step import TicketDraws, count_bad, \
    ticket_prologue_plain, ticket_scan_plain
from mcmcdate_tpu_torch.models import from_numpy
from mcmcdate_tpu_torch.models.state import FIELDS
from test_torch_mh import _draws, _rows_per_kind, close

C = 24
LIKS = ("full", "univariate", "none")
N_SCAN = 64


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    t = random_ultrametric_tree(rng, 12)
    topo = FlatTopology.from_tree(t)
    k = topo.n - 2
    s0 = j_init(t, topo)
    d0 = np.asarray(JH.distances_from_state(s0, topo))
    a = rng.normal(size=(k, k)) / np.sqrt(k)
    sigma = (a @ a.T + np.eye(k) * 0.1) * 1e-3
    mu = d0 * rng.uniform(0.9, 1.1, k)
    datas = {
        "full": jmvn.LikelihoodData.full(mu, np.linalg.inv(sigma), np.linalg.slogdet(sigma)[1]),
        "univariate": jmvn.LikelihoodData.univariate(mu, rng.uniform(1e-4, 1e-3, k)),
        "none": jmvn.LikelihoodData.none(),
    }
    inner = [int(i) for i in topo.inner_nodes if i]
    cal = jnp_.CalibrationSet(np.asarray([0, inner[1]], np.int32), np.asarray([0.8, 0.1]),
                              np.asarray([0.01, 0.02]), np.asarray([1.6, np.inf]),
                              np.asarray([0.01, 1.0]), names=("root", "a"))
    con = jnp_.ConstraintSet(np.asarray([inner[-1]], np.int32), np.asarray([inner[-2]], np.int32),
                             np.asarray([0.01]))
    br = jnp_.BraceSet(np.asarray([[inner[2], inner[-1]]], np.int32), np.asarray([0.05]),
                       names=("b",))
    table = JP.build_proposal_table(topo, br, True)
    h = np.asarray(s0.heights)[None].repeat(C, 0) * rng.uniform(0.95, 1.0, size=(C, 1))
    h[:, 0] = 1.0
    h[:, topo.is_leaf] = 0.0
    state = dict(heights=h, rates=rng.gamma(20.0, 0.05, size=(C, topo.n)),
                 birth=rng.uniform(0.5, 2, C), death=rng.uniform(0.1, 1, C),
                 height=rng.uniform(1.0, 1.4, C), rate_mean=rng.uniform(0.8, 1.2, C),
                 rate_var=rng.uniform(0.05, 0.5, C))
    js = JState(**{k2: jnp.asarray(v) for k2, v in state.items()})
    tuning = rng.uniform(0.3, 3.0, size=(C, table.n_proposals))
    out = {}
    kernels = JP.make_kernel_switch(topo, br)
    for lik, data in datas.items():
        jm = JModel(topo=topo, likelihood=data, calibrations=cal, constraints=con, braces=br,
                    mean_root_height=1.2)
        pm, ps = from_numpy(topo, data, state, calibrations=cal, constraints=con, braces=br,
                            mean_root_height=1.2, device="cpu")
        step = jmh.MHKernel(jm, table)._ticket_step(kernels, 1.0, jnp.float64)
        out[lik] = dict(jm=jm, pm=pm, ps=ps, step=jax.jit(step), tk=tmh.MHKernel(pm, table))
    # One ticket of every kind and every (class, kind) pair, with the draws
    # the JAX kernels take from the keys of PRNGKey(3).
    rows = _rows_per_kind(table)
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    _, k_prop, k_acc = _split3(keys)
    draws = {p: torch.as_tensor(np.array(_draws(table, p, k_prop, tuning))) for p in rows}
    one = dict(rows=rows, keys=keys, draws=draws, u=torch.as_tensor(_uniform(k_acc)))
    return topo, table, js, tuning, out, one


def _jcarry(jm, js, topo, tuning, keys):
    terms = jax.vmap(jm.log_prior_terms)(js)
    y = jax.vmap(jm.whitened_residual_internal)(js)
    d = jax.vmap(lambda s: JH.distances_internal(s, topo))(js)
    acc = jnp.zeros((C, len(tuning[0])), jnp.int32)
    return (js, terms, d, y, jnp.asarray(tuning), acc, keys)


def _split3(keys):
    k2 = jax.vmap(lambda kk: jax.random.split(kk, 3))(keys)
    return k2[:, 0], k2[:, 1], k2[:, 2]


def _uniform(keys):
    return np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, dtype=jnp.float64))(keys))


def _agree(lik, carry, j_out):
    """The port's carry against the JAX step's output carry."""
    j_batch, j_terms, j_d, j_y, _, j_acc, _ = j_out
    close(carry.terms, j_terms, rtol=1e-10, atol=1e-10)
    if lik != "none":
        close(carry.d, j_d, rtol=1e-10, atol=1e-10)
        close(carry.y, j_y, rtol=1e-10, atol=1e-10)
    for f in FIELDS:
        close(getattr(carry.batch, f), getattr(j_batch, f), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(carry.acc.numpy(), np.asarray(j_acc))


@pytest.mark.parametrize("lik", LIKS)
def test_ticket_per_kind_and_class(setup, lik):
    """One ticket of every kind and every (class, kind) pair: T1, K2 where
    the class needs it, K3, against the JAX step from the same carry."""
    topo, table, js, tuning, out, one = setup
    o = out[lik]
    tk = o["tk"]
    jc = _jcarry(o["jm"], js, topo, tuning, one["keys"])
    tuning_t = torch.as_tensor(tuning)
    rows = one["rows"]
    assert {int(table.kind[p]) for p in rows} == set(range(JP.N_KINDS))
    n_acc = 0
    for p in rows:
        j_out, _ = o["step"](jc, jnp.int32(p))
        carry = tk.init_carry(o["ps"])
        pro = ticket_prologue_plain(tk.tt, carry, tuning_t, p, one["draws"][p])
        dy, d_lik = tk._k2(carry, p, pro)
        accept, _ = accept_select_plain(tk.tt, carry, p, pro, one["u"], dy, d_lik)
        np.testing.assert_array_equal(accept.numpy(), np.asarray(j_out[5][:, p]) == 1,
                                      err_msg=table.names[p])
        n_acc += int(accept.sum())
        _agree(lik, carry, j_out)
    assert 0 < n_acc < C * len(rows)


@jax.jit
def _scan_draws(keys, order, shape, is_gamma):
    """Along the JAX step's key sequence over ``order``, each ticket's
    kernel draw (a standard gamma of shape ``shape[p]`` per chain, or a
    uniform) and its accept uniform, ``[n, C]`` each."""
    def one(keys, p):
        keys, k_prop, k_acc = _split3(keys)
        uni = jax.vmap(lambda kk: jax.random.uniform(kk, dtype=jnp.float64))(k_prop)
        gam = jax.vmap(lambda kk, a: jax.random.gamma(kk, a, dtype=jnp.float64))(
            k_prop, shape[:, p])
        u = jax.vmap(lambda kk: jax.random.uniform(kk, dtype=jnp.float64))(k_acc)
        return keys, (jnp.where(is_gamma[p], gam, uni), u)

    return jax.lax.scan(one, keys, order)[1]


@pytest.fixture(scope="module")
def orders(setup):
    """Two 64-ticket orders with the JAX step's draws: a run (no ticket
    that breaks one under a full MVN) and a slice of a sweep."""
    topo, table, js, tuning, out, _ = setup
    tickets = np.asarray(table.tickets)
    run_ok = np.asarray([not out["full"]["tk"].tt.breaks(int(p)) for p in tickets])
    rng = np.random.default_rng(7)
    shape = jnp.asarray(np.asarray(table.par)[None, :] / tuning)
    is_gamma = jnp.asarray(np.isin(table.kind, sorted(TP.GAMMA_KINDS)))
    res = {}
    for name, order in (("scan", rng.choice(tickets[run_ok], N_SCAN)),
                        ("sweep", rng.permutation(tickets)[:N_SCAN])):
        keys = jax.random.split(jax.random.PRNGKey(11), C)
        draws, u_acc = _scan_draws(keys, jnp.asarray(order, jnp.int32), shape, is_gamma)
        res[name] = (order, keys, torch.as_tensor(np.array(draws).T.copy()),
                     torch.as_tensor(np.array(u_acc).T.copy()))
    assert any(out["full"]["tk"].tt.breaks(int(p)) for p in res["sweep"][0])
    return res


@pytest.mark.parametrize("lik", LIKS)
def test_scan_and_sweep(setup, orders, lik):
    """``ticket_scan_plain`` over a fixed 64-ticket run and
    ``MHKernel.sweep_once(given=)`` over 64 tickets of every row (T3 runs
    and, under a full MVN, T1/K2/K3 tickets), each against the JAX step
    applied ticket after ticket over the same order, from the same keys."""
    topo, table, js, tuning, out, _ = setup
    o = out[lik]
    tk = o["tk"]
    tuning_t = torch.as_tensor(tuning)
    for name, (order, keys, draws, u_acc) in orders.items():
        jc = _jcarry(o["jm"], js, topo, tuning, keys)
        for p in order:
            jc, _ = o["step"](jc, jnp.int32(p))
        carry = tk.init_carry(o["ps"])
        if name == "scan":
            dr = TicketDraws(order, None, draws, None, None, None, u_acc)
            res = ticket_scan_plain(tk.tt, carry, tuning_t, dr, 0, N_SCAN)
            assert 0 < int(res.accept.sum()) < res.accept.numel()
        else:
            tk.sweep_once(carry, tuning_t, None, None, given=(order, draws, u_acc))
        _agree(lik, carry, jc)


def test_bad_carried_term_rejects(setup):
    """A chain whose carried terms hold one -inf rejects every ticket that
    leaves that entry alone (the JAX rule reads the whole new term vector);
    the other chains are unaffected."""
    topo, table, js, tuning, out, one = setup
    o = out["univariate"]
    tk = o["tk"]
    tuning_t = torch.as_tensor(tuning)
    leaf = int(np.nonzero(topo.is_leaf)[0][3])
    t_bad = 4 + (topo.n + 1) + leaf  # the leaf's clock entry
    c0 = 5
    touched = 0
    for p in one["rows"]:
        res = []
        for bad in (False, True):
            carry = tk.init_carry(o["ps"])
            if bad:
                carry.terms[c0, t_bad] = -np.inf
                carry.nbad = count_bad(carry.terms)
            pro = ticket_prologue_plain(tk.tt, carry, tuning_t, p, one["draws"][p])
            res.append((accept_select_plain(tk.tt, carry, p, pro, one["u"])[0], carry))
        (a_ok, c_ok), (a_bad, c_bad) = res
        others = torch.arange(C) != c0
        assert torch.equal(a_ok[others], a_bad[others])
        assert torch.equal(c_ok.terms[others], c_bad.terms[others])
        if t_bad in set(tk.tt.tix(p).tolist()):
            touched += 1
        else:
            assert not bool(a_bad[c0]), table.names[p]
            assert c_bad.terms[c0, t_bad] == -np.inf
    assert touched > 0
