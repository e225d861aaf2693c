"""The port's decisions under a per-chain prior temperature (MC3's
``beta_prior``) against the JAX package's, on the CPU at float64 with
injected draws: the sequential sweep's tickets (K3 and T3's plain versions)
against ``MHKernel._ticket_step``, the glob families (G1's and G3's)
against ``FastSweeps._glob_step``, the likelihood point steps (K4's scan)
and range blocks (K5's) against ``_mega_point_lik`` and
``_mega_range_lik``, the same without a likelihood (the K4 and K5
epilogues' own decisions), and both contrary steps (K6) against
``_mega_contra_slide`` and ``_mega_range_contra``.  ``beta_prior`` is the
4-rung MC3 ladder tiled over the chains and the likelihood temperature
``beta`` differs from it, so that a site that read one for the other would
fail.  Accept masks must be identical, and the state, terms, d, z, q (or
y) agree within 1e-10 of scale."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcdate_tpu.engine import mh as jmh, proposals as JP
from mcmcdate_tpu.models import DatingModel as JModel, init_state as j_init
from mcmcdate_tpu.models.state import State as JState
from mcmcdate_tpu.ops import heights as JH, mvn as jmvn, node_priors as jnp_
from mcmcdate_tpu.tree import FlatTopology
from mcmcdate_tpu.utils.simulate import random_ultrametric_tree
from mcmcdate_tpu_torch.engine import fast_sweep as TF, mc3 as TM, mh as tmh, proposals as TP
from mcmcdate_tpu_torch.kernels.ticket_step import TicketDraws, ticket_scan_plain
from mcmcdate_tpu_torch.models import from_numpy
from test_torch_ticket_step import _agree, _scan_draws
from torch_fast_common import C, Case, close, t

F64 = jnp.float64
BETA_PRIOR = np.tile(TM.ladder_of([0.4, 0.7, 1.1]), C // TM.N_TEMPS)
BETA = np.resize([0.6, 1.0, 0.2], C)
N_TICKETS = 64


@functools.lru_cache(maxsize=None)
def case(lik):
    return Case(lik, priors=True)


def _temper(carry):
    carry.beta = torch.as_tensor(BETA)
    carry.beta_prior = torch.as_tensor(BETA_PRIOR)
    return carry


def _jbetas():
    return dict(beta=jnp.asarray(BETA), beta_prior=jnp.asarray(BETA_PRIOR))


# -- K3 and T3: the sequential sweep's tickets -----------------------------------


@pytest.fixture(scope="module")
def tickets():
    """A 12-leaf model with node priors under the full and univariate kinds
    (every proposal kind), the JAX step at both temperatures, and 64
    tickets of a drawn order with the draws the JAX step takes."""
    rng = np.random.default_rng(29)
    tree = random_ultrametric_tree(rng, 12)
    topo = FlatTopology.from_tree(tree)
    k = topo.n - 2
    s0 = j_init(tree, topo)
    d0 = np.asarray(JH.distances_from_state(s0, topo))
    a = rng.normal(size=(k, k)) / np.sqrt(k)
    sigma = (a @ a.T + np.eye(k) * 0.1) * 1e-3
    mu = d0 * rng.uniform(0.9, 1.1, k)
    datas = {"full": jmvn.LikelihoodData.full(mu, np.linalg.inv(sigma),
                                              np.linalg.slogdet(sigma)[1]),
             "univariate": jmvn.LikelihoodData.univariate(mu, rng.uniform(1e-4, 1e-3, k))}
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
    kernels = JP.make_kernel_switch(topo, br)
    out = {}
    for lik, data in datas.items():
        jm = JModel(topo=topo, likelihood=data, calibrations=cal, constraints=con, braces=br,
                    mean_root_height=1.2)
        pm, ps = from_numpy(topo, data, state, calibrations=cal, constraints=con, braces=br,
                            mean_root_height=1.2, device="cpu")
        step = jmh.MHKernel(jm, table)._ticket_step(kernels, jnp.asarray(BETA), F64,
                                                     jnp.asarray(BETA_PRIOR))
        out[lik] = dict(jm=jm, ps=ps, step=jax.jit(step), tk=tmh.MHKernel(pm, table))
    order = rng.permutation(np.asarray(table.tickets))[:N_TICKETS].astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(17), C)
    shape = jnp.asarray(np.asarray(table.par)[None, :] / tuning)
    is_gamma = jnp.asarray(np.isin(table.kind, sorted(TP.GAMMA_KINDS)))
    draws, u_acc = _scan_draws(keys, jnp.asarray(order), shape, is_gamma)
    dr = TicketDraws(order, None, torch.as_tensor(np.array(draws).T.copy()), None, None, None,
                     torch.as_tensor(np.array(u_acc).T.copy()))
    return topo, js, tuning, keys, dr, out


@pytest.mark.parametrize("lik", ("full", "univariate"))
def test_prior_tempered_tickets_match_jax(tickets, lik):
    """Ticket after ticket: T3's plain scan for a ticket that does not break
    a run, T1, K2 and K3's for one that does, each decision against the
    JAX step at both temperatures from the same carry."""
    topo, js, tuning, keys, dr, out = tickets
    o = out[lik]
    tk = o["tk"]
    tun = torch.as_tensor(tuning)
    jm = o["jm"]
    jc = (js, jax.vmap(jm.log_prior_terms)(js),
          jax.vmap(lambda s: JH.distances_internal(s, topo))(js),
          jax.vmap(jm.whitened_residual_internal)(js), jnp.asarray(tuning),
          jnp.zeros((C, tuning.shape[1]), jnp.int32), keys)
    carry = _temper(tk.init_carry(o["ps"]))
    n_acc = n_break = 0
    for j, p in enumerate(dr.order_host):
        acc0 = np.asarray(jc[5][:, p])
        jc, _ = o["step"](jc, jnp.int32(p))
        ref = (np.asarray(jc[5][:, p]) - acc0) == 1
        if tk.tt.breaks(int(p)):
            accept = tk._one(carry, tun, dr, j)
            n_break += 1
        else:
            accept = ticket_scan_plain(tk.tt, carry, tun, dr, j, 1).accept[:, 0]
        np.testing.assert_array_equal(accept.numpy(), ref, err_msg=f"ticket {j}, row {p}")
        n_acc += int(accept.sum())
    _agree(lik, carry, jc)
    assert 0 < n_acc < C * len(dr.order_host)
    assert n_break > 0 or lik != "full"


# -- G1 and G3: the glob families ---------------------------------------------------


@pytest.mark.parametrize("tag", ("bd_scale", "height", "var_tree", "sub_ultra"))
def test_prior_tempered_glob_matches_jax(tag):
    """The first tickets of a G1 family without a likelihood term
    (bd_scale), one that scales distances uniformly (height) and two dense
    G3 families (var_tree; sub_ultra over its support rows) against
    ``_glob_step`` at both temperatures."""
    cs = case("full")
    grp = cs.jfs.plan.glob_groups[tag]
    pgrp = cs.pfs.plan.glob_groups[tag]
    step = cs.jfs._glob_step(tag, F64, **_jbetas())
    js, terms, d, z, q = cs.jcarry()
    port = _temper(cs.pcarry())
    key = jax.random.PRNGKey(len(tag) + 11)
    n_acc = n = 0
    for s in range(min(3, grp.n_tickets)):
        key, kt = jax.random.split(key)
        sx = {"sd": jnp.asarray(grp.sd[s], F64), "aux": grp.aux[s], "lo": grp.lo[s],
              "hi": grp.hi[s], "n_inner": grp.n_inner[s], "n_nodes": grp.n_nodes[s],
              "rj": grp.rj[s]}
        tune = jnp.asarray(cs.tuning[:, grp.rows[s]])
        k1, k2 = jax.random.split(kt)
        draw = (jax.random.gamma(k1, sx["sd"] / tune, dtype=F64) if tag in TF.GAMMA_TAGS
                else jax.random.uniform(k1, (C,), F64))
        u_acc = jax.random.uniform(k2, (C,), F64)
        (js, terms, d, z, q), ref = step((js, terms, d, z, q), (sx, kt, tune))
        psx = dict(sd=pgrp.sd[s], aux=pgrp.aux[s], lo=pgrp.lo[s], hi=pgrp.hi[s],
                   n_inner=pgrp.n_inner[s], n_nodes=pgrp.n_nodes[s], rj=bool(pgrp.rj[s]))
        accept = cs.pfs.glob_step(tag, port, t(tune), psx, t(draw), t(u_acc))
        np.testing.assert_array_equal(accept.numpy(), np.asarray(ref), err_msg=tag)
        n_acc += int(accept.sum())
        n += C
    for f in ("heights", "rates", "birth", "death", "height", "rate_mean", "rate_var"):
        close(getattr(port.batch, f), getattr(js, f))
    close(port.terms, terms)
    close(port.d, d)
    close(port.z, z)
    close(port.q, q)
    assert 0 < n_acc < n


# -- K4, K5, K6: the point steps and range blocks --------------------------------------


def _check_accept(accept, acc0, acc1, rows, valid):
    ref = (np.asarray(acc1) - np.asarray(acc0))[:, np.asarray(rows)] * np.asarray(valid) == 1
    np.testing.assert_array_equal(accept.numpy(), ref[:, :accept.shape[1]])


def _close_fast(cs, port, js, terms, d, z, q, acc):
    for f in ("heights", "rates", "birth", "death", "height", "rate_mean", "rate_var"):
        close(getattr(port.batch, f), getattr(js, f))
    close(port.terms, terms)
    close(port.d, d)
    if cs.pfs.use_lik:
        close(port.z, z)
        close(port.q, q)
    np.testing.assert_array_equal(port.acc.numpy(), np.asarray(acc))


@pytest.mark.parametrize("kind,lik", ((JP.K_SLIDE_NODES_CONTRA, "full"),
                                      (JP.K_SLIDE_NODE_ULTRA, "full"),
                                      (JP.K_SCALE_BRANCH_RATE, "full"),
                                      (JP.K_SLIDE_NODE_ULTRA, "none"),
                                      (JP.K_SCALE_BRANCH_RATE, "none")))
def test_prior_tempered_point_steps_match_jax(kind, lik):
    """Every mega-step of a point kind: K6's contrary slides, K4's
    likelihood-coupled slides and branch-rate scales (its scan's
    decisions) and, without a likelihood, K4's epilogue's decisions,
    against the JAX steps at both temperatures."""
    cs = case(lik)
    jfs, pfs = cs.jfs, cs.pfs
    spec = jfs.plan.specs[kind]
    contra = kind == JP.K_SLIDE_NODES_CONTRA
    if contra:
        step, nspec = jfs._mega_contra_slide(spec, F64, beta_prior=jnp.asarray(BETA_PRIOR))
    else:
        step, nspec = jfs._mega_point_lik(spec, F64, **_jbetas())
    step = jax.jit(step)
    js, terms, d, z, q = cs.jcarry()
    tuning = jnp.asarray(cs.tuning)
    acc = jnp.zeros((C, cs.table.n_proposals), jnp.int32)
    port = _temper(cs.pcarry())
    ptun = t(cs.tuning)
    key = jax.random.PRNGKey(kind + 9)
    n_acc = 0
    for m in range(spec.n_mega):
        key, km = jax.random.split(key)
        sx = {k: v[m] for k, v in nspec.items()}
        k1, k2 = jax.random.split(km)
        if kind == JP.K_SCALE_BRANCH_RATE:
            draw = jax.random.gamma(k1, jnp.asarray(sx["sd"], F64) / tuning[:, sx["rows"]],
                                    dtype=F64)
        else:
            draw = jax.random.uniform(k1, (C, spec.b), F64)
        u_acc = jax.random.uniform(k2, (C, spec.b), F64)
        acc0 = acc
        if contra:
            (js, terms, _, acc, _), _ = step((js, terms, tuning, acc, key), (sx, km))
        else:
            (js, terms, d, z, q, _, acc, _), _ = step((js, terms, d, z, q, tuning, acc, key),
                                                      (sx, km))
        psx = pfs.spec_t[kind][m]
        n = psx["rows"].shape[0]
        if contra:
            accept = pfs.contra_slide_step(port, ptun, psx, t(draw[:, :n]), t(u_acc[:, :n]))
        else:
            accept = pfs.point_lik_step(kind, port, ptun, psx, t(draw[:, :n]), t(u_acc[:, :n]))
        _check_accept(accept, acc0, acc, sx["rows"], sx["valid"])
        n_acc += int(accept.sum())
        _close_fast(cs, port, js, terms, d, z, q, acc)
    assert n_acc > 0


@pytest.mark.parametrize("kind,lik", ((JP.K_SCALE_SUBTREES_CONTRA, "full"),
                                      (JP.K_SCALE_SUBTREE_ULTRA, "full"),
                                      (JP.K_SCALE_SUBTREE_RATE, "full"),
                                      (JP.K_SCALE_SUBTREE_ULTRA, "none"),
                                      (JP.K_SCALE_SUBTREE_RATE, "none")))
def test_prior_tempered_range_steps_match_jax(kind, lik):
    """Every block of a range kind: K6's contrary subtree scales, K5's
    likelihood-coupled ones (its scan's decisions) and, without a
    likelihood, K5's epilogue's decisions, against the JAX steps at both
    temperatures (pad slots drawn with sd 1, as in
    test_torch_fast_sweep_steps.py)."""
    cs = case(lik)
    jfs, pfs = cs.jfs, cs.pfs
    js, terms, d, z, q = cs.jcarry()
    tuning = jnp.asarray(cs.tuning)
    acc = jnp.zeros((C, cs.table.n_proposals), jnp.int32)
    port = _temper(cs.pcarry())
    ptun = t(cs.tuning)
    hT, rT, teT, dT, zT = js.heights.T, js.rates.T, terms.T, d.T, z.T
    scal = (js.birth, js.death, js.rate_var, js.height * js.rate_mean, js.height)
    contra = kind == JP.K_SCALE_SUBTREES_CONTRA
    keys = [k for k in jfs.plan.range_specs if k[0] == kind]
    assert keys
    n_acc = 0
    for key_r in keys:
        spec = jfs.plan.range_specs[key_r]
        spec = dataclasses.replace(spec, sd=np.where(spec.valid, spec.sd, 1.0))
        if contra:
            step, nspec = jfs._mega_range_contra(spec, F64, beta_prior=jnp.asarray(BETA_PRIOR))
        else:
            step, nspec = jfs._mega_range_lik(spec, F64, **_jbetas())
        step = jax.jit(step)
        key = jax.random.PRNGKey(key_r[1] + 5)
        for m in range(spec.n_blocks):
            key, km = jax.random.split(key)
            sx = {k: v[m] for k, v in nspec.items()}
            k1, k2 = jax.random.split(km)
            shape = (spec.rows.shape[1], C)
            if kind == JP.K_SCALE_SUBTREE_RATE:
                draw = jax.random.gamma(
                    k1, jnp.asarray(sx["sd"], F64)[:, None] / tuning.T[sx["rows"]], dtype=F64)
            else:
                draw = jax.random.uniform(k1, shape, F64)
            u_acc = jax.random.uniform(k2, shape, F64)
            acc0 = acc
            (hT, rT, teT, dT, zT, q, _, _, acc, _), _ = step(
                (hT, rT, teT, dT, zT, q, scal, tuning.T, acc, key), (sx, km))
            psx = pfs.range_t[key_r][m]
            n = psx["rows"].shape[0]
            draw, u_acc = t(draw[:n].T), t(u_acc[:n].T)
            if contra:
                accept = pfs.range_contra_step(port, ptun, psx, draw, u_acc)
            else:
                accept = pfs.range_lik_step(kind, port, ptun, psx, draw, u_acc)
            _check_accept(accept, acc0, acc, sx["rows"], sx["valid"])
            n_acc += int(accept.sum())
            _close_fast(cs, port, js.replace(heights=hT.T, rates=rT.T), teT.T, dT.T, zT.T, q,
                        acc)
    assert n_acc > 0


# -- beta_prior None: the untempered bits ---------------------------------------------


@pytest.mark.parametrize("lik", ("full", "none"))
def test_beta_prior_none_is_untempered(lik):
    """A whole FastSweeps sweep with ``carry.beta_prior`` None and with a
    ones vector (the likelihood tempered alike), from the same carry and
    seeds: bitwise the same state, terms, d, z, q and accept counts."""
    cs = case(lik)
    fs = cs.pfs
    outs = []
    for beta_prior in (None, torch.ones(C, dtype=torch.float64)):
        carry = cs.pcarry()
        carry.beta = torch.as_tensor(BETA)
        carry.beta_prior = beta_prior
        y = cs.pm.whitened_residual_internal(carry.batch)
        y = fs.sweep_once(carry, y, t(cs.tuning), torch.Generator().manual_seed(6),
                          torch.Generator().manual_seed(6))
        outs.append((carry, y))
    (a, ya), (b, yb) = outs
    for f in ("heights", "rates", "birth", "death", "height", "rate_mean", "rate_var"):
        assert torch.equal(getattr(a.batch, f), getattr(b.batch, f)), f
    for f in ("terms", "d", "z", "q", "acc"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(ya, yb)
    assert int(a.acc.sum()) > 0
