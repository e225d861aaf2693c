"""The likelihood point step of the ticket-batched sweep (K4: the prologue,
the correction scan and the epilogue) through its plain versions, on the
CPU at float64: ``FastSweeps.point_lik_step``, which on the CPU composes
``point_lik_prologue_plain`` -> ``point_scan_plain`` ->
``point_lik_epilogue_plain`` and ``z += dacc @ Prow``, against the JAX
package's ``FastSweeps._mega_point_lik`` with injected draws (both point
kinds, with the full likelihood and with none), against a ticket-by-ticket evaluation of the full log posterior, and the
replay at given proposals (``point_lik_given``, which the card's check
uses) against the composed step, with forced decisions."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcdate_tpu.engine import proposals as JP
from mcmcdate_tpu_torch import synthetic
from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP
from mcmcdate_tpu_torch.kernels import point_step as K4
from mcmcdate_tpu_torch.kernels.whiten import whiten_plain
from mcmcdate_tpu_torch.models.state import FIELDS, State
from mcmcdate_tpu_torch.ops.heights import distances_internal
from mcmcdate_tpu_torch.ops.node_priors import CalibrationSet
from torch_fast_common import C as JC, Case, close, t

F64 = torch.float64
KINDS = {"slide": TP.K_SLIDE_NODE_ULTRA, "branch": TP.K_SCALE_BRANCH_RATE}


@functools.lru_cache(maxsize=None)
def _jax_case(lik):
    return Case(lik, priors=True)


@pytest.mark.parametrize("lik", ("full", "none"))
@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_point_step_matches_jax(kind, lik):
    cs = _jax_case(lik)
    k = KINDS[kind]
    spec = cs.jfs.plan.specs[k]
    step, nspec = cs.jfs._mega_point_lik(spec, jnp.float64)
    step = jax.jit(step)
    js, terms, d, z, q = cs.jcarry()
    tuning = jnp.asarray(cs.tuning)
    acc = jnp.zeros((JC, cs.table.n_proposals), jnp.int32)
    port, ptun = cs.pcarry(), t(cs.tuning)
    key = jax.random.PRNGKey(100 + k)
    n_acc = 0
    for m in range(spec.n_mega):
        key, km = jax.random.split(key)
        sx = {name: v[m] for name, v in nspec.items()}
        k1, k2 = jax.random.split(km)
        if k == JP.K_SCALE_BRANCH_RATE:
            draw = jax.random.gamma(k1, jnp.asarray(sx["sd"]) / tuning[:, sx["rows"]],
                                    dtype=jnp.float64)
        else:
            draw = jax.random.uniform(k1, (JC, spec.b), jnp.float64)
        u_acc = jax.random.uniform(k2, (JC, spec.b), jnp.float64)
        acc0 = acc
        (js, terms, d, z, q, _, acc, _), _ = step((js, terms, d, z, q, tuning, acc, key),
                                                  (sx, km))
        psx = cs.pfs.spec_t[k][m]
        n = psx["rows"].shape[0]
        accept = cs.pfs.point_lik_step(k, port, ptun, psx, t(draw[:, :n]), t(u_acc[:, :n]))
        ref = (np.asarray(acc) - np.asarray(acc0))[:, np.asarray(sx["rows"])] == 1
        np.testing.assert_array_equal(accept.numpy(), ref[:, :n] & np.asarray(sx["valid"])[:n])
        n_acc += int(accept.sum())
        for f in ("heights", "rates"):
            close(getattr(port.batch, f), getattr(js, f))
        close(port.terms, terms)
        close(port.d, d)
        if cs.pfs.use_lik:
            close(port.z, z)
            close(port.q, q)
        np.testing.assert_array_equal(port.acc.numpy(), np.asarray(acc))
    assert 0 < n_acc


C = 32


@functools.lru_cache(maxsize=None)
def _case():
    """A calibrated 14-taxon float64 model with a full MVN likelihood and a
    perturbed chain batch (built once; each test takes its own carry)."""
    model, batch = synthetic.build(14, C, dtype=F64, device="cpu", seed=4)
    inner = [int(i) for i in model.topo.inner_nodes if i]
    cal = CalibrationSet(node=np.asarray([0, inner[1], inner[4]], np.int32),
                         lower=np.asarray([0.8, 0.1, 0.0]), lower_pm=np.asarray([0.01, 0.02, 1.0]),
                         upper=np.asarray([1.6, np.inf, 0.9]),
                         upper_pm=np.asarray([0.01, 1.0, 0.05]), names=("root", "a", "b"))
    model = dataclasses.replace(model, calibrations=cal)
    rng = np.random.default_rng(5)
    h = batch.heights * torch.as_tensor(rng.uniform(0.9, 1.0, size=(C, 1)))
    h[:, 0] = 1.0
    h[:, model.topo.is_leaf_t] = 0.0
    batch = batch.replace(heights=h, rate_var=torch.as_tensor(rng.uniform(0.05, 0.5, C)),
                          birth=torch.as_tensor(rng.uniform(0.5, 2.0, C)),
                          death=torch.as_tensor(rng.uniform(0.1, 1.0, C)))
    table = TP.build_proposal_table(model.topo, model.braces, model.calibrations_available)
    fs = TF.FastSweeps(model, table)
    tuning = torch.as_tensor(rng.uniform(0.3, 3.0, size=(C, table.n_proposals)))
    return model, batch, fs, tuning


def _carry():
    model, batch, fs, tuning = _case()
    carry = fs.init_carry(batch)
    carry.z, carry.q = fs._zq_from_y(model.whitened_residual_internal(carry.batch))
    return model, fs, carry, tuning


def _draws(rng, branch, sx, tuning):
    n = sx["rows"].shape[0]
    if branch:
        draw = torch.as_tensor(rng.standard_gamma((sx["sd"] / tuning[:, sx["rows"]]).numpy()))
    else:
        draw = torch.as_tensor(rng.uniform(size=(C, n)))
    return draw, torch.as_tensor(rng.uniform(size=(C, n)))


def _copy(batch):
    return State(**{f: getattr(batch, f).clone() for f in FIELDS})


def _log_post(model, st):
    d = distances_internal(st, model.topo)
    _, quad = whiten_plain(d, model.chol_internal_t, sub=model.mu_internal_t)
    return model.log_prior_terms(st).sum(-1) - 0.5 * quad


def _close(a, b, tol=1e-10):
    torch.testing.assert_close(a, b, rtol=0, atol=tol * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("kind", list(KINDS))
def test_point_step_matches_ticket_by_ticket(kind):
    """Every step of the kind, each against its tickets in order on the
    whole state: move the node's height to the proposal (slide) or scale its
    rate by it (branch) and accept on the fresh log posterior ratio plus
    ``lq``."""
    branch = kind == "branch"
    model, fs, carry, tuning = _carry()
    leaf = model.topo.is_leaf_t
    rng = np.random.default_rng(6)
    n_acc = n_tickets = 0
    for sx in fs.spec_t[KINDS[kind]]:
        draw, u_acc = _draws(rng, branch, sx, tuning)
        st = _copy(carry.batch)
        pro = K4.point_lik_prologue_plain(branch, carry.batch, carry.terms, carry.d, carry.z,
                                          tuning, sx, leaf, fs.pos_t, model.clock, draw)
        acc0 = carry.acc.clone()
        accept = fs.point_lik_step(KINDS[kind], carry, tuning, sx, draw, u_acc)
        lp = _log_post(model, st)
        for b in range(u_acc.shape[1]):
            i = int(sx["node"][b])
            new = _copy(st)
            if branch:
                new.rates[:, i] = st.rates[:, i] * pro.prop[:, b]
            else:
                new.heights[:, i] = pro.prop[:, b]
            lp_new = _log_post(model, new)
            a = torch.log(u_acc[:, b]) < torch.nan_to_num(lp_new - lp + pro.lq[:, b],
                                                          nan=-math.inf)
            assert torch.equal(accept[:, b], a)
            st = State(**{f: torch.where(a[:, None] if getattr(st, f).dim() > 1 else a,
                                         getattr(new, f), getattr(st, f)) for f in FIELDS})
            lp = torch.where(a, lp_new, lp)
        for f in FIELDS:
            _close(getattr(carry.batch, f), getattr(st, f), 1e-12)
        _close(carry.terms, model.log_prior_terms(carry.batch))
        d = distances_internal(carry.batch, model.topo)
        _close(carry.d, d, 1e-12)
        z = (d - fs.mu) @ fs.P
        _close(carry.z, z)
        _close(carry.q, ((d - fs.mu) * z).sum(-1))
        assert torch.equal((carry.acc - acc0)[:, sx["rows"]], accept.to(carry.acc.dtype))
        n_acc += int(accept.sum())
        n_tickets += accept.numel()
    assert 0 < n_acc < n_tickets


@pytest.mark.parametrize("kind", list(KINDS))
def test_point_lik_given_replays_and_forces_decisions(kind):
    branch = kind == "branch"
    model, fs, carry, tuning = _carry()
    leaf = model.topo.is_leaf_t
    sx = fs.spec_t[KINDS[kind]][0]
    draw, u_acc = _draws(np.random.default_rng(7), branch, sx, tuning)

    def fresh():
        return (_copy(carry.batch), carry.terms.clone(), carry.d.clone(), carry.z.clone(),
                carry.q.clone(), carry.acc.clone())

    step = TF.FastCarry(*fresh())
    pro = K4.point_lik_prologue(branch, step.batch, step.terms, step.d, step.z, tuning, sx, leaf,
                                fs.pos_t, model.clock, draw)  # CPU: the plain version
    accept = fs.point_lik_step(KINDS[kind], step, tuning, sx, draw, u_acc)
    st, terms, d, z, q, acc = fresh()
    acc_r, pro_r, dq = K4.point_lik_given(branch, st, terms, d, z, q, acc, tuning, sx, leaf,
                                          fs.pos_t, model.clock, pro.prop, u_acc)
    assert torch.equal(acc_r, accept)
    for a, b in zip(pro_r, pro):
        assert torch.equal(a, b)
    for f in FIELDS:
        assert torch.equal(getattr(st, f), getattr(step.batch, f))
    for a, b in ((terms, step.terms), (d, step.d), (z, step.z), (q, step.q), (acc, step.acc)):
        assert torch.equal(a, b)
    # u = 0 accepts every ticket whose log alpha is finite, u = NaN none.
    flip = ~accept & torch.isfinite(pro.lmhg)
    assert flip.any() and accept.any()
    forced = torch.where(accept | flip, 0.0, math.nan).to(F64)
    st, terms, d, z, q, acc = fresh()
    acc_f, _, dq_f = K4.point_lik_given(branch, st, terms, d, z, q, acc, tuning, sx, leaf,
                                        fs.pos_t, model.clock, pro.prop, forced)
    assert torch.equal(acc_f, accept | flip)
    assert torch.isfinite(dq_f).all()
