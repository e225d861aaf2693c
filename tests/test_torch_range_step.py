"""The likelihood range-block step of the ticket-batched sweep (K5: the
prologue, the Gram-and-scan and the epilogue) through its plain versions,
on the CPU at float64.  ``FastSweeps.range_lik_step`` on CPU tensors (the
composed plain pieces) against a ticket-by-ticket evaluation of the full
log posterior on every block of both kinds under every clock model, and
the replay at given proposals (``range_lik_given``, which the card's check
uses) against the composed step, with forced decisions."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from mcmcdate_tpu_torch import synthetic
from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP
from mcmcdate_tpu_torch.kernels import range_step as K5
from mcmcdate_tpu_torch.kernels.whiten import whiten_plain
from mcmcdate_tpu_torch.models.state import FIELDS, State
from mcmcdate_tpu_torch.ops import clocks
from mcmcdate_tpu_torch.ops.heights import distances_internal
from mcmcdate_tpu_torch.ops.node_priors import CalibrationSet

F64 = torch.float64
C = 32
KINDS = {"ultrametric": TP.K_SCALE_SUBTREE_ULTRA, "rate": TP.K_SCALE_SUBTREE_RATE}


def _case(clock, seed=0):
    """A calibrated 14-taxon float64 model with a full MVN likelihood, a
    perturbed chain batch, its FastSweeps, carry (z and q filled) and a
    tuning."""
    model, batch = synthetic.build(14, C, dtype=F64, device="cpu", seed=seed, clock=clock)
    inner = [int(i) for i in model.topo.inner_nodes if i]
    cal = CalibrationSet(node=np.asarray([0, inner[1], inner[4]], np.int32),
                         lower=np.asarray([0.8, 0.1, 0.0]), lower_pm=np.asarray([0.01, 0.02, 1.0]),
                         upper=np.asarray([1.6, np.inf, 0.9]),
                         upper_pm=np.asarray([0.01, 1.0, 0.05]), names=("root", "a", "b"))
    model = dataclasses.replace(model, calibrations=cal)
    rng = np.random.default_rng(seed + 1)
    h = batch.heights * torch.as_tensor(rng.uniform(0.9, 1.0, size=(C, 1)))
    h[:, 0] = 1.0
    h[:, model.topo.is_leaf_t] = 0.0
    batch = batch.replace(heights=h, rate_var=torch.as_tensor(rng.uniform(0.05, 0.5, C)),
                          birth=torch.as_tensor(rng.uniform(0.5, 2.0, C)),
                          death=torch.as_tensor(rng.uniform(0.1, 1.0, C)))
    table = TP.build_proposal_table(model.topo, model.braces, model.calibrations_available)
    fs = TF.FastSweeps(model, table)
    carry = fs.init_carry(batch)
    carry.z, carry.q = fs._zq_from_y(model.whitened_residual_internal(carry.batch))
    tuning = torch.as_tensor(rng.uniform(0.3, 3.0, size=(C, table.n_proposals)))
    return model, fs, carry, tuning, rng


def _draws(rng, rate, sx, tuning):
    n = sx["rows"].shape[0]
    if rate:
        shape = (sx["sd"] / tuning[:, sx["rows"]]).numpy()
        draw = torch.as_tensor(rng.standard_gamma(shape))
    else:
        draw = torch.as_tensor(rng.uniform(size=(C, n)))
    return draw, torch.as_tensor(rng.uniform(size=(C, n)))


def _copy(batch):
    return State(**{f: getattr(batch, f).clone() for f in FIELDS})


def _log_post(model, st):
    """Full log posterior per chain, evaluated afresh."""
    d = distances_internal(st, model.topo)
    _, quad = whiten_plain(d, model.chol_internal_t, sub=model.mu_internal_t)
    return model.log_prior_terms(st).sum(-1) - 0.5 * quad


def _ticket_by_ticket(model, batch, sx, rate, prop, lq, u_acc):
    """Each ticket in turn on the whole state: scale its subtree's heights
    (ultrametric, by ``prop / h``) or rates (rate, by ``prop``) and accept
    on the fresh log posterior ratio plus ``lq``."""
    st = _copy(batch)
    lp = _log_post(model, st)
    accept = torch.zeros(u_acc.shape, dtype=torch.bool)
    for s in range(u_acc.shape[1]):
        rows = sx["own"][s][sx["own"][s] >= 0].long()
        new = _copy(st)
        if rate:
            new.rates[:, rows] = st.rates[:, rows] * prop[:, s, None]
        else:
            f = prop[:, s] / st.heights[:, int(sx["node"][s])]
            new.heights[:, rows] = f[:, None] * st.heights[:, rows]
        lp_new = _log_post(model, new)
        la = torch.nan_to_num(lp_new - lp + lq[:, s], nan=-math.inf)
        a = torch.log(u_acc[:, s]) < la
        accept[:, s] = a
        st = State(**{f: torch.where(a[:, None] if getattr(st, f).dim() > 1 else a,
                                     getattr(new, f), getattr(st, f)) for f in FIELDS})
        lp = torch.where(a, lp_new, lp)
    return accept, st


def _close(a, b, tol=1e-10):
    scale = max(1.0, float(b.abs().max()))
    torch.testing.assert_close(a, b, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("clock", clocks.MODELS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_range_step_matches_ticket_by_ticket(kind, clock):
    rate = kind == "rate"
    model, fs, carry, tuning, rng = _case(clock)
    leaf = model.topo.is_leaf_t
    n_acc = n_tickets = 0
    for (k, _), steps in fs.range_t.items():
        if k != KINDS[kind]:
            continue
        for sx in steps:
            draw, u_acc = _draws(rng, rate, sx, tuning)
            before = _copy(carry.batch)
            acc0 = carry.acc.clone()
            # The proposals of the composed step, from the same draws.
            pro = K5.range_lik_prologue_plain(rate, carry.batch, carry.terms, carry.d, carry.z,
                                              tuning, sx, leaf, model.clock, draw)
            accept = fs.range_lik_step(KINDS[kind], carry, tuning, sx, draw, u_acc)
            ref_acc, ref = _ticket_by_ticket(model, before, sx, rate, pro.prop, pro.lq, u_acc)
            assert torch.equal(accept, ref_acc)
            for f in FIELDS:
                _close(getattr(carry.batch, f), getattr(ref, f), 1e-12)
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
def test_range_lik_given_replays_and_forces_decisions(kind):
    rate = kind == "rate"
    model, fs, carry, tuning, rng = _case(clocks.MODELS[0], seed=2)
    leaf = model.topo.is_leaf_t
    (k, _), steps = next(item for item in fs.range_t.items() if item[0][0] == KINDS[kind])
    sx = max(steps, key=lambda b: b["rows"].shape[0])  # the block with the most tickets
    draw, u_acc = _draws(rng, rate, sx, tuning)

    def fresh():
        return (_copy(carry.batch), carry.terms.clone(), carry.d.clone(), carry.z.clone(),
                carry.q.clone(), carry.acc.clone())

    step = TF.FastCarry(*fresh())
    pro = K5.range_lik_prologue(rate, step.batch, step.terms, step.d, step.z, tuning, sx, leaf,
                                model.clock, draw)  # CPU: the plain version
    accept = fs.range_lik_step(k, step, tuning, sx, draw, u_acc)
    st, terms, d, z, q, acc = fresh()
    acc_r, pro_r, dq = K5.range_lik_given(rate, st, terms, d, z, q, acc, tuning, sx, leaf,
                                          model.clock, pro.prop, u_acc)
    assert torch.equal(acc_r, accept)
    for a, b in zip(pro_r, pro):
        assert (a is None and b is None) or torch.equal(a, b)
    for f in FIELDS:
        assert torch.equal(getattr(st, f), getattr(step.batch, f))
    for a, b in ((terms, step.terms), (d, step.d), (z, step.z), (q, step.q), (acc, step.acc)):
        assert torch.equal(a, b)
    # u = 0 accepts every ticket whose log alpha is finite, u = NaN none.
    flip = ~accept & torch.isfinite(pro.lmhg)
    assert flip.any() and accept.any()
    forced = torch.where(accept | flip, 0.0, math.nan).to(F64)
    st, terms, d, z, q, acc = fresh()
    acc_f, _, dq_f = K5.range_lik_given(rate, st, terms, d, z, q, acc, tuning, sx, leaf,
                                        model.clock, pro.prop, forced)
    assert torch.equal(acc_f, accept | flip)
    assert torch.isfinite(dq_f).all()
