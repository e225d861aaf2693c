"""The plain versions of the batched sweep's kernels (K4 ``point_scan``, K5
``range_scan``, K6 ``contra_slide`` / ``contra_range``), which CPU tensors
take, on their own at float64: the correction scans against a ticket-by-ticket
evaluation of the quadratic form; the contrary steps keep every branch
distance, carry terms equal to a fresh evaluation of the new state under
every clock model, and their replay at given proposals (what the card's
check uses) reproduces a step and takes forced decisions; the range
kernel's lane groups hold every row of the planner's buckets."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from mcmcdate_tpu_torch import synthetic
from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP
from mcmcdate_tpu_torch.kernels import contra_step as K6
from mcmcdate_tpu_torch.kernels.point_scan import point_scan, point_scan_plain
from mcmcdate_tpu_torch.kernels.range_scan import range_scan, range_scan_plain
from mcmcdate_tpu_torch.models.state import FIELDS, State
from mcmcdate_tpu_torch.ops import clocks
from mcmcdate_tpu_torch.ops.node_priors import CalibrationSet

F64 = torch.float64
C = 16


def _spd(rng, n):
    a = rng.normal(size=(n, n)) / np.sqrt(n)
    return torch.as_tensor(a @ a.T + np.eye(n))


def _sequential(delta_rows, z, P, d_pr, lmhg, u):
    """Ticket by ticket: ``dq_t = 2 delta_t . z[rows_t] + delta_t' P delta_t``
    with ``z += P delta_t`` after each accept (``delta_rows`` ``[C, n, F]``,
    each ticket's delta scattered over the F rows)."""
    Cn, n, _ = delta_rows.shape
    z = z.clone()
    accept = torch.zeros((Cn, n), dtype=torch.bool)
    dq = torch.zeros((Cn, n), dtype=F64)
    for t in range(n):
        dt = delta_rows[:, t]
        dq[:, t] = 2 * (dt * z).sum(1) + ((dt @ P) * dt).sum(1)
        la = torch.nan_to_num(d_pr[:, t] - 0.5 * dq[:, t] + lmhg[:, t], nan=-math.inf)
        accept[:, t] = torch.log(u[:, t]) < la
        z = z + accept[:, t, None] * (dt @ P)
    return accept, dq


def _scan_inputs(rng, n, lmhg_scale=1.0):
    d_pr = torch.as_tensor(0.1 * rng.normal(size=(C, n)))
    lmhg = torch.as_tensor(lmhg_scale * rng.normal(size=(C, n)))
    u = torch.as_tensor(rng.uniform(size=(C, n)))
    return d_pr, lmhg, u


@pytest.mark.parametrize("seed,B,KD", [(0, 70, 3), (1, 130, 2), (2, 64, 1), (3, 5, 3),
                                       (4, 129, 3)])
def test_point_scan_plain_matches_ticket_by_ticket(seed, B, KD):
    rng = np.random.default_rng(seed)
    F = B * KD
    P = _spd(rng, F)
    delta = torch.as_tensor(0.3 * rng.normal(size=(C, B, KD)))
    delta[:, B - 2:] = 0.0  # pad slots
    zG = torch.as_tensor(rng.normal(size=(C, F)))
    d_pr, lmhg, u = _scan_inputs(rng, B)
    accept, dq = point_scan(delta, zG, P, d_pr, lmhg, u)  # CPU: the plain version
    rows = torch.zeros((C, B, F), dtype=F64)
    for t in range(B):
        rows[:, t, t * KD:(t + 1) * KD] = delta[:, t]
    ref_acc, ref_dq = _sequential(rows, zG, P, d_pr, lmhg, u)
    assert 0 < int(accept.sum()) < accept.numel()
    assert torch.equal(accept, ref_acc)
    torch.testing.assert_close(dq, ref_dq, rtol=0, atol=1e-10)
    assert torch.equal(point_scan_plain(delta, zG, P, d_pr, lmhg, u)[0], accept)


@pytest.mark.parametrize("seed,S,RB", [(0, 12, 4), (1, 64, 2), (2, 3, 16), (3, 1, 8),
                                       (4, 33, 3)])
def test_range_scan_plain_matches_ticket_by_ticket(seed, S, RB):
    rng = np.random.default_rng(seed)
    F = S * RB
    Q = _spd(rng, F)
    g = torch.as_tensor(rng.normal(size=(C, S, RB)))
    g[:, :, RB - 1:] = 0.0  # pad rows
    zg = torch.as_tensor(rng.normal(size=(C, S, RB)))
    coef = torch.as_tensor(0.2 * rng.normal(size=(C, S)))
    d_pr, lmhg, u = _scan_inputs(rng, S)
    accept, dq = range_scan(g, zg, Q, coef, d_pr, lmhg, u)  # CPU: the plain version
    rows = torch.zeros((C, S, F), dtype=F64)
    for t in range(S):
        rows[:, t, t * RB:(t + 1) * RB] = coef[:, t, None] * g[:, t]
    ref_acc, ref_dq = _sequential(rows, zg.reshape(C, F), Q, d_pr, lmhg, u)
    assert 0 < int(accept.sum()) < accept.numel() or S == 1
    assert torch.equal(accept, ref_acc)
    torch.testing.assert_close(dq, ref_dq, rtol=0, atol=1e-10)
    assert torch.equal(range_scan_plain(g, zg, Q, coef, d_pr, lmhg, u)[0], accept)


def _contra_case(clock, mode, seed=0):
    """A calibrated 12-taxon float64 model, a perturbed chain batch, its
    carry and the first contrary step of ``mode``."""
    model, batch = synthetic.build(12, C, dtype=F64, device="cpu", seed=seed, clock=clock)
    inner = [int(i) for i in model.topo.inner_nodes if i]
    cal = CalibrationSet(node=np.asarray([0, inner[0], inner[3]], np.int32),
                         lower=np.asarray([0.8, 0.1, 0.0]), lower_pm=np.asarray([0.01, 0.02, 1.0]),
                         upper=np.asarray([1.6, np.inf, 0.9]),
                         upper_pm=np.asarray([0.01, 1.0, 0.05]), names=("root", "a", "b"))
    model = dataclasses.replace(model, calibrations=cal)
    rng = np.random.default_rng(seed + 1)
    h = batch.heights * torch.as_tensor(rng.uniform(0.9, 1.0, size=(C, 1)))
    h[:, 0] = 1.0
    h[:, model.topo.is_leaf_t] = 0.0
    batch = batch.replace(heights=h, rate_var=torch.as_tensor(rng.uniform(0.05, 0.5, C)))
    table = TP.build_proposal_table(model.topo, model.braces, model.calibrations_available)
    fs = TF.FastSweeps(model, table)
    carry = fs.init_carry(batch)
    if mode == "slide":
        sx = fs.spec_t[TP.K_SLIDE_NODES_CONTRA][0]
    else:
        sx = next(b[0] for (k, _), b in fs.range_t.items() if k == TP.K_SCALE_SUBTREES_CONTRA)
    n = sx["rows"].shape[0]
    tuning = torch.as_tensor(rng.uniform(0.3, 3.0, size=(C, table.n_proposals)))
    u_prop, u_acc = (torch.as_tensor(rng.uniform(size=(C, n))) for _ in range(2))
    return model, carry, sx, tuning, u_prop, u_acc


def _copy(carry):
    return (State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}), carry.terms.clone(),
            carry.acc.clone())


def _distances(model, st):
    par, nr = model.topo.parent_t, model.topo.non_root_t
    return torch.where(nr, (st.heights[:, par] - st.heights) * st.rates, 0.0)


@pytest.mark.parametrize("mode", ["slide", "range"])
@pytest.mark.parametrize("clock", clocks.MODELS)
def test_contra_steps_keep_distances_and_terms(clock, mode):
    model, carry, sx, tuning, u_prop, u_acc = _contra_case(clock, mode)
    st, terms, acc = _copy(carry)
    out = getattr(K6, f"contra_{mode}")(st, terms, acc, tuning, sx, model.topo.is_leaf_t,
                                        model.clock, u_prop, u_acc)
    assert 0 < int(out.accept.sum()) < int(sx["valid"].sum()) * C
    moved = (st.heights != carry.batch.heights).any(1)
    assert torch.equal(moved, out.accept.any(1))
    torch.testing.assert_close(_distances(model, st), _distances(model, carry.batch),
                               rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(terms, model.log_prior_terms(st), rtol=1e-10, atol=1e-10)
    assert torch.equal((acc - carry.acc)[:, sx["rows"]], out.accept.to(acc.dtype))


@pytest.mark.parametrize("mode", ["slide", "range"])
def test_contra_given_replays_and_forces_decisions(mode):
    model, carry, sx, tuning, u_prop, u_acc = _contra_case(clocks.MODELS[0], mode, seed=2)
    plain = getattr(K6, f"contra_{mode}_plain")
    given = getattr(K6, f"contra_{mode}_given")
    leaf = model.topo.is_leaf_t
    sp, tp, ap = _copy(carry)
    op = plain(sp, tp, ap, tuning, sx, leaf, model.clock, u_prop, u_acc)
    sr, tr, ar = _copy(carry)
    orr = given(sr, tr, ar, tuning, sx, leaf, model.clock, op.h_prop, u_acc)
    for a, b in zip(op, orr):
        assert torch.equal(a, b)
    for f in FIELDS:
        assert torch.equal(getattr(sp, f), getattr(sr, f))
    assert torch.equal(tp, tr) and torch.equal(ap, ar)
    # u = 0 accepts every proposal with a finite log alpha; u = NaN rejects.
    flip = ~op.accept & torch.isfinite(op.log_alpha)
    assert flip.any()
    forced = torch.where(op.accept | flip, 0.0, math.nan)
    sf, tf, af = _copy(carry)
    of = given(sf, tf, af, tuning, sx, leaf, model.clock, op.h_prop, forced)
    assert torch.equal(of.accept, op.accept | flip)
    assert torch.equal(of.log_alpha, op.log_alpha)


# Nodes of three and four children beside bifurcating ones (the root
# bifurcates, as the likelihood's distance layout needs).
MULTIFURCATING = ("(((a:1,b:1,c:1):1,((d:0.5,e:0.5,f:0.5,g:0.5):1,(h:1,i:1):0.5):0.5):0.5,"
                  "(j:1.5,(k:0.5,l:0.5):1):1);")


@pytest.mark.parametrize("kind", [TP.K_SLIDE_NODES_CONTRA, TP.K_SLIDE_NODE_ULTRA],
                         ids=["contra", "ultra"])
def test_multifurcating_slides_keep_terms(kind):
    """On a tree whose steps hold nodes with fewer children than the widest
    (KC = 4), every slide step with every proposal accepted leaves carry
    terms equal to a fresh evaluation of the new state: child slot j's term
    rows sit at 2+j and 2+KC+j, where the steps' new terms are."""
    from mcmcdate_tpu_torch.models import DatingModel
    from mcmcdate_tpu_torch.models.state import init_state
    from mcmcdate_tpu_torch.ops import mvn
    from mcmcdate_tpu_torch.tree import FlatTopology
    from mcmcdate_tpu_torch.tree.rose import parse_newick

    tree = parse_newick(MULTIFURCATING)
    topo = FlatTopology.from_tree(tree)
    rng = np.random.default_rng(4)
    k = topo.n - 2
    chol = np.tril(rng.normal(size=(k, k)) / np.sqrt(k)) + np.eye(k) * 2.0
    data = mvn.LikelihoodData(kind=mvn.FULL, mu=rng.uniform(0.05, 0.5, size=k),
                              precision=chol @ chol.T, chol_precision=chol,
                              log_det_sigma=float(-2.0 * np.log(np.diag(chol)).sum()))
    model = DatingModel(topo=topo, likelihood=data, device="cpu", dtype=F64)
    batch = init_state(tree, topo, C, dtype=F64, device="cpu")
    h = batch.heights * torch.as_tensor(rng.uniform(0.9, 1.0, size=(C, 1)))
    h[:, 0] = 1.0
    h[:, model.topo.is_leaf_t] = 0.0
    batch = batch.replace(heights=h, rates=torch.as_tensor(rng.gamma(5.0, 0.2, size=(C, topo.n))))
    table = TP.build_proposal_table(model.topo, model.braces, model.calibrations_available)
    fs = TF.FastSweeps(model, table)
    steps = fs.spec_t[kind]
    assert max(int((sx["ch"] >= 0).sum(1).max()) for sx in steps) == 4
    assert any(bool(((sx["ch"] >= 0).sum(1) < 4)[sx["valid"]].any()) for sx in steps)
    carry = fs.init_carry(batch)
    carry.z, carry.q = fs._zq_from_y(model.whitened_residual_internal(carry.batch))
    tuning = torch.as_tensor(rng.uniform(0.3, 3.0, size=(C, table.n_proposals)))
    n_acc = 0
    for sx in steps:
        B = sx["rows"].shape[0]
        u_prop = torch.as_tensor(rng.uniform(size=(C, B)))
        u_acc = torch.zeros((C, B), dtype=F64)  # log 0 < every finite log alpha
        if kind == TP.K_SLIDE_NODES_CONTRA:
            accept = fs.contra_slide_step(carry, tuning, sx, u_prop, u_acc)
        else:
            accept = fs.point_lik_step(kind, carry, tuning, sx, u_prop, u_acc)
        n_acc += int(accept.sum())
        torch.testing.assert_close(carry.terms, model.log_prior_terms(carry.batch), rtol=1e-10,
                                   atol=1e-10)
    assert n_acc > 0


def test_contra_range_groups_cover_the_buckets():
    """K6's range lane groups hold every row and calibration slot of each
    range bucket (at most 8 rows and 4 slots a lane, a power of 2 up to a
    warp), and its launch counts' buckets are the planner's."""
    assert K6.ROW_BUCKETS == tuple(rb for _, rb in TF.RANGE_BUCKETS)
    for rows in range(1, K6.ROWS_MAX + 1):
        for cal in (0, 1, 5, 40, K6.CAL_MAX):
            w = K6.group_width(rows, cal)
            assert w in (1, 2, 4, 8, 16, 32)
            assert rows <= 8 * w and cal <= 4 * w
            assert w == 1 or (w // 2) * K6.ROWS_PER_LANE < rows or (w // 2) * 4 < cal
