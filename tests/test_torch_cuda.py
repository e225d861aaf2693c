"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes.  Needs an NVIDIA card (sm_90a) with nvcc; skipped
elsewhere.  On the card, without JAX installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from mcmcdate_tpu_torch import synthetic
from mcmcdate_tpu_torch.kernels.accept_select import accept_select, accept_select_plain
from mcmcdate_tpu_torch.kernels.ticket_step import TicketDraws, count_bad, ticket_prologue, \
    ticket_prologue_plain, ticket_scan, ticket_scan_plain
from mcmcdate_tpu_torch.kernels.prior_terms import prior_terms, prior_terms_plain
from mcmcdate_tpu_torch.kernels.whiten import range_rows, whiten, whiten_plain
from mcmcdate_tpu_torch.models.state import FIELDS, State
from mcmcdate_tpu_torch.ops import clocks
from mcmcdate_tpu_torch.ops.heights import distances_internal

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(clock=clocks.UNCORRELATED_GAMMA):
    model, batch = synthetic.build(40, 96, device="cuda", clock=clock)
    g = np.random.default_rng(0)
    return model, batch.replace(
        birth=torch.as_tensor(g.uniform(0.2, 3, 96), dtype=torch.float32, device="cuda"),
        rate_var=torch.as_tensor(g.uniform(1e-3, 1, 96), dtype=torch.float32, device="cuda"))


@pytest.mark.parametrize("clock", clocks.MODELS)
def test_prior_terms_kernel(card, clock):
    model, batch = _model(clock)
    before = prior_terms.launches
    k = prior_terms(model, batch)
    p = prior_terms_plain(model, batch)
    assert prior_terms.launches == before + 1
    assert torch.equal(torch.isfinite(k), torch.isfinite(p))
    fin = torch.isfinite(p)
    assert torch.all((k[fin] - p[fin]).abs() <= 1e-5 + 1e-5 * p[fin].abs())


def test_whiten_kernel(card):
    model, batch = _model()
    d = distances_internal(batch, model.topo).contiguous()
    L, mu = model.chol_internal_t, model.mu_internal_t
    y, _ = whiten_plain(d, L, sub=mu)
    D = d.shape[1]
    # None: the full class (contiguous rows, no row list); then the same
    # rows as an explicit list.
    for rows in (None, torch.arange(D, dtype=torch.int32, device=card),
                 torch.as_tensor([2, 0, D, 5], dtype=torch.int32, device=card),
                 torch.as_tensor(range_rows(3, 64, D), dtype=torch.int32, device=card)):
        for kw in (dict(sub=mu), dict(y=y), dict(sub=mu, y=y, minus_y=True)):
            dk, rk = whiten(d, L, rows=rows, **kw)
            dp, rp = whiten_plain(d, L, rows=rows, **kw)
            # float32 sums in another order: errors scale with the operands
            # (y and the quadratic form), not with a result that may cancel
            # to zero (dy = y' - y = 0 in the last case).
            scale = max(1.0, float(dp.abs().max()), float(y.abs().max()))
            assert (dk - dp).abs().max() <= 1e-5 * scale
            q = float((y * y).sum(1).max())
            assert (rk - rp).abs().max() <= 1e-5 * max(1.0, float(rp.abs().max()), q)


def test_accept_select_kernel(card):
    """K3 after T1 against its plain version from the same prologue, on a
    scalar scale of the birth rate (the scalar and birth-death blocks) and
    on the rates and time tree contrary move (every block, the heights, and
    K2's dy of the merged root distance): some chains carry a -inf clock
    term, which the first ticket leaves alone (those chains must reject);
    decisions mixed; heights, rates, scalars, terms, d, y, the accept and
    bad-term counts equal."""
    from mcmcdate_tpu_torch.engine import proposals as TP

    tk, carry, tuning, g = _ticket_setup("full", 40)
    tt = tk.tt
    C = carry.terms.shape[0]
    carry.terms[::5, 4 + tt.N + 1 + int(np.nonzero(tt.model.topo.is_leaf)[0][0])] = -math.inf
    carry.nbad = count_bad(carry.terms)
    t = tt.table
    birth = int(np.nonzero((t.kind == TP.K_SCALE_SCALAR) & (t.aux == TP.SC_BIRTH))[0][0])
    rt = int(np.nonzero(t.kind == TP.K_SCALE_RATES_TIME_TREE_CONTRA)[0][0])
    for p in (birth, rt):
        draw = (torch._standard_gamma(float(t.par[p]) / tuning[:, p], generator=g) if tt.gamma[p]
                else torch.rand(C, generator=g, device=card))
        u = torch.rand(C, generator=g, device=card)
        dr = TicketDraws.single(p, draw, u)
        ck, cp = _copy(carry), _copy(carry)
        before = accept_select.launches
        pro = ticket_prologue(tt, ck, tuning, dr, 0)
        prop = pro.prop.clone()
        dy, d_lik = tk._k2(ck, p, pro)
        ak, _ = accept_select(tt, ck, tuning, dr, 0, pro, dy, d_lik, out=True)
        assert accept_select.launches == before + 1
        pp = ticket_prologue_plain(tt, cp, tuning, p, draw, given=prop)
        ap, la_p = accept_select_plain(tt, cp, p, pp, torch.where(ak, 0.0, math.nan), dy, d_lik)
        assert torch.equal(ak, ap) and 0 < int(ak.sum()) < C
        if p == birth:
            assert not bool(ak[::5].any())
        _ticket_agree(ck, cp, torch.log(u), la_p, ak)


# -- the FastSweeps kernels (K4, K5, K6) --------------------------------------

TIE = 1e-4  # decisions may differ only where |log u - log alpha| is below this


def _scan_agree(acc_k, dq_k, acc_p, dq_p, la_p, logu, rel=1e-5):
    """Accept decisions and dq of a scan kernel against its plain version:
    per chain, equal up to the first decision that differs (which must be a
    tie); dq within ``rel`` of the chain's largest |dq|."""
    differ = acc_k != acc_p
    first = torch.where(differ.any(1), differ.int().argmax(1), acc_k.shape[1])
    cols = torch.arange(acc_k.shape[1], device=acc_k.device)[None, :]
    upto = cols <= first[:, None]
    assert torch.all((la_p - logu).abs()[differ & upto] < TIE)
    scale = dq_p.abs().amax(1, keepdim=True).clamp(min=1.0)
    assert torch.all(((dq_k - dq_p).abs() <= rel * scale)[upto])
    return int(differ.sum())


def test_point_scan_kernel(card):
    from mcmcdate_tpu_torch.kernels.point_scan import pitched, point_scan, point_scan_plain

    g = torch.Generator(device=card).manual_seed(3)
    C, B, KD = 64, 150, 3
    F = B * KD
    a = torch.randn(F, F, generator=g, device=card) / F ** 0.5
    P = (a @ a.T + torch.eye(F, device=card)).contiguous()
    delta = 0.05 * torch.randn(C, B, KD, generator=g, device=card)
    delta[:, 140:] = 0.0  # pad slots
    zG = torch.randn(C, F, generator=g, device=card)
    d_pr = 0.1 * torch.randn(C, B, generator=g, device=card)
    lmhg = torch.randn(C, B, generator=g, device=card)
    lmhg[:, 140:] = -math.inf
    u = torch.rand(C, B, generator=g, device=card)
    before = point_scan.launches
    with pytest.raises(ValueError, match="pitch"):  # 450 floats a row
        point_scan(delta, zG, P, d_pr, lmhg, u)
    ak, dk = point_scan(delta, zG, pitched(P), d_pr, lmhg, u)
    assert point_scan.launches == before + 1
    ap, dp = point_scan_plain(delta, zG, P, d_pr, lmhg, u)
    assert 0 < int(ap.sum()) < ap.numel()
    _scan_agree(ak, dk, ap, dp, d_pr - 0.5 * dp + lmhg, torch.log(u))


@pytest.mark.parametrize("C,B,KD", ((70, 150, 3), (13, 200, 1), (8, 64, 3), (1, 5, 3),
                                    (33, 450, 1), (9, 100, 2), (17, 70, 5)))
def test_point_scan_kernel_tiles(card, C, B, KD):
    """The chain-tiled scan at tile counts, ticket counts and KD that leave
    ragged tiles, sub-blocks (192 / KD tickets) and later-column panels;
    KD 1-3 keep a lane's tickets in registers, KD 5 in shared memory."""
    from mcmcdate_tpu_torch.kernels.point_scan import pitched, point_scan, point_scan_plain

    g = torch.Generator(device=card).manual_seed(B + KD)
    F = B * KD
    a = torch.randn(F, F, generator=g, device=card) / F ** 0.5
    P = (a @ a.T + torch.eye(F, device=card)).contiguous()
    delta = 0.05 * torch.randn(C, B, KD, generator=g, device=card)
    zG = torch.randn(C, F, generator=g, device=card)
    d_pr = 0.1 * torch.randn(C, B, generator=g, device=card)
    lmhg = torch.randn(C, B, generator=g, device=card)
    u = torch.rand(C, B, generator=g, device=card)
    ak, dk = point_scan(delta, zG, pitched(P), d_pr, lmhg, u)
    ap, dp = point_scan_plain(delta, zG, P, d_pr, lmhg, u)
    assert 0 < int(ap.sum()) < ap.numel()
    _scan_agree(ak, dk, ap, dp, d_pr - 0.5 * dp + lmhg, torch.log(u))


def test_point_step_kernel(card):
    """K4's point step (prologue, point_scan, epilogue and the z product) on
    every likelihood point step of a 40-taxon calibrated model, against the
    plain step replayed at the kernels' proposals and decisions: proposals
    within 1e-5 (1 + |x|) of the plain ones from the same draws, decisions
    equal except at ties, heights, rates and terms bitwise equal, d, z and q
    within 1e-5 of scale; the prologue's and epilogue's outputs against
    their plain versions'; one launch of each kernel per step."""
    import dataclasses

    from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP
    from mcmcdate_tpu_torch.kernels import point_step as K
    from mcmcdate_tpu_torch.kernels.point_scan import point_scan
    from mcmcdate_tpu_torch.ops.dists import standard_gamma
    from mcmcdate_tpu_torch.ops.node_priors import CalibrationSet

    model, batch = _model()
    inner = [int(i) for i in model.topo.inner_nodes if i]
    cal = CalibrationSet(node=np.asarray([0, inner[1], inner[4]], np.int32),
                         lower=np.asarray([0.8, 0.1, 0.0]), lower_pm=np.asarray([0.01, 0.02, 1.0]),
                         upper=np.asarray([1.6, np.inf, 0.9]),
                         upper_pm=np.asarray([0.01, 1.0, 0.05]))
    model = dataclasses.replace(model, calibrations=cal)
    table = TP.build_proposal_table(model.topo, model.braces, True)
    fs = TF.FastSweeps(model, table)
    leaf = model.topo.is_leaf_t
    g = torch.Generator(device=card).manual_seed(9)
    C = batch.n_chains
    tuning = torch.rand(C, table.n_proposals, generator=g, device=card) * 3 + 0.3
    carry = fs.init_carry(batch)
    carry.z, carry.q = fs._zq_from_y(model.whitened_residual_internal(carry.batch))
    wrappers = (K.point_lik_prologue, point_scan, K.point_lik_epilogue)
    n_acc = n = 0
    for k in (TP.K_SLIDE_NODE_ULTRA, TP.K_SCALE_BRANCH_RATE):
        branch = k == TP.K_SCALE_BRANCH_RATE
        for sx in fs.spec_t[k]:
            B = sx["rows"].shape[0]
            draw = (standard_gamma(sx["sd"] / tuning[:, sx["rows"]], g) if branch
                    else torch.rand(C, B, generator=g, device=card))
            u = torch.rand(C, B, generator=g, device=card)
            ck, cr, cp = (TF.FastCarry(State(**{f: getattr(carry.batch, f).clone()
                                                for f in FIELDS}),
                                       carry.terms.clone(), carry.d.clone(), carry.z.clone(),
                                       carry.q.clone(), carry.acc.clone()) for _ in range(3))
            args = (branch, ck.batch, ck.terms, ck.d, ck.z, tuning, sx, leaf, fs.pos_t,
                    model.clock, draw)
            pro = K.point_lik_prologue(*args)
            pp = K.point_lik_prologue_plain(*args)
            assert torch.all((pro.prop - pp.prop).abs() <= 1e-5 * (1 + pp.prop.abs()))
            before = [w.launches for w in wrappers]
            accept = fs.point_lik_step(k, ck, tuning, sx, draw, u)
            assert [w.launches for w in wrappers] == [b + 1 for b in before]
            forced = torch.where(accept, 0.0, math.nan)
            acc_r, pr, dq_r = K.point_lik_given(branch, cr.batch, cr.terms, cr.d, cr.z, cr.q,
                                                cr.acc, tuning, sx, leaf, fs.pos_t, model.clock,
                                                pro.prop, forced)
            assert torch.equal(acc_r, accept)
            # The prologue's outputs at its own proposals: terms bitwise.
            assert torch.equal(pro.tn.nan_to_num(), pr.tn.nan_to_num())
            for a, b in ((pro.lq, pr.lq), (pro.d_pr, pr.d_pr), (pro.delta, pr.delta),
                         (pro.zG, pr.zG)):
                fin = torch.isfinite(b)
                assert torch.equal(fin, torch.isfinite(a))
                assert torch.all((a - b).abs()[fin] <= 1e-4 * (1 + b.abs()[fin]))
            la = torch.nan_to_num(pr.d_pr - 0.5 * dq_r + pr.lmhg, nan=-math.inf)
            differ = (torch.log(u) < la) != accept
            assert torch.all((torch.log(u) - la).abs()[differ] < TIE)
            for a, b in ((ck.batch.heights, cr.batch.heights), (ck.batch.rates, cr.batch.rates),
                         (ck.terms, cr.terms)):
                assert torch.equal(a.nan_to_num(), b.nan_to_num())
            for a, b in ((ck.d, cr.d), (ck.z, cr.z), (ck.q, cr.q)):
                assert (a - b).abs().max() <= 1e-5 * max(1.0, float(b.abs().max()))
            assert torch.equal(ck.acc, cr.acc)
            # The epilogue alone against its plain version, on the replay's
            # decisions and dq.
            e_args = (cp.batch, cp.terms, cp.d, cp.q, cp.acc, sx, pr, acc_r, dq_r)
            cq = TF.FastCarry(State(**{f: getattr(cp.batch, f).clone() for f in FIELDS}),
                              cp.terms.clone(), cp.d.clone(), cp.z.clone(), cp.q.clone(),
                              cp.acc.clone())
            _, dacc_k = K.point_lik_epilogue(branch, *e_args)
            _, dacc_p = K.point_lik_epilogue_plain(branch, cq.batch, cq.terms, cq.d, cq.q, cq.acc,
                                                   sx, pr, acc_r, dq_r)
            assert torch.equal(dacc_k, dacc_p)
            for a, b in ((cp.batch.heights, cq.batch.heights), (cp.batch.rates, cq.batch.rates),
                         (cp.terms, cq.terms), (cp.d, cq.d), (cp.acc, cq.acc)):
                assert torch.equal(a.nan_to_num(), b.nan_to_num())
            assert (cp.q - cq.q).abs().max() <= 1e-5 * max(1.0, float(cq.q.abs().max()))
            n_acc += int(accept.sum())
            n += accept.numel()
    assert 0 < n_acc < n


def test_range_scan_kernel(card):
    from mcmcdate_tpu_torch.kernels.range_scan import kernel_layout, range_scan, range_scan_plain

    g = torch.Generator(device=card).manual_seed(4)
    # Full and ragged blocks: 1024 rows, a trimmed bucket (RB not a
    # multiple of the kernel's 8-column stages), one long ticket.
    for C, S, RB in ((70, 64, 16), (40, 16, 64), (33, 4, 256), (21, 33, 15), (9, 1, 235)):
        F = S * RB
        a = torch.randn(F, F, generator=g, device=card) / F ** 0.5
        Q = kernel_layout(a @ a.T + torch.eye(F, device=card))
        gg = torch.randn(C, S, RB, generator=g, device=card)
        gg[:, :, RB - 3:] = 0.0  # pad rows
        zg = torch.randn(C, S, RB, generator=g, device=card)
        coef = 0.02 * torch.randn(C, S, generator=g, device=card)
        d_pr = 0.1 * torch.randn(C, S, generator=g, device=card)
        lmhg = torch.randn(C, S, generator=g, device=card)
        u = torch.rand(C, S, generator=g, device=card)
        ak, dk = range_scan(gg, zg, Q, coef, d_pr, lmhg, u)
        ap, dp = range_scan_plain(gg, zg, Q, coef, d_pr, lmhg, u)
        assert 0 < int(ap.sum()) < ap.numel()
        _scan_agree(ak, dk, ap, dp, d_pr - 0.5 * dp + lmhg, torch.log(u))


def test_range_step_kernel(card):
    """K5's range step (prologue, range_scan, epilogue) on every likelihood
    range block of a 40-taxon model, against the plain step replayed at
    the kernel's proposals and decisions: proposals within 1e-5 (1 + |x|)
    of the plain ones from the same draws, decisions equal except at ties,
    heights, rates and terms bitwise equal, d, z and q within 1e-5 of scale."""
    from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP
    from mcmcdate_tpu_torch.kernels import range_step as K
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    model, batch = _model()
    fs, table = _fast(model)
    leaf = model.topo.is_leaf_t
    g = torch.Generator(device=card).manual_seed(6)
    C = batch.n_chains
    tuning = torch.rand(C, table.n_proposals, generator=g, device=card) * 3 + 0.3
    carry = fs.init_carry(batch)
    carry.z, carry.q = fs._zq_from_y(model.whitened_residual_internal(carry.batch))
    n_acc = n = 0
    for (k, _), blocks in fs.range_t.items():
        if k == TP.K_SCALE_SUBTREES_CONTRA:
            continue
        rate = k == TP.K_SCALE_SUBTREE_RATE
        for sx in blocks[:3]:
            S = sx["rows"].shape[0]
            draw = (standard_gamma(sx["sd"] / tuning[:, sx["rows"]], g) if rate
                    else torch.rand(C, S, generator=g, device=card))
            u = torch.rand(C, S, generator=g, device=card)
            copies = [TF.FastCarry(State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}),
                                   carry.terms.clone(), carry.d.clone(), carry.z.clone(),
                                   carry.q.clone(), carry.acc.clone()) for _ in range(2)]
            ck, cr = copies
            before = [K.range_lik_prologue.launches, K.range_lik_epilogue.launches]
            pro = K.range_lik_prologue(rate, ck.batch, ck.terms, ck.d, ck.z, tuning, sx, leaf,
                                       model.clock, draw)
            pp = K.range_lik_prologue_plain(rate, ck.batch, ck.terms, ck.d, ck.z, tuning, sx,
                                            leaf, model.clock, draw)
            assert torch.all((pro.prop - pp.prop).abs() <= 1e-5 * (1 + pp.prop.abs()))
            accept = fs.range_lik_step(k, ck, tuning, sx, draw, u)
            assert [K.range_lik_prologue.launches, K.range_lik_epilogue.launches] == [
                before[0] + 2, before[1] + 1]
            forced = torch.where(accept, 0.0, math.nan)
            acc_r, pr, dq_r = K.range_lik_given(rate, cr.batch, cr.terms, cr.d, cr.z, cr.q,
                                                cr.acc, tuning, sx, leaf, model.clock, pro.prop,
                                                forced)
            assert torch.equal(acc_r, accept)
            la = torch.nan_to_num(pr.d_pr - 0.5 * dq_r + pr.lmhg, nan=-math.inf)
            differ = (torch.log(u) < la) != accept
            assert torch.all((torch.log(u) - la).abs()[differ] < TIE)
            for a, b in ((ck.batch.heights, cr.batch.heights), (ck.batch.rates, cr.batch.rates),
                         (ck.terms, cr.terms)):
                assert torch.equal(a.nan_to_num(), b.nan_to_num())
            for a, b in ((ck.d, cr.d), (ck.z, cr.z), (ck.q, cr.q)):
                assert (a - b).abs().max() <= 1e-5 * max(1.0, float(b.abs().max()))
            assert torch.equal(ck.acc, cr.acc)
            n_acc += int(accept.sum())
            n += accept.numel()
    assert 0 < n_acc < n


@pytest.mark.parametrize("step", ("point", "range"))
def test_prior_only_step_kernels(card, step):
    """Without a likelihood, FastSweeps' point steps (K4) and range blocks
    (K5) on the card launch only their prologue and epilogue kernels, the
    epilogue taking the decisions: on every point step and the first three
    blocks of each range kind of a 40-taxon model, the plain prologue
    replayed at the kernels' proposals gives their decisions except at
    ties, and the plain epilogue on their decisions gives their heights,
    rates and terms bitwise, d within 1e-5 of scale and the same accept
    counts; q stays as it was."""
    import dataclasses

    from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP
    from mcmcdate_tpu_torch.kernels import point_step as KP, range_step as KR
    from mcmcdate_tpu_torch.kernels.point_scan import point_scan
    from mcmcdate_tpu_torch.kernels.range_scan import range_scan
    from mcmcdate_tpu_torch.ops import mvn
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    model, batch = _model()
    model = dataclasses.replace(model, likelihood=mvn.LikelihoodData.none())
    fs, table = _fast(model)
    assert not fs.use_lik
    leaf = model.topo.is_leaf_t
    g = torch.Generator(device=card).manual_seed(11)
    C = batch.n_chains
    tuning = torch.rand(C, table.n_proposals, generator=g, device=card) * 3 + 0.3
    carry = fs.init_carry(batch)
    if step == "point":
        K, scan, run = KP, point_scan, fs.point_lik_step
        cases = [(k, k == TP.K_SCALE_BRANCH_RATE, sx)
                 for k in (TP.K_SLIDE_NODE_ULTRA, TP.K_SCALE_BRANCH_RATE) for sx in fs.spec_t[k]]

        def given(flag, c, prop):
            return KP.point_lik_prologue_given(flag, c.batch, c.terms, c.d, None, tuning, sx,
                                               leaf, fs.pos_t, model.clock, prop)
    else:
        K, scan, run = KR, range_scan, fs.range_lik_step
        cases = [(k, k == TP.K_SCALE_SUBTREE_RATE, sx) for (k, _), blocks in fs.range_t.items()
                 if k != TP.K_SCALE_SUBTREES_CONTRA for sx in blocks[:3]]

        def given(flag, c, prop):
            return KR.range_lik_prologue_given(flag, c.batch, c.terms, c.d, None, tuning, sx,
                                               leaf, model.clock, prop)
    prologue, epilogue = (getattr(K, f"{step}_lik_{s}") for s in ("prologue", "epilogue"))
    epilogue_plain = getattr(K, f"{step}_lik_epilogue_plain")
    wrappers = (prologue, scan, epilogue)
    n_acc = n = 0
    for k, flag, sx in cases:
        B = sx["rows"].shape[0]
        draw = (standard_gamma(sx["sd"] / tuning[:, sx["rows"]], g) if flag
                else torch.rand(C, B, generator=g, device=card))
        u = torch.rand(C, B, generator=g, device=card)
        ck, cr = (TF.FastCarry(State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}),
                               carry.terms.clone(), carry.d.clone(), carry.z.clone(),
                               carry.q.clone(), carry.acc.clone()) for _ in range(2))
        before = [w.launches for w in wrappers]
        accept = run(k, ck, tuning, sx, draw, u)
        assert [w.launches for w in wrappers] == [before[0] + 1, before[1], before[2] + 1]
        pro = prologue(flag, cr.batch, cr.terms, cr.d, None, tuning, sx, leaf,
                       *((fs.pos_t,) if step == "point" else ()), model.clock, draw)
        pr = given(flag, cr, pro.prop)
        la = torch.nan_to_num(pr.d_pr + pr.lmhg, nan=-math.inf)
        differ = ((torch.log(u) < la) & sx["valid"]) != accept
        assert torch.all((torch.log(u) - la).abs()[differ] < TIE)
        epilogue_plain(flag, cr.batch, cr.terms, cr.d, cr.q, cr.acc, sx, pr, accept, None)
        for a, b in ((ck.batch.heights, cr.batch.heights), (ck.batch.rates, cr.batch.rates),
                     (ck.terms, cr.terms)):
            assert torch.equal(a.nan_to_num(), b.nan_to_num())
        assert (ck.d - cr.d).abs().max() <= 1e-5 * max(1.0, float(cr.d.abs().max()))
        assert torch.equal(ck.acc, cr.acc)
        assert torch.equal(ck.q, carry.q)
        n_acc += int(accept.sum())
        n += accept.numel()
    assert 0 < n_acc < n


def _contra_agree(model, batch, table, sx, seed, mode):
    """K6 in one mode on one step against its plain version.  Proposals may
    differ in their last bits (CUDA's normal CDF and inverse against
    PyTorch's), which a short branch amplifies in its terms: the kernel's
    proposals are held to the plain version's, and, replayed through the
    plain version, to its decisions up to ties and, with the ties taken as
    the kernel took them, to its state on every chain; then to distance
    invariance and to its own terms."""
    from mcmcdate_tpu_torch.kernels import contra_step as K

    kernel, plain, given = (getattr(K, f"contra_{mode}{s}") for s in ("", "_plain", "_given"))
    C, B = batch.n_chains, sx["rows"].shape[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    tuning = torch.rand(C, table.n_proposals, generator=g, device="cuda") * 3 + 0.3
    u_prop = torch.rand(C, B, generator=g, device="cuda")
    u_acc = torch.rand(C, B, generator=g, device="cuda")
    terms = model.log_prior_terms(batch)

    def fresh():
        return (State(**{f: getattr(batch, f).clone() for f in FIELDS}), terms.clone(),
                torch.zeros((C, table.n_proposals), dtype=torch.int32, device="cuda"))

    def near(a, b, rel=1e-5):
        fin = torch.isfinite(b)
        assert torch.equal(fin, torch.isfinite(a))
        assert torch.all((a[fin] - b[fin]).abs() <= rel * (1 + b[fin].abs()))

    sk, tk, acck = fresh()
    ok = kernel(sk, tk, acck, tuning, sx, model.topo.is_leaf_t, model.clock, u_prop, u_acc)
    sp, tp, accp = fresh()
    op = plain(sp, tp, accp, tuning, sx, model.topo.is_leaf_t, model.clock, u_prop, u_acc)
    valid = sx["valid"].expand_as(ok.accept)
    assert 0 < int(ok.accept.sum()) < int(valid.sum())
    near(torch.where(valid, ok.h_prop, 0.0), torch.where(valid, op.h_prop, 0.0))
    sr, tr, accr = fresh()
    forced = torch.where(ok.accept, 0.0, math.nan)
    orr = given(sr, tr, accr, tuning, sx, model.topo.is_leaf_t, model.clock, ok.h_prop, forced)
    near(torch.where(valid, ok.lq, 0.0), torch.where(valid, orr.lq, 0.0), TIE)
    assert torch.equal(orr.accept, ok.accept)
    differ = ((torch.log(u_acc) < orr.log_alpha) & valid) != ok.accept
    assert torch.all((torch.log(u_acc) - orr.log_alpha).abs()[differ] < TIE)
    for a, b in ((sk.heights, sr.heights), (sk.rates, sr.rates), (tk, tr)):
        near(a, b)
    assert torch.equal(acck, accr)
    par, nr = model.topo.parent_t, model.topo.non_root_t

    def lengths(st):
        h, r = st.heights, st.rates
        return torch.where(nr, (h[:, par] - h) * r, 0.0)

    # Distances are kept up to the cancellation in h_parent - h.
    mag = torch.where(nr, (batch.heights[:, par].abs() + batch.heights.abs())
                      * batch.rates.abs(), 0.0)
    assert torch.all((lengths(sk) - lengths(batch)).abs() <= 1e-5 * mag)
    near(tk, prior_terms_plain(model, sk))


def _fast(model):
    from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP

    table = TP.build_proposal_table(model.topo, model.braces, False)
    return TF.FastSweeps(model, table), table


@pytest.mark.parametrize("clock", clocks.MODELS)
def test_contra_slide_kernel(card, clock):
    from mcmcdate_tpu_torch.engine import proposals as TP

    model, batch = _model(clock)
    fs, table = _fast(model)
    _contra_agree(model, batch, table, fs.spec_t[TP.K_SLIDE_NODES_CONTRA][0], 5, "slide")


def test_contra_range_kernel(card):
    from mcmcdate_tpu_torch.engine import proposals as TP

    model, batch = _model()
    fs, table = _fast(model)
    keys = [k for k in fs.range_t if k[0] == TP.K_SCALE_SUBTREES_CONTRA]
    assert keys
    for k in keys:
        _contra_agree(model, batch, table, fs.range_t[k][0], k[1], "range")


def test_contra_range_kernel_buckets(card):
    """K6's range mode (lane groups of 16 or 32) on the first block of each
    of the three row buckets (16, 64 and 256 rows) of a 300-taxon model,
    one launch each, counted by bucket."""
    from mcmcdate_tpu_torch.engine import proposals as TP
    from mcmcdate_tpu_torch.kernels.contra_step import ROW_BUCKETS, contra_range

    model, batch = synthetic.build(300, 64, device="cuda")
    fs, table = _fast(model)
    keys = sorted(k for k in fs.range_t if k[0] == TP.K_SCALE_SUBTREES_CONTRA)
    assert [k[1] for k in keys] == list(ROW_BUCKETS)
    for k in keys:
        before = dict(contra_range.launches_by_rows)
        _contra_agree(model, batch, table, fs.range_t[k][0], k[1], "range")
        assert contra_range.launches_by_rows[k[1]] == before[k[1]] + 1


# -- the glob-family kernels (G1-G3) ------------------------------------------


def _glob_fast(seed):
    """FastSweeps on a 12-leaf synthetic model with calibrations, a
    constraint and a brace and the calibrated proposal table (all 14 glob
    families), a carry, a tuning and a generator."""
    import dataclasses

    from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP
    from mcmcdate_tpu_torch.ops.node_priors import BraceSet, CalibrationSet, ConstraintSet

    model, batch = synthetic.build(12, 96, device="cuda")
    inner = [int(i) for i in model.topo.inner_nodes if i != 0]
    cal = CalibrationSet(node=np.asarray([0, inner[0], inner[1]], np.int32),
                         lower=np.asarray([1.0, 0.4, 0.0]), lower_pm=np.asarray([0.01, 0.02, 1.0]),
                         upper=np.asarray([2.0, np.inf, 0.3]),
                         upper_pm=np.asarray([0.01, 1.0, 0.05]))
    con = ConstraintSet(young=np.asarray([inner[-1]], np.int32),
                        old=np.asarray([inner[-2]], np.int32), pm=np.asarray([0.01]))
    br = BraceSet(node=np.asarray([[inner[2], inner[-3], -1]], np.int32), sd=np.asarray([0.02]))
    model = dataclasses.replace(model, calibrations=cal, constraints=con, braces=br)
    table = TP.build_proposal_table(model.topo, model.braces, True)
    fs = TF.FastSweeps(model, table)
    assert tuple(fs.glob_fam) == TF.GLOB_ORDER
    carry = fs.init_carry(batch)
    carry.z, carry.q = fs._zq_from_y(model.whitened_residual_internal(carry.batch))
    g = torch.Generator(device="cuda").manual_seed(seed)
    tuning = torch.rand(96, table.n_proposals, generator=g, device="cuda") * 3 + 0.3
    return fs, carry, tuning, g


@pytest.mark.parametrize("dense", (False, True), ids=("G1", "G2-G3"))
def test_glob_kernels(card, dense):
    """G1 glob_scan (the scan families) or G2 and G3 around the product
    (the dense families) on every family of a 12-leaf calibrated model,
    against the plain family scan replayed at the kernels' proposals and
    decisions: proposals within 1e-5 (1 + |x|) of the plain ones from the
    same draws (plus 8 float32 ulps of the CDF value a truncated-normal
    proposal inverts), decisions equal except at ties, heights, rates, scalars and
    terms bitwise equal, d, z and q within 1e-5 of scale, accept counts
    equal; one G1 launch per family, one G2 and one G3 per ticket."""
    from mcmcdate_tpu_torch.engine.fast_sweep import FastCarry
    from mcmcdate_tpu_torch.kernels import glob_step as G
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    fs, carry, tuning, g = _glob_fast(8)
    C = carry.d.shape[0]

    def copy():
        return FastCarry(State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}),
                         carry.terms.clone(), carry.d.clone(), carry.z.clone(), carry.q.clone(),
                         carry.acc.clone())

    def near(a, b, lim):
        fin = torch.isfinite(b)
        assert torch.equal(fin, torch.isfinite(a))
        assert torch.all((a - b).abs()[fin] <= (lim[fin] if torch.is_tensor(lim) else lim))

    n_acc = n = 0
    wrappers = (G.glob_scan, G.glob_dense_prologue, G.glob_dense_epilogue)
    for tag, fam in fs.glob_fam.items():
        if (G.FAMILIES[tag].lik == G.DENSE) != dense:
            continue
        tun = tuning.index_select(1, fam.rows)
        draws = (standard_gamma(fam.sd / tun, g) if tag in G.GAMMA_TAGS
                 else torch.rand(C, fam.n, generator=g, device=card))
        u = torch.rand(C, fam.n, generator=g, device=card)
        ck, cr = copy(), copy()
        before = [w.launches for w in wrappers]
        if dense:
            acc, prop, mean = [], [], []
            for s in range(fam.n):
                pro = G.glob_dense_prologue(fs.glob, fam, s, ck, tun, draws)
                acc.append(G.glob_dense_epilogue(fs.glob, fam, s, ck, pro, fs._x_P(pro.delta), u))
                prop.append(pro.prop)
                mean.append(pro.mean)
            accept, prop = torch.stack(acc, 1), torch.stack(prop, 1)
            mean = torch.stack(mean, 1) if tag == "var_tree" else None
            assert [w.launches for w in wrappers] == [before[0], before[1] + fam.n,
                                                      before[2] + fam.n]
        else:
            out = G.glob_scan(fs.glob, fam, ck, tun, draws, u)
            accept, prop, mean = out.accept, out.prop, None
            assert [w.launches for w in wrappers] == [before[0] + 1, before[1], before[2]]
        forced = torch.where(accept, 0.0, math.nan)
        rec = fs.glob_family_plain(tag, cr, tun, draws, forced, given=dict(prop=prop, mean=mean))
        # Within a few float32 ulps of the CDF value the proposal inverts.
        lim = 1e-5 * (1 + rec.prop.abs())
        if rec.dx_dp is not None:
            lim = lim + 8 * torch.finfo(torch.float32).eps * rec.dx_dp
        near(prop, rec.prop, lim)
        if mean is not None:
            near(mean, rec.mean, 1e-5 * (1 + rec.mean.abs()))
        assert torch.equal(rec.accept, accept)
        differ = (torch.log(u) < rec.log_alpha) != accept
        assert torch.all((torch.log(u) - rec.log_alpha).abs()[differ] < TIE)
        for f in FIELDS:
            assert torch.equal(getattr(ck.batch, f).nan_to_num(), getattr(cr.batch, f).nan_to_num())
        assert torch.equal(ck.terms.nan_to_num(), cr.terms.nan_to_num())
        for a, b in ((ck.d, cr.d), (ck.z, cr.z), (ck.q, cr.q)):
            near(a, b, 1e-5 * max(1.0, float(b.abs().max())))
        assert torch.equal(ck.acc, cr.acc)
        n_acc += int(accept.sum())
        n += accept.numel()
    assert 0 < n_acc < n


# -- the sequential sweep's ticket kernels (T1, K3, T3) --------------------------


def _ticket_setup(lik, n_taxa, C=96, seed=5):
    """MHKernel on a calibrated synthetic model with a constraint and a
    brace (all 17 proposal kinds) under the full, univariate or no
    likelihood kind, with a carry, a tuning and a generator."""
    import dataclasses

    from mcmcdate_tpu_torch.engine import mh as TM, proposals as TP
    from mcmcdate_tpu_torch.ops import mvn
    from mcmcdate_tpu_torch.ops.node_priors import BraceSet, CalibrationSet, ConstraintSet

    model, batch = synthetic.build(n_taxa, C, device="cuda", seed=seed)
    inner = [int(i) for i in model.topo.inner_nodes if i != 0]
    cal = CalibrationSet(node=np.asarray([0, inner[0], inner[1]], np.int32),
                         lower=np.asarray([1.0, 0.4, 0.0]), lower_pm=np.asarray([0.01, 0.02, 1.0]),
                         upper=np.asarray([2.0, np.inf, 0.3]),
                         upper_pm=np.asarray([0.01, 1.0, 0.05]))
    con = ConstraintSet(young=np.asarray([inner[-1]], np.int32),
                        old=np.asarray([inner[-2]], np.int32), pm=np.asarray([0.01]))
    br = BraceSet(node=np.asarray([[inner[2], inner[-3], -1]], np.int32), sd=np.asarray([0.02]))
    kw = dict(calibrations=cal, constraints=con, braces=br)
    if lik == "univariate":
        rng = np.random.default_rng(seed)
        k = model.likelihood.dim
        kw["likelihood"] = mvn.LikelihoodData.univariate(rng.uniform(0.05, 0.5, k),
                                                         rng.uniform(1e-4, 1e-2, k))
    elif lik == "none":
        kw["likelihood"] = mvn.LikelihoodData.none()
    model = dataclasses.replace(model, **kw)
    table = TP.build_proposal_table(model.topo, model.braces, True)
    assert set(int(x) for x in table.kind) == set(range(TP.N_KINDS))
    tk = TM.MHKernel(model, table)
    g = torch.Generator(device="cuda").manual_seed(seed)
    tuning = torch.rand(C, table.n_proposals, generator=g, device="cuda") * 3 + 0.3
    return tk, tk.init_carry(batch), tuning, g


def _copy(carry):
    from mcmcdate_tpu_torch.engine.mh import Carry

    def cl(t):
        return None if t is None else t.clone()

    return Carry(State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}), carry.terms.clone(),
                 cl(carry.d), cl(carry.y), carry.acc.clone(), carry.nbad.clone())


def _ticket_agree(ck, cp, logu, la_p, accept, y_rel=1e-5):
    """A kernel carry against the plain replay's at the kernel's proposals
    and decisions: decisions differ from the replay's ratio only at ties;
    heights, rates, scalars, terms, d and the counts bitwise equal; y
    within ``y_rel`` of its scale."""
    differ = (logu < la_p) != accept
    assert torch.all((logu - la_p).abs()[differ] < TIE)
    for f in FIELDS:
        assert torch.equal(getattr(ck.batch, f).nan_to_num(), getattr(cp.batch, f).nan_to_num()), f
    assert torch.equal(ck.terms.nan_to_num(), cp.terms.nan_to_num())
    assert torch.equal(ck.acc, cp.acc) and torch.equal(ck.nbad, cp.nbad)
    if ck.d is not None:
        assert torch.equal(ck.d, cp.d)
        assert (ck.y - cp.y).abs().max() <= y_rel * max(1.0, float(cp.y.abs().max()))


def _prop_near(prop_k, prop_p, dx_dp):
    """Proposals within 1e-5 (1 + |x|) plus 8 float32 ulps of the CDF
    value a truncated-normal proposal inverts (gamma factors: exact)."""
    lim = 1e-5 * (1 + prop_p.abs()) + 8 * torch.finfo(torch.float32).eps * dx_dp
    assert torch.all((prop_k - prop_p).abs() <= lim)


@pytest.mark.parametrize("lik", ("full", "univariate", "none"))
def test_ticket_prologue_kernel(card, lik):
    """T1 and K3 (after K2 where the class needs it) on one ticket of every
    kind and every (class, kind) pair against their plain versions: the
    kernel's proposals near the plain ones from the same draws; replayed at
    them, T1's d_pr, lmhg, lj, delta and the new terms, then K3's
    write-back (see _ticket_agree)."""
    from mcmcdate_tpu_torch.engine import proposals as TP

    tk, carry, tuning, g = _ticket_setup(lik, 40)
    tt = tk.tt
    C = carry.terms.shape[0]
    rows = {}
    for p, kind in enumerate(tt.table.kind):
        rows.setdefault((int(kind), int(tt.table.aux[p]) if kind == TP.K_SCALE_SCALAR else 0), p)
        rows.setdefault((int(kind), int(tt.d_class[p]), "dc"), p)
    n_acc = 0
    for p in sorted(set(rows.values())):
        gamma = bool(tt.gamma[p])
        draw = (torch._standard_gamma(float(tt.table.par[p]) / tuning[:, p], generator=g) if gamma
                else torch.rand(C, generator=g, device=card))
        u = torch.rand(C, generator=g, device=card)
        dr = TicketDraws.single(p, draw, u)
        ck, cp = _copy(carry), _copy(carry)
        pro = ticket_prologue(tt, ck, tuning, dr, 0)
        k = {f: getattr(pro, f).clone() for f in ("prop", "lmhg", "lj", "d_pr", "invalid")}
        mean = None if pro.mean is None else pro.mean.clone()
        tix = tt.tix(p)
        tn_k = pro.tn[:, tix].clone()
        rows_d = tt.rows(p)
        dl_k = None if pro.delta is None or (rows_d is not None and not rows_d.numel()) else (
            pro.delta if rows_d is None else pro.delta[:, rows_d]).clone()
        pp = ticket_prologue_plain(tt, cp, tuning, p, draw)
        _prop_near(k["prop"], pp.prop, 0.0 if pp.dx_dp is None else pp.dx_dp)
        pp = ticket_prologue_plain(tt, cp, tuning, p, draw, given=k["prop"], given_mean=mean)
        assert torch.equal(k["invalid"], pp.invalid)
        assert torch.equal(tn_k.nan_to_num(), pp.tn[:, tix].nan_to_num())
        fin = torch.isfinite(pp.d_pr)
        assert torch.all((k["d_pr"] - pp.d_pr).abs()[fin] <= 1e-4 * (1 + pp.d_pr.abs()[fin]))
        for f in ("lmhg", "lj"):
            a, b = k[f], getattr(pp, f)
            fin = torch.isfinite(b)
            assert torch.equal(fin, torch.isfinite(a)), f
            assert torch.all((a - b).abs()[fin] <= 1e-4 * (1 + b.abs()[fin])), f
        if dl_k is not None:
            assert torch.equal(dl_k, pp.delta if rows_d is None else pp.delta[:, rows_d])
        dy, d_lik = tk._k2(ck, p, pro)
        ak, _ = accept_select(tt, ck, tuning, dr, 0, pro, dy, d_lik, out=True)
        ap, la_p = accept_select_plain(tt, cp, p, pp, torch.where(ak, 0.0, math.nan), dy, d_lik)
        assert torch.equal(ak, ap), tt.table.names[p]
        _ticket_agree(ck, cp, torch.log(u), la_p, ak)
        n_acc += int(ak.sum())
    assert n_acc > 0


@pytest.mark.parametrize("lik", ("full", "univariate"))
def test_ticket_scan_kernel(card, lik):
    """T3 on a 256-ticket run (under a full MVN of DC_INV and DC_GATHER
    tickets) against ticket_scan_plain replayed at its proposals, rate
    means and decisions (see _ticket_agree; y within 1e-5 of its scale:
    the gather's sums run in another order); one launch."""
    from mcmcdate_tpu_torch.engine import proposals as TP

    tk, carry, tuning, g = _ticket_setup(lik, 40)
    tt = tk.tt
    C = carry.terms.shape[0]
    tickets = np.asarray(tt.table.tickets)
    ok = np.asarray([not tt.breaks(int(p)) for p in tickets])
    order = np.random.default_rng(3).choice(tickets[ok], 256).astype(np.int32)
    if lik == "full":
        dcs = {int(tt.d_class[p]) for p in order}
        assert dcs == {TP.DC_INV, TP.DC_GATHER}
    gen = torch.Generator(device="cuda").manual_seed(4)
    dr = tk.draws(order, tuning, gen)
    ck, cp = _copy(carry), _copy(carry)
    before = ticket_scan.launches
    out = ticket_scan(tt, ck, tuning, dr, 0, len(order), out=True)
    assert ticket_scan.launches == before + 1
    forced = dr._replace(u_acc=torch.where(out.accept, 0.0, math.nan))
    rec = ticket_scan_plain(tt, cp, tuning, forced, 0, len(order),
                            given=dict(prop=out.prop, mean=out.mean))
    assert torch.equal(rec.accept, out.accept)
    assert 0 < int(out.accept.sum()) < out.accept.numel()
    _prop_near(out.prop, rec.prop, rec.dx_dp)
    _ticket_agree(ck, cp, torch.log(dr.u_acc), rec.log_alpha, out.accept)
