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


def _k1_agree(model, batch):
    before = prior_terms.launches
    k = prior_terms(model, batch)
    p = prior_terms_plain(model, batch)
    assert prior_terms.launches == before + 1
    assert torch.equal(torch.isfinite(k), torch.isfinite(p))
    assert torch.equal(k[torch.isinf(p)], p[torch.isinf(p)])
    fin = torch.isfinite(p)
    assert torch.all((k[fin] - p[fin]).abs() <= 1e-5 + 1e-5 * p[fin].abs())


def _node_priors(topo):
    """Two calibrations, a constraint and a brace on inner nodes."""
    from mcmcdate_tpu_torch.ops.node_priors import BraceSet, CalibrationSet, ConstraintSet

    inner = [int(i) for i in topo.inner_nodes if i != 0]
    return dict(
        calibrations=CalibrationSet(node=np.asarray([0, inner[0]], np.int32),
                                    lower=np.asarray([1.0, 0.4]), lower_pm=np.asarray([0.01, 0.02]),
                                    upper=np.asarray([2.0, np.inf]),
                                    upper_pm=np.asarray([0.01, 1.0])),
        constraints=ConstraintSet(young=np.asarray([inner[-1]], np.int32),
                                  old=np.asarray([inner[-2]], np.int32), pm=np.asarray([0.01])),
        braces=BraceSet(node=np.asarray([[inner[2], inner[-3], -1]], np.int32),
                        sd=np.asarray([0.02])))


@pytest.mark.parametrize("clock", clocks.MODELS)
def test_prior_terms_kernel(card, clock):
    model, batch = _model(clock)
    _k1_agree(model, batch)


@pytest.mark.parametrize("taxa, chains", ((40, 2200), (4000, 8)), ids=("shared_cta", "unstaged"))
def test_prior_terms_kernel_layouts(card, taxa, chains):
    """K1 where several chains share a CTA (more chains than one wave of
    CTAs holds: at most 16 an SM on 132 SMs) and where a CTA's term rows
    do not fit its shared memory (8,004 nodes: each term goes straight to
    device memory), with node priors and a near-critical chain."""
    import dataclasses

    from mcmcdate_tpu_torch.tools.seq_time import univariate_model

    if taxa > 1000:
        model, init = univariate_model(taxa)
        batch = init.to(dtype=torch.float32)
        batch = State(**{f: getattr(batch, f).expand(chains, *getattr(batch, f).shape[1:])
                         .contiguous() for f in FIELDS})
    else:
        model, batch = synthetic.build(taxa, chains, device="cuda")
    g = np.random.default_rng(1)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device="cuda")

    birth = g.uniform(0.2, 3, chains)
    death = g.uniform(0.0, 3, chains)
    death[0] = birth[0] + 2e-7
    h = batch.heights * t(g.uniform(0.95, 1.0, (chains, 1)))
    h[:, 0] = 1.0
    h[:, model.topo.is_leaf_t] = 0.0
    batch = batch.replace(heights=h.contiguous(), birth=t(birth), death=t(death),
                          rates=t(g.gamma(5.0, 0.2, (chains, model.topo.n))),
                          rate_var=t(g.uniform(1e-3, 1, chains)))
    for clock in (clocks.UNCORRELATED_GAMMA, clocks.AUTOCORRELATED_LOG_NORMAL):
        _k1_agree(dataclasses.replace(model, clock=clock, **_node_priors(model.topo)), batch)


def test_entry_points_default_to_the_card(card, tmp_path):
    """The library entry points, called without a device, land on the card,
    as float32 where they take a dtype."""
    from mcmcdate_tpu_torch.engine import checkpoint
    from mcmcdate_tpu_torch.models import DatingModel, from_numpy, init_state
    from mcmcdate_tpu_torch.ops import mvn
    from mcmcdate_tpu_torch.tree import DeviceTopology
    from mcmcdate_tpu_torch.tree.flat import FlatTopology
    from mcmcdate_tpu_torch.utils.simulate import random_ultrametric_tree

    rng = np.random.default_rng(0)
    tree = random_ultrametric_tree(rng, 6)
    topo = FlatTopology.from_tree(tree)
    k = topo.n - 2
    lik = mvn.LikelihoodData.univariate(rng.uniform(0.1, 0.5, k), rng.uniform(0.01, 0.1, k))
    arrays = {f: rng.uniform(0.5, 1.0, (2, topo.n) if f in ("heights", "rates") else 2)
              for f in FIELDS}
    made = {
        "from_numpy": from_numpy(topo, lik, arrays)[1].heights,
        "State.from_arrays": State.from_arrays(arrays).birth,
        "init_state": init_state(tree, topo, 2).heights,
        "make_log_likelihood": mvn.make_log_likelihood(lik)(
            torch.zeros((2, k), dtype=torch.float32, device="cuda")),
        "DatingModel": DatingModel(topo=topo, likelihood=lik).inv_sd_internal_t,
    }
    checkpoint.save("e", State.from_arrays(arrays), np.ones((2, 3)), np.zeros(2, np.uint32), 1,
                    3, out_dir=str(tmp_path))
    made["checkpoint.load"] = checkpoint.load("e", in_dir=str(tmp_path))[0].heights
    for name, x in made.items():
        assert x.device.type == "cuda" and x.dtype == torch.float32, name
    assert DeviceTopology(topo).parent_t.device.type == "cuda"


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


@pytest.mark.parametrize("what", ("pulley", "range"))
def test_accept_select_long_rows(card, what):
    """K3 where its write-back takes 16-byte copies (300 taxa: D = 598, its
    whole-D y and d and the term blocks past 512 entries): the pulley
    (DC_FULL) and a subtree scale of a range class, after T1 and K2,
    against the plain epilogue from the same prologue: decisions equal but
    at ties, state, terms, d and the counts bitwise, y within 1e-5 of its
    scale; then the same ticket with every chain rejected (u NaN) and with
    every chain whose ratio is above -inf accepted (u = 0)."""
    from mcmcdate_tpu_torch.engine import proposals as TP

    tk, carry, tuning, g = _ticket_setup("full", 300, C=64)
    tt = tk.tt
    C = carry.terms.shape[0]
    t = tt.table
    if what == "pulley":
        p = int(np.nonzero(t.kind == TP.K_PULLEY_ULTRA)[0][0])
    else:
        p = next(q for q in range(len(t.kind)) if t.kind[q] == TP.K_SCALE_SUBTREE_ULTRA
                 and int(tt.d_class[q]) not in (TP.DC_INV, TP.DC_FULL, TP.DC_GATHER))
    assert tt.breaks(p)
    draw = (torch._standard_gamma(float(t.par[p]) / tuning[:, p], generator=g) if tt.gamma[p]
            else torch.rand(C, generator=g, device=card))
    mixed = torch.rand(C, generator=g, device=card)
    for u in (mixed, torch.full((C,), math.nan, device=card), torch.zeros(C, device=card)):
        dr = TicketDraws.single(p, draw, u)
        ck, cp = _copy(carry), _copy(carry)
        pro = ticket_prologue(tt, ck, tuning, dr, 0)
        prop = pro.prop.clone()
        dy, d_lik = tk._k2(ck, p, pro)
        ak, la_k = accept_select(tt, ck, tuning, dr, 0, pro, dy, d_lik, out=True)
        pp = ticket_prologue_plain(tt, cp, tuning, p, draw, given=prop)
        ap, la_p = accept_select_plain(tt, cp, p, pp, torch.where(ak, 0.0, math.nan), dy, d_lik)
        assert torch.equal(ak, ap)
        if u is mixed:
            assert 0 < int(ak.sum()) < C
        elif bool(u.isnan().all()):
            assert not bool(ak.any())
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


def _point_calibrated():
    """The 40-taxon model with three calibrations (the root and two inner
    nodes) and its calibrated proposal table: its slides carry calibration
    slots (K4's generic prologue), its branch scales none."""
    import dataclasses

    from mcmcdate_tpu_torch.engine import proposals as TP
    from mcmcdate_tpu_torch.ops.node_priors import CalibrationSet

    model, batch = _model()
    inner = [int(i) for i in model.topo.inner_nodes if i]
    cal = CalibrationSet(node=np.asarray([0, inner[1], inner[4]], np.int32),
                         lower=np.asarray([0.8, 0.1, 0.0]), lower_pm=np.asarray([0.01, 0.02, 1.0]),
                         upper=np.asarray([1.6, np.inf, 0.9]),
                         upper_pm=np.asarray([0.01, 1.0, 0.05]))
    model = dataclasses.replace(model, calibrations=cal)
    return model, batch, TP.build_proposal_table(model.topo, model.braces, True)


def test_point_step_kernel(card):
    """K4's point step (prologue, point_scan, epilogue and the z product) on
    every likelihood point step of a 40-taxon calibrated model, against the
    plain step replayed at the kernels' proposals and decisions: proposals
    within 1e-5 (1 + |x|) of the plain ones from the same draws, decisions
    equal except at ties, heights, rates and terms bitwise equal, d, z and q
    within 1e-5 of scale; the prologue's and epilogue's outputs against
    their plain versions'; one launch of each kernel per step."""
    from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP
    from mcmcdate_tpu_torch.kernels import point_step as K
    from mcmcdate_tpu_torch.kernels.point_scan import point_scan
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    model, batch, table = _point_calibrated()
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


# K4's prologue instantiations: (KC, KT, KD, KN) of every step of each kind,
# None where the step takes the generic kernel (any other shape).
K4_SHAPES = {"binary": ((2, 6, 3, 0), (2, 6, 1, 0)), "binary-wide": ((2, 6, 3, 0), (2, 6, 1, 0)),
             "calibrated": (None, (2, 6, 1, 0)), "multifurcating": (None, None)}


def _point_case(model_of):
    """FastSweeps of a K4 test model with a carry (z and q filled), a
    tuning and a generator: the 40-taxon binary model at 96 chains, the
    136-taxon one at 2048 chains (more (chain, ticket) pairs in a branch
    step than an H100 holds threads at once, so the prologue's threads take
    more than one pair), the calibrated 40-taxon model and the
    multifurcating one (KC = 4)."""
    from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP

    if model_of == "calibrated":
        model, batch, table = _point_calibrated()
    else:
        if model_of == "binary":
            model, batch = _model()
        elif model_of == "binary-wide":
            model, batch = synthetic.build(136, 2048, device="cuda")
        else:
            model, batch = _multifurcating()
        table = TP.build_proposal_table(model.topo, model.braces, False)
    fs = TF.FastSweeps(model, table)
    carry = fs.init_carry(batch)
    carry.z, carry.q = fs._zq_from_y(model.whitened_residual_internal(carry.batch))
    g = torch.Generator(device="cuda").manual_seed(21)
    tuning = torch.rand(batch.n_chains, table.n_proposals, generator=g, device="cuda") * 3 + 0.3
    return fs, carry, tuning, g


def _point_steps(fs, model_of, g, tuning):
    """Every point step of both kinds with its draws: ``(kind, branch, sx,
    draw, u)``, each step's shape checked against K4_SHAPES."""
    from mcmcdate_tpu_torch.engine import proposals as TP
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    C = tuning.shape[0]
    for kind, shape in zip((TP.K_SLIDE_NODE_ULTRA, TP.K_SCALE_BRANCH_RATE), K4_SHAPES[model_of]):
        branch = kind == TP.K_SCALE_BRANCH_RATE
        assert fs.spec_t[kind]
        for sx in fs.spec_t[kind]:
            got = (sx["ch"].shape[1], sx["t_rows"].shape[1], sx["d_rows"].shape[1],
                   sx["cal_lo"].shape[-1])
            if shape is None:
                assert (got[3] > 0 if model_of == "calibrated" else got[0] == 4), got
            else:
                assert got == shape
            B = sx["rows"].shape[0]
            draw = (standard_gamma(sx["sd"] / tuning[:, sx["rows"]], g) if branch
                    else torch.rand(C, B, generator=g, device="cuda"))
            yield kind, branch, sx, draw, torch.rand(C, B, generator=g, device="cuda")


@pytest.mark.parametrize("model_of", list(K4_SHAPES))
def test_point_prologue_instantiations(card, model_of):
    """K4's prologue on every point step of both kinds, through each of its
    instantiations (the binary slide, the branch scale, the generic kernel
    on calibrated slides and on a multifurcating tree), against the plain
    prologue: proposals within 1e-5 (1 + |x|) of the plain ones from the
    same draws; replayed at the kernel's proposals, the new terms bitwise
    equal, lq, d_pr, delta and zG within 1e-4 (1 + |x|), -inf in lmhg
    where the replay's; one launch a step; without z the same outputs
    bitwise and no zG."""
    from mcmcdate_tpu_torch.kernels import point_step as K

    fs, carry, tuning, g = _point_case(model_of)
    model = fs.model
    leaf = model.topo.is_leaf_t
    for _, branch, sx, draw, _ in _point_steps(fs, model_of, g, tuning):
        args = (branch, carry.batch, carry.terms, carry.d, carry.z, tuning, sx, leaf, fs.pos_t,
                model.clock, draw)
        before = K.point_lik_prologue.launches
        pro = K.point_lik_prologue(*args)
        assert K.point_lik_prologue.launches == before + 1
        pp = K.point_lik_prologue_plain(*args)
        assert torch.all((pro.prop - pp.prop).abs() <= 1e-5 * (1 + pp.prop.abs()))
        pr = K.point_lik_prologue_given(branch, carry.batch, carry.terms, carry.d, carry.z,
                                        tuning, sx, leaf, fs.pos_t, model.clock, pro.prop)
        assert torch.equal(pro.tn.nan_to_num(), pr.tn.nan_to_num())
        for a, b in ((pro.lq, pr.lq), (pro.d_pr, pr.d_pr), (pro.delta, pr.delta),
                     (pro.zG, pr.zG), (pro.lmhg, pr.lmhg)):
            _near(a, b, 1e-4 * (1 + b.abs()))
        assert torch.equal(pro.lmhg == -math.inf, pr.lmhg == -math.inf)
        pn = K.point_lik_prologue(*args[:4], None, *args[5:])
        assert pn.zG is None
        for a, b in zip(pn[:-1], pro[:-1]):
            assert torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("mode", ("scan", "u_acc"))
@pytest.mark.parametrize("model_of", ("binary", "calibrated", "multifurcating"))
def test_point_epilogue_modes(card, model_of, mode):
    """K4's epilogue on every point step of both kinds against the plain
    epilogue on the same inputs (the plain prologue's at the kernel's
    proposals): with the scan's decisions and dq (``scan``: the plain
    scan's), the same accept mask and dacc, heights, rates, terms, d and
    accept counts bitwise equal and q within 1e-5 of scale; with accept
    uniforms and no dq (``u_acc``), where the epilogue decides, its
    decisions those of log u < d_pr + lmhg except at ties, then the plain
    epilogue's state on its decisions bitwise, and q as it was.  One launch
    a step; decisions mixed."""
    from mcmcdate_tpu_torch.engine import fast_sweep as TF
    from mcmcdate_tpu_torch.kernels import point_step as K
    from mcmcdate_tpu_torch.kernels.point_scan import point_scan_plain

    fs, carry, tuning, g = _point_case(model_of)
    model = fs.model
    leaf = model.topo.is_leaf_t
    n_acc = n = 0

    def copy():
        return TF.FastCarry(State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}),
                            carry.terms.clone(), carry.d.clone(), carry.z.clone(),
                            carry.q.clone(), carry.acc.clone())

    for _, branch, sx, draw, u in _point_steps(fs, model_of, g, tuning):
        prop = K.point_lik_prologue(branch, carry.batch, carry.terms, carry.d, carry.z, tuning,
                                    sx, leaf, fs.pos_t, model.clock, draw).prop
        pr = K.point_lik_prologue_given(branch, carry.batch, carry.terms, carry.d, carry.z,
                                        tuning, sx, leaf, fs.pos_t, model.clock, prop)
        ck, cp = copy(), copy()
        kargs, pargs = ((branch, c.batch, c.terms, c.d, c.q, c.acc, sx, pr) for c in (ck, cp))
        before = K.point_lik_epilogue.launches
        if mode == "scan":
            accept, dq = point_scan_plain(pr.delta, pr.zG, sx["Pblk"], pr.d_pr, pr.lmhg, u)
            ak, dk = K.point_lik_epilogue(*kargs, accept, dq)
            ap, dp = K.point_lik_epilogue_plain(*pargs, accept, dq)
            assert torch.equal(ak, ap)
            assert (ck.q - cp.q).abs().max() <= 1e-5 * max(1.0, float(cp.q.abs().max()))
        else:
            ak, dk = K.point_lik_epilogue(*kargs, None, None, u)
            la = torch.nan_to_num(pr.d_pr + pr.lmhg, nan=-math.inf)
            differ = ((torch.log(u) < la) & sx["valid"]) != ak
            assert torch.all((torch.log(u) - la).abs()[differ] < TIE)
            _, dp = K.point_lik_epilogue_plain(*pargs, ak, None)
            assert torch.equal(ck.q, carry.q)
        assert K.point_lik_epilogue.launches == before + 1
        assert torch.equal(dk, dp)
        for a, b in ((ck.batch.heights, cp.batch.heights), (ck.batch.rates, cp.batch.rates),
                     (ck.terms, cp.terms), (ck.d, cp.d), (ck.acc, cp.acc)):
            assert torch.equal(a.nan_to_num(), b.nan_to_num())
        n_acc += int(ak.sum())
        n += ak.numel()
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


def _range_case(taxa, chains):
    """A synthetic model whose chain 0 has a zero rate at a leaf (its clock
    term -inf, old and new, inside every subtree above the leaf), its
    FastSweeps, carry (z and q filled) and tuning, and the leaf."""
    if taxa == 40:
        model, batch = _model()
    else:
        model, batch = synthetic.build(taxa, chains, device="cuda")
        rng = np.random.default_rng(1)
        batch = batch.replace(
            birth=torch.as_tensor(rng.uniform(0.2, 3, chains), dtype=torch.float32, device="cuda"),
            rate_var=torch.as_tensor(rng.uniform(1e-3, 1, chains), dtype=torch.float32,
                                     device="cuda"))
    leaf = int(np.nonzero(np.asarray(model.topo.is_leaf))[0][0])
    rates = batch.rates.clone()
    rates[0, leaf] = 0.0
    batch = batch.replace(rates=rates)
    fs, table = _fast(model)
    g = torch.Generator(device="cuda").manual_seed(6)
    C = batch.n_chains
    tuning = torch.rand(C, table.n_proposals, generator=g, device="cuda") * 3 + 0.3
    carry = fs.init_carry(batch)
    carry.z, carry.q = fs._zq_from_y(model.whitened_residual_internal(carry.batch))
    return model, fs, carry, tuning, g, leaf


def _range_agree(model, fs, carry, tuning, g, k, sx):
    """One block through ``FastSweeps.range_lik_step`` (K5 on the block's
    shared outputs) against the plain step replayed at the kernels'
    proposals and decisions, on copies of ``carry``; returns the decisions."""
    from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP
    from mcmcdate_tpu_torch.kernels import range_step as K
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    rate = k == TP.K_SCALE_SUBTREE_RATE
    leaf = model.topo.is_leaf_t
    C, S = carry.d.shape[0], sx["rows"].shape[0]
    draw = (standard_gamma(sx["sd"] / tuning[:, sx["rows"]], g) if rate
            else torch.rand(C, S, generator=g, device="cuda"))
    u = torch.rand(C, S, generator=g, device="cuda")
    ck, cr = (TF.FastCarry(State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}),
                           carry.terms.clone(), carry.d.clone(), carry.z.clone(),
                           carry.q.clone(), carry.acc.clone()) for _ in range(2))
    before = [K.range_lik_prologue.launches, K.range_lik_epilogue.launches]
    pro = K.range_lik_prologue(rate, ck.batch, ck.terms, ck.d, ck.z, tuning, sx, leaf,
                               model.clock, draw)
    pp = K.range_lik_prologue_plain(rate, ck.batch, ck.terms, ck.d, ck.z, tuning, sx, leaf,
                                    model.clock, draw)
    ok = sx["valid"]  # an invalid ticket proposes NaN
    prop = pro.prop.clone()  # the step below rewrites the block's buffers
    assert torch.all((prop - pp.prop).abs()[:, ok] <= 1e-5 * (1 + pp.prop.abs()[:, ok]))
    assert bool(torch.isnan(prop[:, ~ok]).all())
    accept = fs.range_lik_step(k, ck, tuning, sx, draw, u)
    assert [K.range_lik_prologue.launches, K.range_lik_epilogue.launches] == [
        before[0] + 2, before[1] + 1]
    forced = torch.where(accept, 0.0, math.nan)
    acc_r, pr, dq_r = K.range_lik_given(rate, cr.batch, cr.terms, cr.d, cr.z, cr.q, cr.acc,
                                        tuning, sx, leaf, model.clock, prop, forced)
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
    return accept


@pytest.mark.parametrize("taxa, chains", ((40, 96), (1100, 8)), ids=("40", "1100"))
def test_range_step_kernel(card, taxa, chains):
    """K5's range step (prologue, range_scan, epilogue) on every likelihood
    range block of both kinds (at 1,100 taxa the three row buckets, the
    256-row one included), each block of a bucket after the one before it
    on the bucket's shared outputs (consecutive blocks whose pad slots
    differ included), against the plain step replayed at the kernel's
    proposals and decisions: proposals within 1e-5 (1 + |x|) of the plain
    ones from the same draws, decisions equal except at ties, heights,
    rates and terms bitwise equal, d, z and q within 1e-5 of scale.  Chain
    0's -inf clock term inside subtrees rejects every ticket whose subtree
    holds it; a block with an invalid ticket never accepts it."""
    from mcmcdate_tpu_torch.engine import proposals as TP
    from mcmcdate_tpu_torch.kernels.range_step import range_plan

    model, fs, carry, tuning, g, leaf = _range_case(taxa, chains)
    n_acc = n = n_holds = n_pad_changes = 0
    for (k, rb), blocks in fs.range_t.items():
        if k == TP.K_SCALE_SUBTREES_CONTRA:
            continue
        for i, sx in enumerate(blocks):
            accept = _range_agree(model, fs, carry, tuning, g, k, sx)
            holds = (sx["own"] == leaf).any(1)
            assert not bool(accept[0][holds].any())
            n_holds += int(holds.sum())
            if i and blocks[i - 1]["own"].shape == sx["own"].shape:
                n_pad_changes += not torch.equal(blocks[i - 1]["own"] < 0, sx["own"] < 0)
            n_acc += int(accept.sum())
            n += accept.numel()
        # A copy of the first block whose second ticket is invalid.
        sx = dict(blocks[0])
        if sx["rows"].shape[0] > 1:
            sx["valid"] = sx["valid"].clone()
            sx["valid"][1] = False
            sx["rplan"], sx["tplan"] = range_plan(sx)
            accept = _range_agree(model, fs, carry, tuning, g, k, sx)
            assert not bool(accept[:, 1].any()) and bool(accept.any())
    assert 0 < n_acc < n and n_holds > 0
    if taxa > 1000:
        assert {rb for (k, rb) in fs.range_t} >= {16, 64, 256} and n_pad_changes > 0


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
    _prior_only_steps(card, step, False)


@pytest.mark.parametrize("step", ("point", "range"))
def test_prior_tempered_prior_only_steps(card, step):
    """The same with the MC3 ladder as each chain's prior temperature, which
    the epilogues' own decisions take."""
    _prior_only_steps(card, step, True)


def _prior_only_steps(card, step, prior):
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
    bp = _mc3_ladder(C) if prior else None
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
                               carry.q.clone(), carry.acc.clone(), beta_prior=bp)
                  for _ in range(2))
        before = [w.launches for w in wrappers]
        accept = run(k, ck, tuning, sx, draw, u)
        assert [w.launches for w in wrappers] == [before[0] + 1, before[1], before[2] + 1]
        pro = prologue(flag, cr.batch, cr.terms, cr.d, None, tuning, sx, leaf,
                       *((fs.pos_t,) if step == "point" else ()), model.clock, draw)
        pr = given(flag, cr, pro.prop)
        la = torch.nan_to_num((1.0 if bp is None else bp[:, None]) * pr.d_pr + pr.lmhg,
                              nan=-math.inf)
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


def _contra_agree(model, batch, table, sx, seed, mode, beta_prior=None, bold=False):
    """K6 in one mode on one step against its plain version.  Proposals may
    differ in their last bits (CUDA's normal CDF and inverse against
    PyTorch's), which a short branch amplifies in its terms: the kernel's
    proposals are held to the plain version's, and, replayed through the
    plain version, to its decisions up to ties and, with the ties taken as
    the kernel took them, to its state on every chain; then to distance
    invariance and to its own terms.  ``bold``: the range mode with the bold
    mixture's uniforms (probability 0.25, factor 8)."""
    from mcmcdate_tpu_torch.kernels import contra_step as K

    kernel, plain, given = (getattr(K, f"contra_{mode}{s}") for s in ("", "_plain", "_given"))
    C, B = batch.n_chains, sx["rows"].shape[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    tuning = torch.rand(C, table.n_proposals, generator=g, device="cuda") * 3 + 0.3
    u_prop = torch.rand(C, B, generator=g, device="cuda")
    u_acc = torch.rand(C, B, generator=g, device="cuda")
    kw = dict(u_bold=torch.rand(C, B, generator=g, device="cuda"), bold_p=0.25,
              bold_factor=8.0) if bold else {}
    terms = model.log_prior_terms(batch)

    def fresh():
        return (State(**{f: getattr(batch, f).clone() for f in FIELDS}), terms.clone(),
                torch.zeros((C, table.n_proposals), dtype=torch.int32, device="cuda"))

    def near(a, b, rel=1e-5):
        fin = torch.isfinite(b)
        assert torch.equal(fin, torch.isfinite(a))
        assert torch.all((a[fin] - b[fin]).abs() <= rel * (1 + b[fin].abs()))

    sk, tk, acck = fresh()
    ok = kernel(sk, tk, acck, tuning, sx, model.topo.is_leaf_t, model.clock, u_prop, u_acc,
                beta_prior, **kw)
    sp, tp, accp = fresh()
    op = plain(sp, tp, accp, tuning, sx, model.topo.is_leaf_t, model.clock, u_prop, u_acc,
               beta_prior, **kw)
    valid = sx["valid"].expand_as(ok.accept)
    assert 0 < int(ok.accept.sum()) < int(valid.sum())
    near(torch.where(valid, ok.h_prop, 0.0), torch.where(valid, op.h_prop, 0.0))
    sr, tr, accr = fresh()
    forced = torch.where(ok.accept, 0.0, math.nan)
    orr = given(sr, tr, accr, tuning, sx, model.topo.is_leaf_t, model.clock, ok.h_prop, forced,
                beta_prior, **kw)
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


def _multifurcating(chains=96):
    """A model on a tree with nodes of three and four children (KC = 4)."""
    from mcmcdate_tpu_torch.models import DatingModel
    from mcmcdate_tpu_torch.models.state import init_state
    from mcmcdate_tpu_torch.ops import mvn
    from mcmcdate_tpu_torch.tree import FlatTopology
    from mcmcdate_tpu_torch.tree.rose import parse_newick

    tree = parse_newick("(((a:1,b:1,c:1):1,((d:0.5,e:0.5,f:0.5,g:0.5):1,(h:1,i:1):0.5):0.5):0.5,"
                        "(j:1.5,(k:0.5,l:0.5):1):1);")
    topo = FlatTopology.from_tree(tree)
    rng = np.random.default_rng(4)
    k = topo.n - 2
    chol = np.tril(rng.normal(size=(k, k)) / np.sqrt(k)) + np.eye(k) * 2.0
    data = mvn.LikelihoodData(kind=mvn.FULL, mu=rng.uniform(0.05, 0.5, size=k),
                              precision=chol @ chol.T, chol_precision=chol,
                              log_det_sigma=float(-2.0 * np.log(np.diag(chol)).sum()))
    model = DatingModel(topo=topo, likelihood=data, device="cuda", dtype=torch.float32)
    batch = init_state(tree, topo, chains, dtype=torch.float32, device="cuda")
    h = batch.heights * torch.as_tensor(rng.uniform(0.9, 1.0, size=(chains, 1)),
                                        dtype=torch.float32, device="cuda")
    h[:, 0] = 1.0
    h[:, model.topo.is_leaf_t] = 0.0
    return model, batch.replace(heights=h, rates=torch.as_tensor(
        rng.gamma(5.0, 0.2, size=(chains, topo.n)), dtype=torch.float32, device="cuda"))


@pytest.mark.parametrize("model_of", ("calibrated", "multifurcating"))
def test_contra_slide_kernel_instantiations(card, model_of):
    """K6's slide mode on every contrary slide step of a calibrated 40-taxon
    model (KC = 2 with a calibration slot) and of a multifurcating one
    (KC = 4), both of which take the generic kernel, against its plain
    version as test_contra_slide_kernel holds it."""
    from mcmcdate_tpu_torch.engine import proposals as TP

    if model_of == "calibrated":
        fs, carry, _, _ = _glob_fast(3, taxa=40, chains=96)
        model, batch, table = fs.model, carry.batch, fs.table
    else:
        model, batch = _multifurcating()
        fs, table = _fast(model)
    steps = fs.spec_t[TP.K_SLIDE_NODES_CONTRA]
    if model_of == "calibrated":
        assert all(sx["ch"].shape[1] == 2 and 0 < sx["cal_lo"].shape[-1] <= 2 for sx in steps)
    else:
        assert all(sx["ch"].shape[1] == 4 for sx in steps)
    for i, sx in enumerate(steps):
        _contra_agree(model, batch, table, sx, 11 + i, "slide")


def test_contra_range_kernel(card):
    from mcmcdate_tpu_torch.engine import proposals as TP

    model, batch = _model()
    fs, table = _fast(model)
    keys = [k for k in fs.range_t if k[0] == TP.K_SCALE_SUBTREES_CONTRA]
    assert keys
    for k in keys:
        _contra_agree(model, batch, table, fs.range_t[k][0], k[1], "range")


@pytest.mark.parametrize("mode", ("slide", "range"))
def test_prior_tempered_contra_kernels(card, mode):
    """K6 in both modes with the MC3 ladder as each chain's prior
    temperature, against its plain version as test_contra_slide_kernel
    holds it, on every step of the kind."""
    from mcmcdate_tpu_torch.engine import proposals as TP

    model, batch = _model()
    fs, table = _fast(model)
    bp = _mc3_ladder(batch.n_chains)
    if mode == "slide":
        steps = fs.spec_t[TP.K_SLIDE_NODES_CONTRA]
    else:
        steps = [blocks[0] for (k, _), blocks in fs.range_t.items()
                 if k == TP.K_SCALE_SUBTREES_CONTRA]
    for i, sx in enumerate(steps):
        _contra_agree(model, batch, table, sx, 21 + i, mode, bp)


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


def _glob_fast(seed, bad_leaf=False, taxa=12, chains=96):
    """FastSweeps on a synthetic model of ``taxa`` leaves and ``chains``
    chains with calibrations, a constraint and a brace and the calibrated
    proposal table (all 14 glob families), a carry, a tuning and a
    generator.  ``bad_leaf``: chain 0's rate of a leaf that is no root
    child is -0.5, so its clock term is -inf."""
    import dataclasses

    from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP
    from mcmcdate_tpu_torch.ops.node_priors import BraceSet, CalibrationSet, ConstraintSet

    model, batch = synthetic.build(taxa, chains, device="cuda")
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
    if bad_leaf:
        topo = model.topo
        leaf = next(j for j in range(topo.n) if topo.is_leaf[j] and topo.parent[j] != 0)
        rates = batch.rates.clone()
        rates[0, leaf] = -0.5
        batch = batch.replace(rates=rates)
    carry = fs.init_carry(batch)
    carry.z, carry.q = fs._zq_from_y(model.whitened_residual_internal(carry.batch))
    g = torch.Generator(device="cuda").manual_seed(seed)
    tuning = torch.rand(chains, table.n_proposals, generator=g, device="cuda") * 3 + 0.3
    return fs, carry, tuning, g


def _near(a, b, lim):
    fin = torch.isfinite(b)
    assert torch.equal(fin, torch.isfinite(a))
    assert torch.all((a - b).abs()[fin] <= (lim[fin] if torch.is_tensor(lim) else lim))


def _glob_copy(carry):
    from mcmcdate_tpu_torch.engine.fast_sweep import FastCarry

    return FastCarry(State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}),
                     carry.terms.clone(), carry.d.clone(), carry.z.clone(), carry.q.clone(),
                     carry.acc.clone())


def _glob_replay_agree(fs, tag, ck, cr, tun, draws, u, accept, prop, mean):
    """A family's kernel run (carry ``ck``: its accept mask, proposals and
    var_tree means) against the plain family scan on ``cr`` replayed at the
    kernels' proposals and decisions: proposals within 1e-5 (1 + |x|) of
    the plain ones from the same draws (plus 8 float32 ulps of the CDF
    value a truncated-normal proposal inverts), decisions equal except at
    ties, heights, rates, scalars and terms bitwise equal, d, z and q within
    1e-5 of scale, accept counts equal."""
    forced = torch.where(accept, 0.0, math.nan)
    rec = fs.glob_family_plain(tag, cr, tun, draws, forced, given=dict(prop=prop, mean=mean))
    # Within a few float32 ulps of the CDF value the proposal inverts.
    lim = 1e-5 * (1 + rec.prop.abs())
    if rec.dx_dp is not None:
        lim = lim + 8 * torch.finfo(torch.float32).eps * rec.dx_dp
    _near(prop, rec.prop, lim)
    if mean is not None:
        _near(mean, rec.mean, 1e-5 * (1 + rec.mean.abs()))
    assert torch.equal(rec.accept, accept)
    differ = (torch.log(u) < rec.log_alpha) != accept
    assert torch.all((torch.log(u) - rec.log_alpha).abs()[differ] < TIE)
    for f in FIELDS:
        assert torch.equal(getattr(ck.batch, f).nan_to_num(), getattr(cr.batch, f).nan_to_num())
    assert torch.equal(ck.terms.nan_to_num(), cr.terms.nan_to_num())
    for a, b in ((ck.d, cr.d), (ck.z, cr.z), (ck.q, cr.q)):
        _near(a, b, 1e-5 * max(1.0, float(b.abs().max())))
    assert torch.equal(ck.acc, cr.acc)


@pytest.mark.parametrize("dense, budget, taxa, chains",
                         ((False, None, 12, 96), (False, 0, 12, 96), (True, None, 12, 96),
                          (False, None, 1100, 8)),
                         ids=("G1", "G1-global", "G2-G3", "G1-wide"))
def test_glob_kernels(card, dense, budget, taxa, chains):
    """G1 glob_scan (the scan families; also with every chain array in
    global memory, a shared-memory budget of 0, and at 1,100 taxa x 8
    chains, where sub_contra's arrays take more than the 48 KB a launch
    gets without opting in) or G2 and G3 around the product (the dense
    families; a subtree ticket's over its support rows) on every family of
    a calibrated model whose chain 0 has a -inf clock term at a leaf,
    against the plain family scan replayed at the
    kernels' proposals and decisions: proposals within 1e-5 (1 + |x|) of
    the plain ones from the same draws (plus 8 float32 ulps of the CDF
    value a truncated-normal proposal inverts), decisions equal except at
    ties, heights, rates, scalars and terms bitwise equal, d, z and q within
    1e-5 of scale, accept counts equal, chain 0 rejecting every ticket of
    the subtree families (which evaluate only their subtree's entries); one
    G1 launch per family, one G2 and one G3 per ticket."""
    from mcmcdate_tpu_torch.kernels import glob_step as G
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    fs, carry, tuning, g = _glob_fast(8, bad_leaf=True, taxa=taxa, chains=chains)
    C = carry.d.shape[0]

    n_acc = n = 0
    wrappers = (G.glob_scan, G.glob_dense_prologue, G.glob_dense_epilogue)
    for tag, fam in fs.glob_fam.items():
        if (G.FAMILIES[tag].lik == G.DENSE) != dense:
            continue
        tun = tuning.index_select(1, fam.rows)
        draws = (standard_gamma(fam.sd / tun, g) if tag in G.GAMMA_TAGS
                 else torch.rand(C, fam.n, generator=g, device=card))
        u = torch.rand(C, fam.n, generator=g, device=card)
        ck, cr = _glob_copy(carry), _glob_copy(carry)
        before = [w.launches for w in wrappers]
        if dense:
            acc, prop, mean = [], [], []
            nbad = None
            for s in range(fam.n):
                pro = G.glob_dense_prologue(fs.glob, fam, s, ck, tun, draws, nbad)
                nbad = pro.nbad
                acc.append(G.glob_dense_epilogue(fs.glob, fam, s, ck, pro,
                                                 fs.glob_product(fam, s, pro), u))
                prop.append(pro.prop)
                mean.append(pro.mean)
            accept, prop = torch.stack(acc, 1), torch.stack(prop, 1)
            mean = torch.stack(mean, 1) if tag == "var_tree" else None
            assert [w.launches for w in wrappers] == [before[0], before[1] + fam.n,
                                                      before[2] + fam.n]
        else:
            nbytes, arrays = G.glob_scan_smem(fs.glob, fam, ck, budget)
            assert (nbytes == 0) == (budget == 0) and (not arrays) == (budget == 0)
            if taxa > 1000 and tag == "sub_contra":
                assert nbytes > 48 * 1024
            out = G.glob_scan(fs.glob, fam, ck, tun, draws, u, smem_budget=budget)
            accept, prop, mean = out.accept, out.prop, None
            assert [w.launches for w in wrappers] == [before[0] + 1, before[1], before[2]]
        _glob_replay_agree(fs, tag, ck, cr, tun, draws, u, accept, prop, mean)
        if tag.startswith("sub_"):
            assert not accept[0].any() and accept[1:].any()
        n_acc += int(accept.sum())
        n += accept.numel()
    assert 0 < n_acc < n


@pytest.mark.parametrize("u_acc, taxa, chains",
                         ((0.0, 40, 96), (1.0, 40, 96), (math.nan, 40, 96), (0.0, 600, 16)),
                         ids=("accept", "one", "reject", "accept-600"))
def test_glob_dense_epilogue_forced(card, u_acc, taxa, chains):
    """G3 on every ticket of every dense family of a calibrated model (40
    taxa: every write-back segment in the flat walk; 600: the long ones, z
    and the whole-D arrays, in 16-byte copies) with one accept uniform for
    all: 0 (every chain with a finite log alpha accepts), 1 (those with a
    positive one) and NaN (none).  After
    each launch on a subtree ticket d is bitwise untouched off its support
    rows (G3 writes those alone); a rejecting chain's d, z and q are
    bitwise untouched; the family against the plain replay as in
    test_glob_kernels (z, q within 1e-5 of scale, accept counts equal)."""
    from mcmcdate_tpu_torch.kernels import glob_step as G
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    fs, carry, tuning, g = _glob_fast(9, taxa=taxa, chains=chains)
    C, D = carry.d.shape
    for tag, fam in fs.glob_fam.items():
        if G.FAMILIES[tag].lik != G.DENSE:
            continue
        tun = tuning.index_select(1, fam.rows)
        draws = (standard_gamma(fam.sd / tun, g) if tag in G.GAMMA_TAGS
                 else torch.rand(C, fam.n, generator=g, device=card))
        u = torch.full((C, fam.n), u_acc, device=card)
        ck, cr = _glob_copy(carry), _glob_copy(carry)
        acc, prop, mean = [], [], []
        nbad = None
        for s in range(fam.n):
            pro = G.glob_dense_prologue(fs.glob, fam, s, ck, tun, draws, nbad)
            nbad = pro.nbad
            d0, z0, q0 = ck.d.clone(), ck.z.clone(), ck.q.clone()
            a = G.glob_dense_epilogue(fs.glob, fam, s, ck, pro, fs.glob_product(fam, s, pro), u)
            if tag in G.SUBTREE_DENSE:
                off = torch.ones(D, dtype=torch.bool, device=card)
                rows = fs.glob.support(int(fam.grp.lo[s]), int(fam.grp.hi[s]))
                off[torch.as_tensor(rows, device=card)] = False
                assert torch.equal(ck.d[:, off], d0[:, off])
            for x, x0 in ((ck.d, d0), (ck.z, z0), (ck.q, q0)):
                assert torch.equal(x[~a], x0[~a])
            acc.append(a)
            prop.append(pro.prop)
            mean.append(pro.mean)
        accept = torch.stack(acc, 1)
        if math.isnan(u_acc):
            assert not accept.any()
        elif u_acc == 0.0:
            assert accept.sum() > accept.numel() // 2
        _glob_replay_agree(fs, tag, ck, cr, tun, draws, u, accept, torch.stack(prop, 1),
                           torch.stack(mean, 1) if tag == "var_tree" else None)


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


@pytest.mark.parametrize("lik", ("full", "univariate", "none"))
@pytest.mark.parametrize("kind", ("light", "heavy", "segments"))
def test_ticket_scan_light_and_heavy(card, lik, kind):
    """T3's two kernels on a 192-ticket run that breaks no run: every ticket
    light (``ticket_run_kernel``, a warp per chain), every ticket heavy
    (``ticket_scan_kernel``, a CTA per chain; ``HEAVY`` lowered below every
    ticket's work) and the run cut as a sweep cuts it at the median work
    (both kernels, launch after launch), each against ticket_scan_plain
    replayed segment by segment at the kernels' proposals, rate means and
    decisions (see _ticket_agree: decisions up to ties, state, terms and d
    bitwise, y within 1e-5 of its scale; the warp sums d_pr and d_lik in
    another order than the CTA)."""
    from mcmcdate_tpu_torch.kernels import ticket_step as TS

    tk, carry, tuning, g = _ticket_setup(lik, 40)
    tt = tk.tt
    tickets = np.asarray(tt.table.tickets)
    ok = np.asarray([not tt.breaks(int(p)) for p in tickets])
    order = np.random.default_rng(6).choice(tickets[ok], 192).astype(np.int32)
    dr = tk.draws(order, tuning, torch.Generator(device="cuda").manual_seed(7))
    saved = TS.HEAVY
    TS.HEAVY = {"light": 10 ** 9, "heavy": -1, "segments": int(np.median(tt.work[order]))}[kind]
    try:
        segs = tt.segments(order) if kind == "segments" else [(0, len(order), True)]
        before = dict(ticket_scan.launches_by_kind)
        ck, cp = _copy(carry), _copy(carry)
        forced = torch.full_like(dr.u_acc, math.nan)
        accept, la = [], []
        for j0, nj, run in segs:
            assert run
            out = ticket_scan(tt, ck, tuning, dr, j0, nj, out=True)
            forced[:, j0:j0 + nj] = torch.where(out.accept, 0.0, math.nan)
            rec = ticket_scan_plain(tt, cp, tuning, dr._replace(u_acc=forced), j0, nj,
                                    given=dict(prop=out.prop, mean=out.mean))
            assert torch.equal(rec.accept, out.accept)
            _prop_near(out.prop, rec.prop, rec.dx_dp)
            accept.append(out.accept)
            la.append(rec.log_alpha)
        got = {k: ticket_scan.launches_by_kind[k] - before[k] for k in before}
    finally:
        TS.HEAVY = saved
    want = {"light": {"light": 1, "heavy": 0}, "heavy": {"light": 0, "heavy": 1}}.get(kind)
    if want is None:
        assert got["light"] > 0 and got["heavy"] > 0 and sum(got.values()) == len(segs)
    else:
        assert got == want
    accept = torch.cat(accept, 1)
    assert 0 < int(accept.sum()) < accept.numel()
    _ticket_agree(ck, cp, torch.log(dr.u_acc), torch.cat(la, 1), accept)


def _corr(p, seed):
    """A correlation matrix of 3 p standardized samples of a random
    precision: the graphical lasso's input."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(p, p)) / np.sqrt(p)
    x = rng.multivariate_normal(np.zeros(p), np.linalg.inv(a @ a.T + np.eye(p)), size=3 * p)
    x = (x - x.mean(0)) / x.std(0, ddof=1)
    return np.cov(x, rowvar=False)


@pytest.mark.parametrize("p", (64, 101))
def test_glasso_admm_kernels(card, p):
    """A1-A3 against their plain versions on the card, at float64: A1's A
    and U, A2's Qs (on eigh's column-major Q and a row-major copy) and A3's
    Z and U bitwise; A3's two sums within 1e-12 (another order)."""
    from mcmcdate_tpu_torch.kernels import glasso_admm as K

    g = np.random.default_rng(p)
    f64 = dict(dtype=torch.float64, device="cuda")
    S = torch.as_tensor(_corr(p, 1), **f64)
    Z = torch.as_tensor(g.normal(size=(p, p)) * 0.1, **f64)
    U0 = torch.as_tensor(g.normal(size=(p, p)) * 0.1, **f64)
    t, fac = 1.7, 0.5
    before = [k.launches for k in K.KERNELS]
    Uk, Up = U0.clone(), U0.clone()
    A = K.admm_shift(Z, Uk, S, t, fac)
    assert torch.equal(A, K.admm_shift_plain(Z, Up, S, t, fac)) and torch.equal(Uk, Up)
    assert torch.equal(A, A.mT)
    lam, Q = torch.linalg.eigh(A)
    for q in (Q, Q.contiguous()):
        qs = K.admm_eig_scale(lam, q, t)
        assert qs.stride() == q.stride()
        assert torch.equal(qs, K.admm_eig_scale_plain(lam, q, t))
    T = K.admm_eig_scale(lam, Q, t) @ Q.mT
    Zk, Zp = Z.clone(), Z.clone()
    rs = K.admm_update(T, Zk, Uk, 1.5, 0.1 / t)
    rp = K.admm_update_plain(T, Zp, Up, 1.5, 0.1 / t)
    assert torch.equal(Zk, Zp) and torch.equal(Uk, Up)
    assert 0 < int((Zk == 0).sum()) < p * p
    assert torch.allclose(rs, rp, rtol=1e-12, atol=0)
    assert [k.launches - b for k, b in zip(K.KERNELS, before)] == [1, 3, 1]


def test_glasso_admm_kernel_route(card):
    """The whole ADMM through A1-A3 against the plain route on the card:
    the same iterations, zero pattern and Theta and W within 1e-10; A1-A3
    launched once an iteration each."""
    from mcmcdate_tpu_torch.kernels import glasso_admm as K
    from mcmcdate_tpu_torch.utils import glasso

    S = torch.as_tensor(_corr(150, 2), dtype=torch.float64, device="cuda")
    before = [k.launches for k in K.KERNELS]
    run_k = glasso.admm_solve(S, 0.1)
    run_p = glasso.admm_solve(S, 0.1, ops=K.PLAIN)
    n = run_k.iterations
    assert [k.launches - b for k, b in zip(K.KERNELS, before)] == [n, n, n]
    assert n == run_p.iterations and n > 2
    assert torch.equal(run_k.Z == 0, run_p.Z == 0)
    assert float((run_k.Z - run_p.Z).abs().max()) <= 1e-10
    Wk = np.linalg.inv(run_k.Z.cpu().numpy())
    Wp = np.linalg.inv(run_p.Z.cpu().numpy())
    assert np.abs(Wk - Wp).max() <= 1e-10


# -- the likelihood temperature of the decision kernels, and cascade_seed ------


def _ladder(C):
    """The 128-point stepping-stone ladder tiled over ``C`` chains: every
    beta in [0, 1], chain c at point c mod 128."""
    from mcmcdate_tpu_torch.engine.stepping_stone import beta_ladder

    return torch.as_tensor(np.resize(beta_ladder(128), C), dtype=torch.float32, device="cuda")


def _mc3_ladder(C):
    """A 4-rung MC3 ladder (rung gaps 0.3, 0.6, 1.0) tiled over ``C``
    chains, chain c at rung c mod 4."""
    from mcmcdate_tpu_torch.engine.mc3 import ladder_of

    return torch.as_tensor(np.resize(ladder_of([0.3, 0.6, 1.0]), C), dtype=torch.float32,
                           device="cuda")


SCAN_SHAPES = (("point", 64, 150, 3), ("point", 17, 70, 5), ("range", 70, 64, 16),
               ("range", 33, 4, 256))


@pytest.mark.parametrize("which, C, B, KD", SCAN_SHAPES)
def test_tempered_scan_kernels(card, which, C, B, KD):
    """K4 point_scan (KD 3: tickets in registers; KD 5: in shared memory)
    and K5 range_scan (B tickets of KD rows) with a beta ladder against
    their plain versions: decisions up to ties of the tempered log alpha,
    dq within 1e-5 of scale; beta = 0 chains take the prior's decision."""
    _tempered_scans(card, which, C, B, KD, None)


@pytest.mark.parametrize("which, C, B, KD", SCAN_SHAPES)
def test_prior_tempered_scan_kernels(card, which, C, B, KD):
    """The same with the MC3 ladder as each chain's prior temperature
    besides the beta ladder as its likelihood temperature."""
    _tempered_scans(card, which, C, B, KD, _mc3_ladder(C))


def _tempered_scans(card, which, C, B, KD, beta_prior):
    from mcmcdate_tpu_torch.kernels.point_scan import pitched, point_scan, point_scan_plain
    from mcmcdate_tpu_torch.kernels.range_scan import kernel_layout, range_scan, range_scan_plain

    g = torch.Generator(device=card).manual_seed(B + KD)
    beta = _ladder(C)
    F = B * KD
    a = torch.randn(F, F, generator=g, device=card) / F ** 0.5
    P = a @ a.T + torch.eye(F, device=card)
    d_pr = 0.1 * torch.randn(C, B, generator=g, device=card)
    lmhg = torch.randn(C, B, generator=g, device=card)
    u = torch.rand(C, B, generator=g, device=card)
    if which == "point":
        delta = 0.3 * torch.randn(C, B, KD, generator=g, device=card)
        zG = torch.randn(C, F, generator=g, device=card)
        args = (delta, zG, pitched(P), d_pr, lmhg, u)
        before = point_scan.launches
        ak, dk = point_scan(*args, beta, beta_prior)
        assert point_scan.launches == before + 1
        ap, dp = point_scan_plain(delta, zG, P, d_pr, lmhg, u, beta, beta_prior)
        a1, _ = point_scan_plain(delta, zG, P, d_pr, lmhg, u)
    else:
        gg = torch.randn(C, B, KD, generator=g, device=card)
        zg = torch.randn(C, B, KD, generator=g, device=card)
        coef = 0.1 * torch.randn(C, B, generator=g, device=card)
        args = (gg, zg, kernel_layout(P), coef, d_pr, lmhg, u)
        before = range_scan.launches
        ak, dk = range_scan(*args, beta, beta_prior)
        assert range_scan.launches == before + 1
        ap, dp = range_scan_plain(gg, zg, P, coef, d_pr, lmhg, u, beta, beta_prior)
        a1, _ = range_scan_plain(gg, zg, P, coef, d_pr, lmhg, u)
    assert 0 < int(ap.sum()) < ap.numel() and not torch.equal(ap, a1)
    bp = 1.0 if beta_prior is None else beta_prior[:, None]
    _scan_agree(ak, dk, ap, dp, bp * d_pr - 0.5 * (beta[:, None] * dp) + lmhg, torch.log(u))


@pytest.mark.parametrize("lik", ("full", "univariate"))
def test_tempered_ticket_kernels(card, lik):
    """K3 after T1 (and K2) on one ticket of every kind and likelihood class,
    then T3's light and heavy kernels on a 192-ticket run, all with a beta
    ladder in the carry, against the plain versions replayed at the
    kernels' proposals and decisions (see _ticket_agree)."""
    _tempered_tickets(card, lik, False)


@pytest.mark.parametrize("lik", ("full", "univariate"))
def test_prior_tempered_ticket_kernels(card, lik):
    """The same with the MC3 ladder as each chain's prior temperature."""
    _tempered_tickets(card, lik, True)


def _tempered_tickets(card, lik, prior):
    from mcmcdate_tpu_torch.engine import proposals as TP
    from mcmcdate_tpu_torch.kernels import ticket_step as TS

    tk, carry, tuning, g = _ticket_setup(lik, 40)
    tt = tk.tt
    C = carry.terms.shape[0]
    carry.beta = _ladder(C)
    carry.beta_prior = _mc3_ladder(C) if prior else None

    def tempered(c):
        c = _copy(c)
        c.beta, c.beta_prior = carry.beta, carry.beta_prior
        return c

    rows = {}
    for p, kind in enumerate(tt.table.kind):
        rows.setdefault((int(kind), int(tt.d_class[p])), p)
    n_acc = 0
    for p in sorted(set(rows.values())):
        draw = (torch._standard_gamma(float(tt.table.par[p]) / tuning[:, p], generator=g)
                if tt.gamma[p] else torch.rand(C, generator=g, device=card))
        u = torch.rand(C, generator=g, device=card)
        dr = TicketDraws.single(p, draw, u)
        ck, cp = tempered(carry), tempered(carry)
        pro = ticket_prologue(tt, ck, tuning, dr, 0)
        prop = pro.prop.clone()
        mean = None if pro.mean is None else pro.mean.clone()
        dy, d_lik = tk._k2(ck, p, pro)
        ak = accept_select(tt, ck, tuning, dr, 0, pro, dy, d_lik)
        pp = ticket_prologue_plain(tt, cp, tuning, p, draw, given=prop, given_mean=mean)
        ap, la_p = accept_select_plain(tt, cp, p, pp, torch.where(ak, 0.0, math.nan), dy, d_lik)
        assert torch.equal(ak, ap), tt.table.names[p]
        _ticket_agree(ck, cp, torch.log(u), la_p, ak)
        n_acc += int(ak.sum())
    assert n_acc > 0
    tickets = np.asarray(tt.table.tickets)
    ok = np.asarray([not tt.breaks(int(p)) for p in tickets])
    order = np.random.default_rng(8).choice(tickets[ok], 192).astype(np.int32)
    dr = tk.draws(order, tuning, torch.Generator(device="cuda").manual_seed(9))
    saved = TS.HEAVY
    for kind, heavy in (("light", 10 ** 9), ("heavy", -1)):
        TS.HEAVY = heavy
        try:
            before = dict(ticket_scan.launches_by_kind)
            ck, cp = tempered(carry), tempered(carry)
            out = ticket_scan(tt, ck, tuning, dr, 0, len(order), out=True)
            assert ticket_scan.launches_by_kind[kind] == before[kind] + 1
        finally:
            TS.HEAVY = saved
        rec = ticket_scan_plain(tt, cp, tuning, dr._replace(
            u_acc=torch.where(out.accept, 0.0, math.nan)), 0, len(order),
            given=dict(prop=out.prop, mean=out.mean))
        assert torch.equal(rec.accept, out.accept)
        assert 0 < int(out.accept.sum()) < out.accept.numel()
        _ticket_agree(ck, cp, torch.log(dr.u_acc), rec.log_alpha, out.accept)


@pytest.mark.parametrize("dense", (False, True), ids=("G1", "G3"))
def test_tempered_glob_kernels(card, dense):
    """G1 on the scan families and G2/G3 on the dense ones with a beta
    ladder in the carry, against the plain family scan replayed at the
    kernels' proposals and decisions (see _glob_replay_agree)."""
    _tempered_glob(card, dense, False)


@pytest.mark.parametrize("dense", (False, True), ids=("G1", "G3"))
def test_prior_tempered_glob_kernels(card, dense):
    """The same with the MC3 ladder as each chain's prior temperature."""
    _tempered_glob(card, dense, True)


def _tempered_glob(card, dense, prior):
    from mcmcdate_tpu_torch.kernels import glob_step as G
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    fs, carry, tuning, g = _glob_fast(10, taxa=40, chains=96)
    C = carry.d.shape[0]
    carry.beta = _ladder(C)
    carry.beta_prior = _mc3_ladder(C) if prior else None
    n_acc = n = 0
    for tag, fam in fs.glob_fam.items():
        if (G.FAMILIES[tag].lik == G.DENSE) != dense:
            continue
        tun = tuning.index_select(1, fam.rows)
        draws = (standard_gamma(fam.sd / tun, g) if tag in G.GAMMA_TAGS
                 else torch.rand(C, fam.n, generator=g, device=card))
        u = torch.rand(C, fam.n, generator=g, device=card)
        ck, cr = _glob_copy(carry), _glob_copy(carry)
        ck.beta = cr.beta = carry.beta
        ck.beta_prior = cr.beta_prior = carry.beta_prior
        if dense:
            acc, prop, mean = [], [], []
            nbad = None
            for s in range(fam.n):
                pro = G.glob_dense_prologue(fs.glob, fam, s, ck, tun, draws, nbad)
                nbad = pro.nbad
                acc.append(G.glob_dense_epilogue(fs.glob, fam, s, ck, pro,
                                                 fs.glob_product(fam, s, pro), u))
                prop.append(pro.prop)
                mean.append(pro.mean)
            accept, prop = torch.stack(acc, 1), torch.stack(prop, 1)
            mean = torch.stack(mean, 1) if tag == "var_tree" else None
        else:
            out = G.glob_scan(fs.glob, fam, ck, tun, draws, u)
            accept, prop, mean = out.accept, out.prop, None
        _glob_replay_agree(fs, tag, ck, cr, tun, draws, u, accept, prop, mean)
        n_acc += int(accept.sum())
        n += accept.numel()
    assert 0 < n_acc < n


@pytest.mark.parametrize("taxa, groups", ((136, 16), (1000, 8)))
def test_mc3_swap_kernel(card, taxa, groups):
    """M1 mc3_swap against its plain version on the same U and draws: the
    permuted state, U, each decision and the per-pair counts bitwise, one
    launch a move, three moves in a row (the last CTA's ticket counter is
    left at 0 for the next); with equal U and uniforms of 1 every draw
    rejects (log 1 < 0 is false) and nothing moves."""
    from mcmcdate_tpu_torch.engine.mc3 import N_TEMPS, swap_draws, temperature_ladder
    from mcmcdate_tpu_torch.kernels.mc3_swap import mc3_swap, mc3_swap_plain

    C = groups * N_TEMPS
    _, batch = synthetic.build(taxa, C, device="cuda")
    g = torch.Generator(device=card).manual_seed(taxa)
    batch = State(**{f: torch.rand(getattr(batch, f).shape, generator=g, device=card)
                     for f in FIELDS})
    betas = torch.as_tensor(temperature_ladder(N_TEMPS, 0.5), dtype=torch.float32, device=card)
    n_acc = n = 0
    for rep in range(4):
        U = 4 * torch.randn(C, generator=g, device=card)
        pair, u = swap_draws(g, groups)
        if rep == 3:
            U, u = torch.zeros_like(U), torch.ones_like(u)
        ck, cp = (State(**{f: getattr(batch, f).clone() for f in FIELDS}) for _ in range(2))
        Uk, Up = U.clone(), U.clone()
        before = mc3_swap.launches
        ak, pak, ptk = mc3_swap(ck, Uk, pair, u, betas)
        assert mc3_swap.launches == before + 1
        ap, pap, ptp = mc3_swap_plain(cp, Up, pair, u, betas)
        assert torch.equal(ak, ap) and torch.equal(Uk, Up)
        assert torch.equal(pak, pap) and torch.equal(ptk, ptp)
        assert int(ptk.sum()) == ak.numel() and int(pak.sum()) == int(ak.sum())
        for f in FIELDS:
            assert torch.equal(getattr(ck, f), getattr(cp, f)), f
        if rep == 3:
            assert not ak.any()
            for f in FIELDS:
                assert torch.equal(getattr(ck, f), getattr(batch, f)), f
        n_acc += int(ak.sum())
        n += ak.numel()
        batch = ck
    assert 0 < n_acc < n


def test_cascade_seed_kernel(card):
    """cascade_seed against its plain version (the per-field copy) on every
    row of a 136-taxon batch of 12 chains: bitwise, one launch a row, the
    other rows untouched."""
    from mcmcdate_tpu_torch.kernels.cascade_seed import cascade_seed, cascade_seed_plain

    _, batch = synthetic.build(136, 12, device="cuda")
    g = torch.Generator(device=card).manual_seed(12)
    batch = State(**{f: torch.rand(getattr(batch, f).shape, generator=g, device=card)
                     for f in FIELDS})
    for j in range(11):
        ck = State(**{f: getattr(batch, f).clone() for f in FIELDS})
        cp = State(**{f: getattr(batch, f).clone() for f in FIELDS})
        before = cascade_seed.launches
        cascade_seed(ck, j)
        assert cascade_seed.launches == before + 1
        cascade_seed_plain(cp, j)
        for f in FIELDS:
            assert torch.equal(getattr(ck, f), getattr(cp, f)), f
        batch = ck
    with pytest.raises(ValueError, match="no next row"):
        cascade_seed(batch, 11)


@pytest.mark.parametrize("wb", [8, 33, 128])
@pytest.mark.parametrize("which", ["L3", "P3"])
def test_band_matmul_kernels(card, wb, which):
    """B1 and B2 against their plain versions on the card: whole and on
    windows of output blocks, with sub, x_rows, both reductions and into,
    at 1e-5 of the largest output; one launch a call."""
    from mcmcdate_tpu_torch.kernels import band_matmul as B
    from mcmcdate_tpu_torch.ops import banded

    rng = np.random.default_rng(wb)
    D, w, C = 301, min(wb, 24), 200
    xs = rng.normal(size=(80, D + 2))
    _, lb, _ = banded.estimate_banded_chol(xs[:, :D] + 0.5 * xs[:, 2:], w)
    M3 = (banded.blocks_from_upper_band(lb, wb) if which == "L3"
          else banded.blocks_from_sym_band(banded.pband_from_chol_upper(lb), wb))
    nb = M3.shape[0]

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=card).contiguous()

    M3, x, y, sub = t(M3), t(rng.normal(size=(C, D))), t(rng.normal(size=(C, D))), t(
        rng.normal(size=D))
    upper = which == "L3"
    for fn, plain in ((B.band_matmul, B.band_matmul_plain), (B.band_matmul_t,
                                                            B.band_matmul_t_plain)):
        for win in (None, (1, nb - 1), (nb - 1, nb), (0, 1)):
            for kw in (dict(sub=sub), dict(y=y), dict(y=y, x_rows=(wb + 3, 3 * wb - 1))):
                before = fn.launches
                out, red = fn(x, M3, window=win, upper=upper, **kw)
                assert fn.launches == before + 1
                ref, rref = plain(x, M3, window=win, upper=upper, **kw)
                scale = float(ref.abs().max()) + 1.0
                assert float((out - ref).abs().max()) <= 1e-5 * scale
                assert float((red - rref).abs().max()) <= 1e-5 * (float(rref.abs().max()) + 1)
            into, iref = y.clone(), y.clone()
            fn(x, M3, window=win, upper=upper, into=into)
            plain(x, M3, window=win, upper=upper, into=iref)
            assert float((into - iref).abs().max()) <= 1e-5 * (float(iref.abs().max()) + 1)


def test_banded_fast_sweeps_on_card(card):
    """FastSweeps and MHKernel on a banded synthetic model of 40 taxa and 96
    chains: B1 and B2 launched, no plain product, and the carried log
    likelihood within 1e-5 of a fresh one."""
    from mcmcdate_tpu_torch.engine import fast_sweep as TF, mh as TM, proposals as TP
    from mcmcdate_tpu_torch.kernels import band_matmul as B

    model, batch = synthetic.build(40, 96, device="cuda", kind="banded", bandwidth=16)
    table = TP.build_proposal_table(model.topo, model.braces, False)
    tuning = torch.ones((96, table.n_proposals), device=card)
    for kern in (TF.FastSweeps(model, table), TM.MHKernel(model, table)):
        b1, b2 = B.band_matmul.launches, B.band_matmul_t.launches
        out, lp_pr, lp_lik, *_ = kern.sweeps(batch, tuning, 3, 2)
        assert B.band_matmul.launches > b1
        assert (B.band_matmul_t.launches > b2) == isinstance(kern, TF.FastSweeps)
        fresh = model.log_likelihood(out)
        assert float((lp_lik - fresh).abs().max()) <= 1e-5 * float(fresh.abs().max())


def _nuts_model(case: str, chains: int = 64):
    """A 40-taxon model for the NUTS kernels: the full kind with node
    priors, or the univariate, banded or none kind (the full kind's mean)."""
    import dataclasses

    from mcmcdate_tpu_torch.models.dating import DatingModel
    from mcmcdate_tpu_torch.ops import mvn

    kind = "banded" if case == "banded" else "full"
    extra = _node_priors(synthetic.build(40, 1, device="cuda")[0].topo) if case == "priors" else {}
    model, batch = synthetic.build(40, chains, device="cuda", kind=kind, bandwidth=16,
                                   clock=clocks.AUTOCORRELATED_GAMMA if case == "none"
                                   else clocks.UNCORRELATED_GAMMA, **extra)
    if case in ("univariate", "none"):
        lik = model.likelihood
        rng = np.random.default_rng(1)
        data = (mvn.LikelihoodData.univariate(lik.mu, rng.uniform(1e-3, 1e-2, lik.dim))
                if case == "univariate" else mvn.LikelihoodData.none())
        model = DatingModel(**{f.name: getattr(model, f.name) for f in dataclasses.fields(model)
                               if f.name != "likelihood"}, likelihood=data)
    return model, batch


@pytest.mark.parametrize("case", ("priors", "univariate", "banded", "none"))
def test_nuts_kernels(card, case):
    """H1, H2 and H3 against their plain versions along a whole trajectory
    of up to MAX_DEPTH doublings on 64 chains, each launch replayed from the
    kernels' state (``kernels.nuts_step.NutsCheck``: the fields within
    ``CHECK_TOL``, the decisions equal up to ties), with a likelihood
    temperature ladder; at a step of 1e-3 some chain doubles at least 7
    times (8 on an H100), so the deep U-turn checks and checkpoint slots
    are replayed."""
    from mcmcdate_tpu_torch.engine import hmc
    from mcmcdate_tpu_torch.kernels import nuts_step as NS

    model, batch = _nuts_model(case)
    mv = hmc.NutsMove(model, NS.MAX_DEPTH)
    q0 = mv.coords.to_vector(batch)
    C, dim = q0.shape
    inv_mass = torch.full((dim,), 1e-3, device=card)
    gen = torch.Generator(device=card).manual_seed(5)
    draws = hmc.NutsDraws(gen, C, dim, torch.float32, card)
    beta = torch.linspace(0.0, 1.0, C, device=card)
    chk = NS.NutsCheck(mv.work(C, torch.float32, card), mv.coords)
    before = (NS.nuts_leapfrog_prologue.launches, NS.nuts_leapfrog_epilogue.launches,
              NS.nuts_merge.launches)
    q, astat, n = mv.trajectory(batch, q0, 1e-3, inv_mass, draws, beta_lik=beta, check=chk)
    torch.cuda.synchronize()
    after = (NS.nuts_leapfrog_prologue.launches, NS.nuts_leapfrog_epilogue.launches,
             NS.nuts_merge.launches)
    assert after[0] - before[0] == after[1] - before[1] >= 2 and after[2] > before[2]
    assert chk.compared == sum(a - b for a, b in zip(after, before))
    assert torch.isfinite(q).all() and torch.isfinite(astat).all() and int(n.max()) > 1
    assert chk.depth >= 7


# -- the bold mixture in K6 and G1, and the fiber moves F1 and F2 --------------


def test_contra_range_bold_kernel(card):
    """K6's range mode with the bold mixture's uniforms on the first block
    of every contrary bucket, against its plain version as
    test_contra_slide_kernel holds it; uniforms that never choose the bold
    kernel leave the call bitwise the one without them."""
    from mcmcdate_tpu_torch.engine import proposals as TP
    from mcmcdate_tpu_torch.kernels.contra_step import contra_range

    model, batch = _model()
    fs, table = _fast(model)
    keys = [k for k in fs.range_t if k[0] == TP.K_SCALE_SUBTREES_CONTRA]
    assert keys
    for k in keys:
        sx = fs.range_t[k][0]
        _contra_agree(model, batch, table, sx, 31 + k[1], "range", bold=True)
        before = contra_range.launches_bold
        C, S = batch.n_chains, sx["rows"].shape[0]
        g = torch.Generator(device="cuda").manual_seed(k[1])
        tuning = torch.rand(C, table.n_proposals, generator=g, device="cuda") + 0.5
        u_prop, u_acc = (torch.rand(C, S, generator=g, device="cuda") for _ in range(2))
        outs = []
        for kw in ({}, dict(u_bold=torch.ones(C, S, device="cuda"), bold_p=0.25)):
            st = State(**{f: getattr(batch, f).clone() for f in FIELDS})
            terms = model.log_prior_terms(st)
            acc = torch.zeros((C, table.n_proposals), dtype=torch.int32, device="cuda")
            o = contra_range(st, terms, acc, tuning, sx, model.topo.is_leaf_t, model.clock,
                             u_prop, u_acc, **kw)
            outs.append((o.accept, st.heights, st.rates, terms))
        for a, b in zip(*outs):
            assert torch.equal(a.nan_to_num(), b.nan_to_num())
        assert contra_range.launches_bold == before + 1


def test_glob_scan_bold_kernel(card):
    """G1 on the sub_contra family with the bold mixture's uniforms, against
    the plain family scan replayed at the kernel's proposals and decisions
    with the bold tuning (``ops.dists.bold_tune``), as test_glob_kernels
    holds it."""
    from mcmcdate_tpu_torch.kernels import glob_step as G
    from mcmcdate_tpu_torch.ops.dists import bold_tune

    fs, carry, tuning, g = _glob_fast(12)
    fam = fs.glob_fam["sub_contra"]
    C = carry.d.shape[0]
    tun = tuning.index_select(1, fam.rows)
    draws = torch.rand(C, fam.n, generator=g, device="cuda")
    u = torch.rand(C, fam.n, generator=g, device="cuda")
    ub = torch.rand(C, fam.n, generator=g, device="cuda")
    ck, cr = _glob_copy(carry), _glob_copy(carry)
    out = G.glob_scan(fs.glob, fam, ck, tun, draws, u, u_bold=ub, bold_p=0.25, bold_factor=8.0)
    _glob_replay_agree(fs, "sub_contra", ck, cr, bold_tune(tun, ub, 0.25, 8.0), draws, u,
                       out.accept, out.prop, None)
    assert 0 < int(out.accept.sum()) < out.accept.numel()


def _fiber_models():
    """The calibrated 12-taxon model (a constraint and a brace) and the
    multifurcating one, each with a chain batch."""
    fs, carry, _, _ = _glob_fast(5, taxa=12, chains=96)
    model, batch = _multifurcating()
    return [(fs.model, carry.batch), (model, batch)]


@pytest.mark.parametrize("which", (0, 1), ids=("calibrated", "multifurcating"))
def test_fiber_slide_kernel(card, which):
    """F1 on every colour class in turn against its plain version, at
    beta_prior 1 and with the MC3 ladder as each chain's beta_prior (as
    under ``run --mc3``): the kernel's decisions replayed through the plain
    version (each taken as the kernel took it) give its decisions except
    at ties, bitwise its proposals, heights and rates and its terms within
    1e-5 (1 + |t|); the accept count it sums; every branch distance kept;
    one launch a class."""
    from mcmcdate_tpu_torch.engine.fast_sweep import fiber_slide_plan
    from mcmcdate_tpu_torch.kernels.fiber_slide import FiberClass, fiber_slide, \
        fiber_slide_plain

    model, batch = _fiber_models()[which]
    C = batch.n_chains
    T = sum(model.term_block_sizes)
    g = torch.Generator(device="cuda").manual_seed(7)
    par, nr = model.topo.parent_t, model.topo.non_root_t
    d0 = torch.where(nr, (batch.heights[:, par] - batch.heights) * batch.rates, 0.0)
    mag = torch.where(nr, (batch.heights[:, par].abs() + batch.heights.abs())
                      * batch.rates.abs(), 0.0)
    for bp in (None, _mc3_ladder(C)):
        sk = State(**{f: getattr(batch, f).clone() for f in FIELDS})
        sr = State(**{f: getattr(batch, f).clone() for f in FIELDS})
        tk, tr = model.log_prior_terms(sk), model.log_prior_terms(sr)
        count = torch.zeros(1, dtype=torch.int32, device="cuda")
        n_acc = n = 0
        for c in fiber_slide_plan(model):
            cls = FiberClass.of(c, T, "cuda")
            u = torch.empty((C, cls.m), device="cuda").uniform_(1e-6, 1.0, generator=g)
            u_acc = torch.rand(C, cls.m, generator=g, device="cuda")
            before = fiber_slide.launches
            ok = fiber_slide(model, sk, tk, cls, u, u_acc, bp, count)
            assert fiber_slide.launches == before + 1
            orr = fiber_slide_plain(model, sr, tr, cls, u,
                                    torch.where(ok.accept, 0.0, math.nan), bp)
            assert torch.equal(orr.accept, ok.accept)
            assert torch.equal(ok.h_new, orr.h_new)
            differ = (torch.log(u_acc) < orr.log_alpha) != ok.accept
            assert torch.all((torch.log(u_acc) - orr.log_alpha).abs()[differ] < TIE)
            assert torch.equal(sk.heights, sr.heights) and torch.equal(sk.rates, sr.rates)
            fin = torch.isfinite(tr)
            assert torch.equal(fin, torch.isfinite(tk))
            assert torch.all((tk - tr).abs()[fin] <= 1e-5 * (1 + tr.abs()[fin]))
            n_acc += int(ok.accept.sum())
            n += ok.accept.numel()
        assert 0 < n_acc < n and int(count) == n_acc
        d1 = torch.where(nr, (sk.heights[:, par] - sk.heights) * sk.rates, 0.0)
        assert torch.all((d1 - d0).abs() <= 1e-5 * mag)


@pytest.mark.parametrize("which", (0, 1), ids=("calibrated", "multifurcating"))
def test_fiber_de_kernel(card, which):
    """F2's two half-updates of a round against the plain version at the
    kernel's step, each decision taken as the kernel took it: proposals and
    states bitwise, decisions except at ties (|log u - dlp| < 1e-5 (1 +
    |log prior|)), the step within 1e-5 of the plain one from the same
    draws."""
    from mcmcdate_tpu_torch.engine.ensemble import FiberDE
    from mcmcdate_tpu_torch.kernels.fiber_de import fiber_de, fiber_de_plain

    model, batch = _fiber_models()[which]
    C = batch.n_chains
    # Inner heights moved a random fraction toward their parents, chain by
    # chain (every span stays positive), so donor differences vary by node.
    h = batch.heights.double().cpu().numpy()
    parent = model.topo.parent_t.cpu().numpy()
    leaf = model.topo.is_leaf_t.cpu().numpy()
    rng = np.random.default_rng(3)
    for c in range(C):
        for i in range(1, h.shape[1]):
            if not leaf[i]:
                h[c, i] += rng.uniform(0, 0.3) * (h[c, parent[i]] - h[c, i])
    batch = batch.replace(heights=torch.as_tensor(h, dtype=torch.float32, device="cuda"))
    de = FiberDE(model)
    g = torch.Generator(device="cuda").manual_seed(1)
    sk = State(**{f: getattr(batch, f).clone() for f in FIELDS})
    sr = State(**{f: getattr(batch, f).clone() for f in FIELDS})
    half = C // 2
    n_acc = 0
    for act0, m, oth0 in ((0, half, half), (half, C - half, 0)):
        draws = de.draws(g, m, C - m, torch.float32, "cuda")
        args = (act0, m, oth0, *draws, de.gamma_small)
        lp = model.log_prior(State(**{f: getattr(sr, f)[act0:act0 + m] for f in FIELDS}))
        ok = fiber_de(model, sk, *args)
        op = fiber_de_plain(model, State(**{f: getattr(sr, f).clone() for f in FIELDS}), *args)
        assert torch.all((ok.g - op.g).abs() <= 1e-5 * op.g.abs())
        forced = torch.where(ok.accept, 0.0, math.nan)
        orr = fiber_de_plain(model, sr, *args[:7], forced, de.gamma_small, g=ok.g)
        assert torch.equal(orr.accept, ok.accept)
        assert torch.equal(ok.h_prop, orr.h_prop) and torch.equal(ok.r_prop, orr.r_prop)
        valid = ((orr.h_prop[:, model.topo.parent_t.clamp(min=0)] - orr.h_prop)[:, 1:]
                 > 1e-7).all(1)
        logu = torch.log(draws[4])
        differ = (valid & (logu < orr.dlp)) != ok.accept
        assert torch.all((logu - orr.dlp).abs()[differ] < 1e-5 * (1 + lp.abs()[differ]))
        assert torch.equal(sk.heights, sr.heights) and torch.equal(sk.rates, sr.rates)
        n_acc += int(ok.accept.sum())
    assert n_acc > 0
