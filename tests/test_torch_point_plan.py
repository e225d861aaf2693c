"""The plan records of K4's prologue kernel (``point_step.point_plan``,
``sx["kplan"]``, bound by ``FastSweeps``) on the CPU, without JAX: every
field of every ticket's record against the step's own arrays, each
distance slot's owner against ``d_rows``, ``pos`` and ``ch``, and the
deltas the kernel forms from the owners against the plain prologue's, on
a binary and a multifurcating tree (16 and 12 leaves, 16 chains)."""

import numpy as np
import pytest
import torch

from mcmcdate_tpu_torch import synthetic
from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP
from mcmcdate_tpu_torch.kernels import point_step as K4

C = 16
MULTIFURCATING = ("(((a:1,b:1,c:1):1,((d:0.5,e:0.5,f:0.5,g:0.5):1,(h:1,i:1):0.5):0.5):0.5,"
                  "(j:1.5,(k:0.5,l:0.5):1):1);")
KINDS = {"slide": TP.K_SLIDE_NODE_ULTRA, "branch": TP.K_SCALE_BRANCH_RATE}


def _binary():
    return synthetic.build(16, C, device="cpu")


def _multifurcating():
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
    model = DatingModel(topo=topo, likelihood=data, device="cpu", dtype=torch.float32)
    batch = init_state(tree, topo, C, dtype=torch.float32, device="cpu")
    h = batch.heights * torch.as_tensor(rng.uniform(0.9, 1.0, size=(C, 1)), dtype=torch.float32)
    h[:, 0] = 1.0
    h[:, model.topo.is_leaf_t] = 0.0
    return model, batch.replace(heights=h, rates=torch.as_tensor(
        rng.gamma(5.0, 0.2, size=(C, topo.n)), dtype=torch.float32))


TREES = {"binary": _binary, "multifurcating": _multifurcating}


def _steps(tree, kind):
    model, batch = TREES[tree]()
    table = TP.build_proposal_table(model.topo, model.braces, False)
    fs = TF.FastSweeps(model, table)
    steps = fs.spec_t[KINDS[kind]]
    assert steps
    return model, batch, fs, table, steps


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("tree", list(TREES))
def test_plan_records_hold_the_step(tree, kind):
    """Every field of every ticket's record equals the step's arrays; the
    flags hold the valid bit and each child's leaf bit; the record is
    ``plan_width`` words, zero past its fields."""
    model, _, fs, _, steps = _steps(tree, kind)
    leaf = model.topo.is_leaf_t
    for sx in steps:
        plan = sx["kplan"]
        B, KC = sx["ch"].shape
        KT, KD = sx["t_rows"].shape[-1], sx["d_rows"].shape[-1]
        W = K4.plan_width(KC, KT, KD)
        assert plan.dtype == torch.int32 and tuple(plan.shape) == (B, W) and W % 4 == 0
        assert torch.equal(plan, K4.point_plan(sx, fs.pos_t, leaf))
        for col, name in ((K4.PLAN_NODE, "node"), (K4.PLAN_PAR, "par"), (K4.PLAN_ROW, "rows")):
            assert torch.equal(plan[:, col], sx[name])
        assert torch.equal(plan[:, K4.PLAN_SD].view(torch.float32), sx["sd"].to(torch.float32))
        flags = plan[:, K4.PLAN_FLAGS]
        assert torch.equal((flags & 1).bool(), sx["valid"])
        ch = sx["ch"]
        for j in range(KC):
            want = (ch[:, j] >= 0) & leaf[ch[:, j].clamp(min=0).long()]
            assert torch.equal(((flags >> (1 + j)) & 1).bool(), want)
        assert not bool((flags >> (1 + KC)).any())
        o = K4.PLAN_HEAD
        for name, n in (("ch", KC), ("t_rows", KT), ("d_rows", KD)):
            assert torch.equal(plan[:, o:o + n], sx[name])
            o += n
        assert not bool(plan[:, o + KD:].any())


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("tree", list(TREES))
def test_slot_owners_match_rows(tree, kind):
    """Each distance slot's owner: -1 exactly on the pad slots; 0 where the
    row is the node's own branch (``pos[node]``), 1 + j where it is child
    j's; every valid ticket's own branch row and, for a slide, each real
    child's have exactly one slot."""
    model, _, fs, _, steps = _steps(tree, kind)
    pos = fs.pos_t.long()
    n_multi = 0
    for sx in steps:
        own = K4.slot_owners(sx, fs.pos_t)
        KC, KT, KD = sx["ch"].shape[1], sx["t_rows"].shape[1], sx["d_rows"].shape[1]
        o = K4.PLAN_HEAD + KC + KT + KD
        assert torch.equal(own, sx["kplan"][:, o:o + KD])
        dr, ch = sx["d_rows"].long(), sx["ch"].long()
        assert torch.equal(own < 0, dr < 0)
        for b in range(dr.shape[0]):
            if not bool(sx["valid"][b]):
                continue
            kids = [int(c) for c in ch[b] if c >= 0]
            n_multi += 0 < len(kids) < ch.shape[1]
            want = {int(pos[sx["node"][b]]): 0}
            if kind == "slide":
                want.update({int(pos[c]): 1 + j for j, c in enumerate(ch[b].tolist()) if c >= 0})
            got = {int(dr[b, s]): int(own[b, s]) for s in range(dr.shape[1]) if dr[b, s] >= 0}
            assert got == want
            for s in range(dr.shape[1]):
                o = int(own[b, s])
                if o > 0:
                    assert int(ch[b, o - 1]) >= 0 and int(dr[b, s]) == int(pos[ch[b, o - 1]])
    if tree == "multifurcating":
        assert n_multi > 0  # some ticket has fewer children than the step's KC


@pytest.mark.parametrize("tree", list(TREES))
def test_owner_deltas_match_the_plain_prologue(tree):
    """The slide kernel's deltas, formed from the owners as it forms them
    (the node's own branch t = hp - hnew at its rate, child j's t = hnew -
    h_c at its rate, d = (height rate_mean) t r), equal the plain
    prologue's, which matches ``d_rows`` against ``pos``, bitwise."""
    model, batch, fs, table, steps = _steps(tree, "slide")
    rng = np.random.default_rng(7)
    tuning = torch.as_tensor(rng.uniform(0.3, 3.0, size=(C, table.n_proposals)),
                             dtype=torch.float32)
    carry = fs.init_carry(batch)
    h, r = carry.batch.heights, carry.batch.rates
    sc = (carry.batch.height * carry.batch.rate_mean)[:, None]
    for sx in steps:
        B = sx["rows"].shape[0]
        draw = torch.as_tensor(rng.uniform(size=(C, B)), dtype=torch.float32)
        pro = K4.point_lik_prologue_plain(False, carry.batch, carry.terms, carry.d, None, tuning,
                                          sx, model.topo.is_leaf_t, fs.pos_t, model.clock, draw)
        node, par, ch = sx["node"].long(), sx["par"].long(), sx["ch"].long()
        own = K4.slot_owners(sx, fs.pos_t).long()
        hnew, hp = pro.prop, h[:, par]
        for s in range(own.shape[1]):
            o = own[:, s]
            t_val = torch.where(o == 0, hp - hnew, 0.0)
            r_val = torch.where(o == 0, r[:, node], 0.0)
            for j in range(ch.shape[1]):
                cj = ch[:, j].clamp(min=0)
                t_val = torch.where(o == 1 + j, hnew - h[:, cj], t_val)
                r_val = torch.where(o == 1 + j, r[:, cj], r_val)
            d_old = carry.d[:, sx["d_rows"][:, s].clamp(min=0).long()]
            dl = torch.where(sx["d_rows"][:, s] >= 0, sc * t_val * r_val - d_old, 0.0)
            assert torch.equal(dl, pro.delta[:, :, s])
