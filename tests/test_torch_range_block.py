"""The row plan that K5's prologue and epilogue kernels read
(``kernels.range_step.range_plan``) and the blocks' shared outputs
(``RangeWork``), on the CPU.  The plan must say exactly what a block's
``own >= 0`` and ticket arrays say, for every block of both likelihood
range kinds in all three row buckets (16, 64 and 256 rows: the 14-taxon
FastSweeps blocks, and the planner's blocks at 136 taxa, which have the
256-row bucket); on CPU tensors the wrappers take the plain versions
whatever workspace they are given."""

import numpy as np
import pytest
import torch

from mcmcdate_tpu_torch import synthetic
from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP
from mcmcdate_tpu_torch.kernels import range_step as K5

KINDS = {"ultrametric": TP.K_SCALE_SUBTREE_ULTRA, "rate": TP.K_SCALE_SUBTREE_RATE}


def _check_plan(sx):
    """``rplan`` and ``tplan`` of ``sx`` against its ``own``, ``own_par``,
    ``d_flat``, ``node`` and ticket arrays."""
    own = sx["own"].numpy()
    S, RB = own.shape
    rplan, tplan = (t.numpy().astype(np.int64) for t in (sx["rplan"], sx["tplan"]))
    assert rplan.shape == (S * RB, 4) and tplan.shape == (S, len(K5.TICKET_FIELDS))
    slot, tick, root = rplan[:, 0] & 0xFFFF, rplan[:, 0] >> 16 & 0xFF, rplan[:, 0] >> 24
    # Every slot once: the real rows ticket by ticket in slot order, then
    # the pads in slot order.
    R = int((own >= 0).sum())
    assert np.array_equal(np.sort(slot), np.arange(S * RB))
    assert np.array_equal(slot[:R], np.flatnonzero(own.reshape(-1) >= 0))
    assert np.array_equal(slot[R:], np.flatnonzero(own.reshape(-1) < 0))
    assert np.array_equal(tick, slot // RB)
    flat = own.reshape(-1)[slot]
    assert np.array_equal(rplan[:, 1], flat)
    real = flat >= 0
    assert np.array_equal(real, np.arange(S * RB) < R)
    own_par = sx["own_par"].numpy().reshape(-1)[slot]
    assert np.array_equal(rplan[real, 2], own_par[real]) and np.all(rplan[~real, 2] == -1)
    assert np.array_equal(rplan[real, 3], sx["d_flat"].numpy()[slot][real])
    assert np.all(rplan[~real, 3] == 0)
    node = sx["node"].numpy()
    assert np.array_equal(root, (real & (flat == node[tick])).astype(np.int64))
    # Each ticket's rows are rplan[row_start : row_start + n_rows].
    n_rows = (own >= 0).sum(1)
    assert np.array_equal(tplan[:, 1], n_rows)
    assert np.array_equal(tplan[:, 0], np.concatenate([[0], np.cumsum(n_rows)[:-1]]))
    for s in range(S):
        assert np.all(tick[tplan[s, 0]:tplan[s, 0] + tplan[s, 1]] == s)
    for i, k in enumerate(K5.TICKET_FIELDS[2:], start=2):
        assert np.array_equal(tplan[:, i], sx[k].numpy().astype(np.int64)), k
    return R


@pytest.fixture(scope="module")
def fast14():
    model, _ = synthetic.build(14, 4, dtype=torch.float64, device="cpu", seed=3)
    table = TP.build_proposal_table(model.topo, model.braces, False)
    return TF.FastSweeps(model, table)


@pytest.mark.parametrize("kind", KINDS)
def test_plan_of_every_block(fast14, kind):
    """Every block of a kind of the 14-taxon FastSweeps, and its bucket's
    ``RangeWork``: sized for the bucket's largest block, each block's real
    rows counted."""
    buckets = set()
    for (k, rb), blocks in fast14.range_t.items():
        if k != KINDS[kind]:
            continue
        buckets.add(rb)
        work = blocks[0]["work"]
        assert all(sx["work"] is work for sx in blocks)
        assert work.rate == (kind == "rate") and work.lik
        assert work.S == max(sx["own"].shape[0] for sx in blocks)
        assert work.F == max(sx["own"].numel() for sx in blocks)
        for sx in blocks:
            assert work.rows[id(sx)] == _check_plan(sx)
    assert buckets == {16, 64}


@pytest.mark.parametrize("kind", KINDS)
def test_plan_of_the_256_row_bucket(kind):
    """The planner's blocks of a kind at 136 taxa, whose buckets include
    the 256-row one (the plan only: no likelihood matrices)."""
    model, _ = synthetic.build(136, 2, device="cpu")
    table = TP.build_proposal_table(model.topo, model.braces, False)
    plan = TF.plan_batches(model, table)
    pos = torch.as_tensor(np.asarray(model.topo.internal_pos, np.int32))
    buckets = set()
    for (k, rb), spec in plan.range_specs.items():
        if k != KINDS[kind]:
            continue
        buckets.add(rb)
        for sx in TF.step_tensors(spec, "cpu", torch.float32):
            ok = sx["own"] >= 0
            sx["d_flat"] = torch.where(ok, pos[torch.clamp(sx["own"], min=0)], 0).reshape(-1)
            sx["rplan"], sx["tplan"] = K5.range_plan(sx)
            assert _check_plan(sx) > 0
    assert buckets == {16, 64, 256}


def test_plan_of_an_invalid_ticket(fast14):
    """A ticket made invalid keeps its rows in the plan; its valid field
    is 0, which the kernels read."""
    sx = dict(next(b[0] for (k, _), b in fast14.range_t.items()
                   if k == TP.K_SCALE_SUBTREE_ULTRA and b[0]["rows"].shape[0] > 1))
    sx["valid"] = sx["valid"].clone()
    sx["valid"][1] = False
    sx["rplan"], sx["tplan"] = K5.range_plan(sx)
    _check_plan(sx)
    assert sx["tplan"][:, K5.TICKET_FIELDS.index("valid")].tolist()[:2] == [1, 0]


def test_cpu_wrappers_take_the_plain_versions(fast14):
    """On CPU tensors the prologue and epilogue with the block's workspace
    give the plain versions' results and launch no kernel."""
    fs = fast14
    model = fs.model
    _, batch = synthetic.build(14, 4, dtype=torch.float64, device="cpu", seed=3)
    carry = fs.init_carry(batch)
    carry.z, carry.q = fs._zq_from_y(model.whitened_residual_internal(carry.batch))
    rng = np.random.default_rng(0)
    tuning = torch.as_tensor(rng.uniform(0.3, 3.0, size=(4, fs.table.n_proposals)))
    sx = next(b[0] for (k, _), b in fs.range_t.items() if k == TP.K_SCALE_SUBTREE_ULTRA)
    draw = torch.as_tensor(rng.uniform(size=(4, sx["rows"].shape[0])))
    args = (False, carry.batch, carry.terms, carry.d, carry.z, tuning, sx, model.topo.is_leaf_t,
            model.clock, draw)
    before = (K5.range_lik_prologue.launches, K5.range_lik_epilogue.launches)
    pro = K5.range_lik_prologue(*args)
    plain = K5.range_lik_prologue_plain(*args)
    for a, b in zip(pro, plain):
        assert (a is None and b is None) or torch.equal(a.nan_to_num(), b.nan_to_num())
    accept = torch.zeros(draw.shape, dtype=torch.bool)
    dq = torch.zeros(draw.shape, dtype=torch.float64)
    acc, dacc = K5.range_lik_epilogue(False, carry.batch, carry.terms, carry.d, carry.q,
                                      carry.acc, sx, pro, accept, dq)
    assert torch.equal(acc, accept) and not bool(dacc.any())
    assert (K5.range_lik_prologue.launches, K5.range_lik_epilogue.launches) == before
