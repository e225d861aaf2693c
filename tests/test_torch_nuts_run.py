"""The NUTS move's drivers in the port on the CPU (plain versions of H1–H3):
``run --hamiltonian`` adapts a finite step size and saves it with the
inverse mass and the ``hamiltonian`` meta, ``continue`` resumes with NUTS,
``run_marginal_likelihood(hamiltonian=True)`` gives a finite log Z, the
MHKernel and FastSweeps hooks keep their carried densities exact, and a
``sweeps`` call without NUTS gives the bits the loop without the hook
gives.  Schedules are cut by monkeypatching the module constants (chunks of
2 sweeps, 2-sweep windows, trajectories of at most 3 doublings)."""

import json
import math
import os

import numpy as np
import pytest
import torch

from mcmcdate_tpu_torch import cli, synthetic
from mcmcdate_tpu_torch.engine import chains as TC, checkpoint as tckpt, fast_sweep as TF, \
    hmc, mh as TM, proposals as TP, stepping_stone as SS
from mcmcdate_tpu_torch.engine.chains import RunSettings
from mcmcdate_tpu_torch.kernels import nuts_step as NS
from mcmcdate_tpu_torch.models import init_state
from mcmcdate_tpu_torch.models.state import FIELDS, State


@pytest.fixture
def short(monkeypatch):
    monkeypatch.setattr(TC, "CHUNK", 2)
    monkeypatch.setattr(SS, "CHUNK", 2)
    monkeypatch.setattr(TM, "BURN_IN_PROF_FAST", [2])
    monkeypatch.setattr(TM, "BURN_IN_PROF_SLOW", [2, 2])
    monkeypatch.setattr(SS, "REPETITIVE_BURN_IN_PROF", TM.BurnInSettings([2], [2]))
    monkeypatch.setattr(SS, "CASCADE_SWEEPS", 1)
    monkeypatch.setattr(hmc, "MAX_DEPTH", 3)


@pytest.fixture
def prepared(tmp_path, short):
    d = str(tmp_path)
    cli.main(["simulate", "--leaves", "8", "--trees", "80", "--seed", "4", "--out",
              os.path.join(d, "data")])
    cli.main(["prepare", "-a", "h", "--rooted-tree", os.path.join(d, "data", "time.tree"),
              "--trees", os.path.join(d, "data", "trees.nwk"), "--likelihood-spec", "full",
              "--out-dir", d])
    return d


def _log(d, mode):
    with open(os.path.join(d, f"h.{mode}.log")) as fh:
        return fh.read()


def test_run_and_continue_with_nuts(prepared):
    d = prepared
    runner = cli.main(["run", "-a", "h", "--device", "cpu", "--chains", "4", "--iterations",
                       "4", "--seed", "2", "--profile", "--hamiltonian", "--out-dir", d])
    assert runner.nuts is not None
    text = _log(d, "run")
    line = [s for s in text.splitlines() if s.startswith("NUTS adaptation: eps")]
    assert len(line) == 1
    eps = float(line[0].split()[3].rstrip(","))
    assert math.isfinite(eps) and eps > 0 and eps == pytest.approx(runner.nuts.eps, abs=1e-5)
    assert "NUTS in-cycle move: mean acceptance statistic" in text
    with open(os.path.join(d, "h.mcmc.json")) as fh:
        assert json.load(fh)["hamiltonian"] is True
    saved = tckpt.load_arrays("h", ("nuts_eps", "nuts_inv_mass", "missing"), in_dir=d)
    assert set(saved) == {"nuts_eps", "nuts_inv_mass"}
    assert float(saved["nuts_eps"]) == runner.nuts.eps
    assert saved["nuts_inv_mass"].shape == (runner.nuts.coords.dim,)
    assert np.isfinite(saved["nuts_inv_mass"]).all() and (saved["nuts_inv_mass"] > 0).all()
    # continue (no --hamiltonian flag): the checkpoint's meta turns NUTS on,
    # with the saved step size and inverse mass.
    runner2 = cli.main(["continue", "-a", "h", "--device", "cpu", "--profile", "--seed", "5",
                        "--iterations", "2", "--out-dir", d])
    assert runner2.nuts is not None and runner2.nuts.eps == runner.nuts.eps
    np.testing.assert_array_equal(runner2.nuts.inv_mass, saved["nuts_inv_mass"])
    assert "NUTS in-cycle move: mean acceptance statistic" in _log(d, "continue")
    with open(os.path.join(d, "h.mcmc.json")) as fh:
        meta = json.load(fh)
    assert meta["hamiltonian"] is True and meta["iteration"] == 6


def test_marginal_likelihood_with_nuts(short):
    model, batch = synthetic.build(8, 1, dtype=torch.float64, device="cpu")
    logs = []
    res = SS.run_marginal_likelihood(
        model, batch, RunSettings("m", iterations=2, device="cpu", dtype="float64", seed=3),
        profile=True, hamiltonian=True, log=logs.append)
    assert math.isfinite(res.log_marginal_likelihood)
    line = [s for s in logs if s.startswith("NUTS adaptation: eps")]
    assert len(line) == 1 and math.isfinite(float(line[0].split()[3].rstrip(",")))


@pytest.mark.parametrize("kern", ("mh", "fast"))
def test_sweeps_hook_keeps_the_carry(short, kern):
    """``sweeps(nuts=)`` of both kernels at a tempered ladder: a seventh
    element ``[n, C]`` of acceptance statistics in [0, 1], chains moved by
    the move, and the returned log prior and likelihood those of the final
    state."""
    model, batch = synthetic.build(8, 6, dtype=torch.float64, device="cpu")
    table = TP.build_proposal_table(model.topo, model.braces, False)
    k = TM.MHKernel(model, table) if kern == "mh" else TF.FastSweeps(model, table)
    nuts = hmc.NutsInCycle(model, dtype=torch.float64)
    nuts.eps = 0.005
    tuning = torch.ones((6, table.n_proposals), dtype=torch.float64)
    beta = torch.linspace(0.2, 1.0, 6, dtype=torch.float64)
    out = k.sweeps(batch, tuning, 7, 3, beta=beta, nuts=nuts)
    assert len(out) == 7
    astat = out[6]
    assert astat.shape == (3, 6) and bool(((astat >= 0) & (astat <= 1)).all())
    assert float(astat.mean()) > 0
    st, lp_pr, lp_lik = out[0], out[1], out[2]
    torch.testing.assert_close(lp_pr, model.log_prior(st), rtol=1e-10, atol=1e-9)
    torch.testing.assert_close(lp_lik, model.log_likelihood(st), rtol=1e-10, atol=1e-9)


def test_fast_sweeps_without_nuts_unchanged():
    """``FastSweeps.sweeps`` without NUTS: the bits of the loop without the
    hook (its form before the move existed)."""
    model, batch = synthetic.build(8, 4, dtype=torch.float64, device="cpu")
    table = TP.build_proposal_table(model.topo, model.braces, False)
    fs = TF.FastSweeps(model, table)
    tuning = torch.ones((4, table.n_proposals), dtype=torch.float64)
    out = fs.sweeps(batch, tuning, 11, 2)
    assert len(out) == 6
    host_gen = torch.Generator().manual_seed(11)
    gen = torch.Generator().manual_seed(11)
    carry = fs.init_carry(batch)
    carry.beta = TM.chain_beta(None, 4, torch.float64, batch.heights.device)
    y = model.whitened_residual_internal(carry.batch)
    for _ in range(2):
        y = fs.sweep_once(carry, y, tuning, host_gen, gen)
    for a, b in zip(out[:4], (carry.batch, *fs.lp_of(carry, y), carry.acc)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            for f in ("heights", "rates", "birth", "death", "height", "rate_mean", "rate_var"):
                assert torch.equal(getattr(a, f), getattr(b, f))


def test_nuts_proposal_is_the_in_cycle_move(short):
    """``NUTSProposal.step``: the in-cycle move at its likelihood
    temperature, bitwise, returning the mean acceptance statistic; it
    adapts as the in-cycle move does."""
    model, batch = synthetic.build(8, 4, dtype=torch.float64, device="cpu")
    prop = hmc.NUTSProposal(model, beta=0.5).build(batch)
    ref = hmc.NutsInCycle(model, dtype=torch.float64)
    b1 = State(**{f: getattr(batch, f).clone() for f in FIELDS})
    b2 = State(**{f: getattr(batch, f).clone() for f in FIELDS})
    mean = prop.step(b1, torch.Generator().manual_seed(3))
    astat = ref(b2, torch.Generator().manual_seed(3), beta_lik=0.5)
    assert mean == float(astat.mean())
    for f in FIELDS:
        assert torch.equal(getattr(b1, f), getattr(b2, f))
    assert not torch.equal(b1.heights, batch.heights)
    prop.adapt(0.3)
    ref.adapt(0.3)
    assert prop.eps == ref.eps != 0.01


@pytest.mark.parametrize("chain", (0, 1))
def test_nuts_check_u_turn_ties(chain):
    """``NutsCheck`` passes a merge whose full-span U-turn decision differs
    from the plain version's only where its dot product is a tie (chain 0:
    1e-9 against terms of 1), and fails it elsewhere (chain 1)."""
    C, dim = 2, 3
    inv_mass = torch.ones(dim, dtype=torch.float64)
    u = torch.full((C,), 0.5, dtype=torch.float64)
    p = torch.tensor([[1.0, -1.0 + 1e-9, 0.0], [1.0, -0.5, 0.0]], dtype=torch.float64)

    def check(**kw):
        w = NS.NutsWork(C, dim, 4, 2, 0, 2, torch.float64, torch.device("cpu"))
        w.ends_q[1].copy_(torch.tensor([[1.0, 1.0, 0.0]] * 2))
        w.ends_p[0].copy_(p)
        w.ends_p[1].copy_(p)

        def plain():
            NS.nuts_merge_plain(w, inv_mass, u)

        def flipped():
            plain()
            w.stop[chain] = ~w.stop[chain]

        chk = NS.NutsCheck(w)
        chk.run("merge", flipped, plain, **kw)
        return chk

    with pytest.raises(AssertionError, match="the decision stop differs"):
        check()
    if chain == 0:
        chk = check(inv_mass=inv_mass)
        assert chk.turn_ties == 1 and chk.compared == 1 and chk.depth == 1
    else:
        with pytest.raises(AssertionError, match="away from a tie"):
            check(inv_mass=inv_mass)


def test_nuts_check_leaf_u_turn_ties():
    """The same rule for leaf 1's sub-subtree check: its dot products from
    checkpoint 0 to the leaf, the leaf's momentum the moving end's (chain
    0 forward, a tie; chain 1 backward, not one)."""
    C, dim = 2, 3
    inv_mass = torch.ones(dim, dtype=torch.float64)
    dirs = torch.tensor([True, False])
    q = torch.tensor([[1.0, 1.0, 0.0], [-1.0, -1.0, 0.0]], dtype=torch.float64)
    p_ck = torch.tensor([[1.0, 2.0, 0.0], [1.0, 1.0, 0.0]], dtype=torch.float64)
    ends_p = torch.zeros(2, C, dim, dtype=torch.float64)
    ends_p[1, 0] = torch.tensor([1.0, -1.0 + 1e-9, 0.0])
    ends_p[0, 1] = torch.tensor([1.0, -0.5, 0.0])
    before = {"q_new": q, "q_ck": torch.zeros(2, C, dim, dtype=torch.float64),
              "p_ck": p_ck[None].expand(2, C, dim)}
    chk = NS.NutsCheck(None)
    for chain, ok in ((0, True), (1, False)):
        trn = torch.zeros(C, dtype=torch.bool)
        flip = trn.clone()
        flip[chain] = True
        k, p = {"trn": flip}, {"trn": trn, "ends_p": ends_p}
        if ok:
            chk._turn_ties("epilogue", before, k, p, 1, dirs, inv_mass)
        else:
            with pytest.raises(AssertionError, match="away from a tie"):
                chk._turn_ties("epilogue", before, k, p, 1, dirs, inv_mass)
    assert chk.turn_ties == 1


def test_flat_coords_of_a_run_state():
    """The coordinates of ``init_state``'s batch: the 8-leaf synthetic
    model's 6 inner non-root heights and 14 rates after the 4 scalars."""
    model, batch = synthetic.build(8, 3, dtype=torch.float64, device="cpu")
    coords = hmc.FlatCoords(model, False)
    assert coords.dim == 4 + 6 + 14
    v = coords.to_vector(batch)
    assert v.shape == (3, coords.dim)
    b2 = init_state(*_tree_topo(), 3, device="cpu")
    coords.write_vector(b2, v)
    for f in ("heights", "rates", "birth", "death", "rate_mean", "rate_var"):
        assert torch.equal(getattr(b2, f), getattr(batch, f))


def _tree_topo():
    from mcmcdate_tpu_torch.tree.flat import FlatTopology
    from mcmcdate_tpu_torch.utils.simulate import random_ultrametric_tree

    tree = random_ultrametric_tree(np.random.default_rng(0), 8)
    return tree, FlatTopology.from_tree(tree)
