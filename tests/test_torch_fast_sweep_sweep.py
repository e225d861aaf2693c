"""The PyTorch port's FastSweeps as a whole, on the CPU at float64: its
posterior moments agree with the port's sequential sweep (MHKernel) within
Monte Carlo error; its carried log posterior equals a direct evaluation
after several sweeps; and ``run --device cpu`` goes through it."""

import os

import numpy as np
import pytest
import torch

from mcmcdate_tpu_torch import cli
from mcmcdate_tpu_torch.engine import chains as TC, fast_sweep as TF, mh as TM, proposals as TP
from mcmcdate_tpu_torch.models import DatingModel, init_state
from mcmcdate_tpu_torch.ops import mvn
from mcmcdate_tpu_torch.tree import FlatTopology
from mcmcdate_tpu_torch.utils.simulate import random_ultrametric_tree

Z_AGREE = 5.0
SCALARS = ("birth", "death", "rate_mean", "rate_var")


def build(lik, n_leaves=8, seed=0, C=64):
    rng = np.random.default_rng(seed)
    tree = random_ultrametric_tree(rng, n_leaves)
    topo = FlatTopology.from_tree(tree)
    k = topo.n - 2
    mu = rng.uniform(0.05, 0.5, size=k)
    if lik == "full":
        a = rng.normal(size=(k, k)) / np.sqrt(k)
        sigma = a @ a.T + np.eye(k) * 0.05
        data = mvn.LikelihoodData.full(mu, np.linalg.inv(sigma), np.linalg.slogdet(sigma)[1])
    elif lik == "uni":
        data = mvn.LikelihoodData.univariate(mu, rng.uniform(0.01, 0.1, size=k) ** 2)
    else:
        data = mvn.LikelihoodData.none()
    model = DatingModel(topo=topo, likelihood=data, device="cpu")
    table = TP.build_proposal_table(model.topo, model.braces, False)
    batch = init_state(tree, topo, C, device="cpu")
    r = rng.gamma(5.0, 0.2, size=(C, topo.n))
    r[:, 0] = 1.0
    batch = batch.replace(rates=torch.as_tensor(r))
    return model, table, batch, torch.ones((C, table.n_proposals), dtype=torch.float64)


def _draws(kern, batch, tuning, seed, n):
    """Per-chain means over ``n`` sweeps of the scalars and inner heights."""
    inner = torch.as_tensor(kern.model.topo.inner_nodes[1:], dtype=torch.long)

    def collect(s, lp_pr, lp_lik):
        return torch.cat([torch.stack([getattr(s, f) for f in SCALARS], 1),
                          s.heights[:, inner]], 1)

    out = kern.sweeps(batch, tuning, seed, n, collect=collect)
    return torch.stack(out[5]).mean(0).numpy()   # [C, K]


@pytest.mark.parametrize("lik", ["full", "none"])
def test_fast_matches_sequential_moments(lik):
    model, table, batch, tuning = build(lik)
    seq = TM.MHKernel(model, table)
    fast = TF.FastSweeps(model, table)
    assert fast.plan.specs and fast.plan.range_specs and fast.plan.glob_groups
    start = seq.sweeps(batch, tuning, 1, 3)[0]  # common burned-in start
    a = _draws(fast, start, tuning, 2, 4)
    b = _draws(seq, start, tuning, 3, 4)
    C = a.shape[0]
    se = np.hypot(a.std(0), b.std(0)) / np.sqrt(C)
    z = np.abs(a.mean(0) - b.mean(0)) / np.maximum(se, 1e-12)
    assert np.all(z < Z_AGREE), z


@pytest.mark.parametrize("lik", ["full", "uni", "none"])
def test_carried_log_posterior_is_exact(lik):
    model, table, batch, tuning = build(lik, C=32)
    fast = TF.FastSweeps(model, table)
    out, lp_pr, lp_lik, acc, tot, _ = fast.sweeps(batch, tuning, 5, 4)
    direct = model.log_posterior(out)
    assert torch.allclose(lp_pr + lp_lik, direct, rtol=0, atol=1e-8), (lp_pr + lp_lik - direct)
    rate = float(acc.sum()) / float(tot.sum())
    assert 0.02 < rate < 0.995, rate
    # The carried terms equal a fresh evaluation of the final state.
    assert torch.allclose(lp_pr, model.log_prior(out), rtol=0, atol=1e-8)


def test_cli_run_uses_fast_sweeps(tmp_path, monkeypatch):
    monkeypatch.setattr(TC, "CHUNK", 2)  # sweeps per chunk: 2 of burn-in, 4 of sampling
    monkeypatch.setattr(TM, "BURN_IN_PROF_FAST", [2])
    monkeypatch.setattr(TM, "BURN_IN_PROF_SLOW", [])
    d = str(tmp_path)
    cli.main(["simulate", "--leaves", "6", "--trees", "60", "--out", os.path.join(d, "data")])
    cli.main(["prepare", "-a", "x", "--rooted-tree", os.path.join(d, "data", "time.tree"),
              "--trees", os.path.join(d, "data", "trees.nwk"), "--likelihood-spec", "full",
              "--out-dir", d])
    runner = cli.main(["run", "-a", "x", "--device", "cpu", "--chains", "4", "--iterations",
                       "4", "--seed", "2", "--out-dir", d, "--profile"])
    assert isinstance(runner.kern, TF.FastSweeps)
    assert 0 < runner.accepted < runner.attempted
    assert os.path.exists(os.path.join(d, "x.mcmc.npz"))
