"""The PyTorch port's sequential MHG sweep against golden prior marginals,
on the CPU: ``MHKernel.sweeps`` on the 4-leaf prior-only tree reproduces
the marginals of ``tests/test_engine.py`` (every proposal kind's Hastings
factor and Jacobian enters them)."""

import numpy as np
import torch

from mcmcdate_tpu.tree import FlatTopology, parse_newick
from mcmcdate_tpu_torch.engine import mh as tmh, proposals as TP
from mcmcdate_tpu_torch.models import DatingModel, init_state
from mcmcdate_tpu_torch.ops import mvn

FOUR = "((a:0.5,b:0.5):0.5,(c:0.5,d:0.5):0.5):0.0;"
GOLD = dict(hx=0.41182, hy=0.41205, birth=0.92615, death=0.41654, rate_mean=1.0, rate_var=0.25)
Z_MAX = 6.0  # as in tests/test_engine.py


def test_prior_marginals_match_golden():
    t = parse_newick(FOUR)
    topo = FlatTopology.from_tree(t)
    model = DatingModel(topo=topo, likelihood=mvn.LikelihoodData.none(), device="cpu")
    tb = TP.build_proposal_table(model.topo, model.braces, calibrations_available=False)
    # Root Jacobians off, as in tests/test_engine.py: they tilt the measure.
    table = TP.ProposalTable(tb.kind, tb.node, tb.aux, tb.par, tb.weight, tb.dim,
                             np.zeros_like(tb.root_jac), tb.names, tb.tickets)
    kern = tmh.MHKernel(model, table)
    C = 64
    batch = init_state(t, topo, C, device="cpu")
    r = np.random.default_rng(0).gamma(5.0, 0.2, size=(C, topo.n))
    r[:, 0] = 1.0
    batch = batch.replace(rates=torch.as_tensor(r))
    tuning = torch.ones((C, table.n_proposals), dtype=torch.float64)
    targets = torch.as_tensor(table.target_rates())
    tmax = torch.as_tensor(table.tune_max())

    def collect(s, lp_pr, lp_lik):
        return dict(birth=s.birth.clone(), death=s.death.clone(), rate_mean=s.rate_mean.clone(),
                    rate_var=s.rate_var.clone(), hx=s.heights[:, 1].clone(),
                    hy=s.heights[:, 4].clone())

    for w in range(4):
        batch, _, _, acc, tot, _ = kern.sweeps(batch, tuning, w, 10)
        tuning = tmh.tune_step(tuning, acc.double(), tot.double(), targets, tune_max=tmax)
    batch, _, _, acc, tot, outs = kern.sweeps(batch, tuning, 99, 40, collect=collect)
    assert int(tot.sum()) == C * 40 * table.n_tickets
    for name, gold in GOLD.items():
        draws = torch.stack([o[name] for o in outs]).numpy()  # [T, C]
        se = max(draws.mean(axis=0).std() / np.sqrt(C), 1e-9)
        z = (draws.mean() - gold) / se
        assert abs(z) < Z_MAX, f"{name}: mean {draws.mean():.4f} vs {gold} (z={z:+.1f})"


