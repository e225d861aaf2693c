"""K1 ``prior_terms``'s host node lists (``kernels.prior_terms.prior_plan``),
on the CPU: they cover every non-root node once, each in the pass of its
kind; and the term vector assembled pass by pass as the kernel writes it
(fixed entries, inner nodes' and leaves' birth-death terms, clock terms,
node terms), from the per-node plain functions, equals ``prior_terms_plain``
and the JAX ``DatingModel.log_prior_terms`` at float64, on a calibrated,
constrained and braced 16-leaf model under every relaxed clock."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcdate_tpu.models import DatingModel as JModel, init_state as j_init
from mcmcdate_tpu.models.state import State as JState
from mcmcdate_tpu.ops import mvn as jmvn, node_priors as jnp_
from mcmcdate_tpu.tree import FlatTopology
from mcmcdate_tpu.utils.simulate import random_ultrametric_tree
from mcmcdate_tpu_torch.kernels.prior_terms import kernel_arrays, prior_plan, prior_terms_plain
from mcmcdate_tpu_torch.models import from_numpy
from mcmcdate_tpu_torch.ops import clocks
from mcmcdate_tpu_torch.ops.dists import exponential_logpdf, gamma_logpdf
from mcmcdate_tpu_torch.ops.local_terms import bd_term_local, clock_term_local

LEAVES, C = 16, 12
RTOL, ATOL = 1e-12, 1e-12


def _models(clock):
    rng = np.random.default_rng(7)
    t = random_ultrametric_tree(rng, LEAVES)
    topo = FlatTopology.from_tree(t)
    k = topo.n - 2
    data = jmvn.LikelihoodData.univariate(rng.uniform(0.1, 0.5, k), rng.uniform(0.01, 0.1, k))
    inner = [int(i) for i in topo.inner_nodes if i]
    cal = jnp_.CalibrationSet(
        np.asarray([0, inner[1], inner[4]], np.int32), np.asarray([0.8, 0.3, 0.0]),
        np.asarray([0.01, 0.02, 1.0]), np.asarray([1.6, np.inf, 0.5]),
        np.asarray([0.01, 1.0, 0.03]), names=("root", "a", "b"))
    con = jnp_.ConstraintSet(np.asarray([inner[2]], np.int32), np.asarray([inner[3]], np.int32),
                             np.asarray([0.01]), names=("c",))
    br = jnp_.BraceSet(np.asarray([[inner[5], inner[6], -1]], np.int32), np.asarray([0.02]),
                       names=("br",))
    jm = JModel(topo=topo, likelihood=data, clock=clock, calibrations=cal, constraints=con,
                braces=br, mean_root_height=1.2)
    h = np.asarray(j_init(t, topo).heights)[None].repeat(C, 0) * rng.uniform(0.9, 1.0, (C, 1))
    h[:, 0] = 1.0
    h[:, topo.is_leaf] = 0.0
    state = dict(heights=h, rates=rng.gamma(5.0, 0.2, size=(C, topo.n)),
                 birth=rng.uniform(0.2, 3, C), death=rng.uniform(0, 3, C),
                 height=rng.uniform(0.5, 2, C), rate_mean=rng.uniform(0.5, 2, C),
                 rate_var=rng.uniform(0.01, 1.5, C))
    state["death"][0] = state["birth"][0] + 2e-7  # near-critical
    state["rate_var"][1] = 2e-3  # gamma shape above 100
    state["death"][2] = -0.5  # invalid rates: the validity entry is -inf
    pm, ps = from_numpy(topo, data, state, clock=clock, calibrations=cal, constraints=con,
                        braces=br, mean_root_height=1.2, device="cpu")
    js = JState(**{k: jnp.asarray(v) for k, v in state.items()})
    return topo, jm, js, pm, ps


def by_pass(pm, ps):
    """The kernel's passes, each from the per-node plain functions over its
    node list, written where the kernel writes them; NaN where no pass
    writes."""
    plan = prior_plan(pm.topo)
    N = pm.topo.n
    T = sum(pm.term_block_sizes)
    o_ck, o_nd = 4 + N + 1, 4 + 2 * (N + 1)
    out = torch.full((ps.heights.shape[0], T), math.nan, dtype=ps.heights.dtype)
    la, mu, rv = ps.birth, ps.death, ps.rate_var
    # fixed: the scalars, the root's entries and the validity entries
    out[:, 0] = exponential_logpdf(1.0, la)
    out[:, 1] = exponential_logpdf(1.0, mu)
    out[:, 2] = exponential_logpdf(pm.mean_root_height, ps.rate_mean)
    out[:, 3] = gamma_logpdf(1.5, 1.0 / 6.0, rv)
    out[:, 4] = 0.0
    out[:, 4 + N] = torch.where((la >= 0) & (mu >= 0), 0.0, -math.inf)
    out[:, o_ck] = 0.0
    out[:, o_ck + N] = torch.where(rv > 0, 0.0, -math.inf)
    parent = np.asarray(pm.topo.parent)
    for kind in ("inner", "leaves"):
        j = torch.as_tensor(plan[kind], dtype=torch.int64)
        p = torch.as_tensor(parent[plan[kind]], dtype=torch.int64)
        v = bd_term_local(ps.heights[:, j], ps.heights[:, p], kind == "leaves", la[:, None],
                          mu[:, None])
        out[:, 4 + j] = torch.where(v == math.inf, -math.inf, v)
    j = torch.arange(1, N)
    p = torch.as_tensor(parent[1:], dtype=torch.int64)
    out[:, o_ck + j] = clock_term_local(pm.clock, ps.rates[:, j],
                                        ps.heights[:, p] - ps.heights[:, j], rv[:, None])
    out[:, o_nd:] = pm.term_nodes(ps)
    return out


def close(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    np.testing.assert_array_equal(np.isfinite(port), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(port[~fin], ref[~fin])
    np.testing.assert_allclose(port[fin], ref[fin], rtol=RTOL, atol=ATOL)


def test_plan_covers_each_node_once_in_its_pass():
    topo, _, _, pm, _ = _models(clocks.UNCORRELATED_GAMMA)
    plan = prior_plan(topo)
    leaf = np.asarray(topo.is_leaf, bool)
    inner, leaves = plan["inner"], plan["leaves"]
    assert inner.dtype == leaves.dtype == np.int32
    assert np.all(np.diff(inner) > 0) and np.all(np.diff(leaves) > 0)
    assert not leaf[inner].any() and leaf[leaves].all()
    assert sorted(np.concatenate([inner, leaves]).tolist()) == list(range(1, topo.n))
    assert len(leaves) == LEAVES
    ka = kernel_arrays(pm)
    assert (ka["n_inner"], ka["n_leaf"]) == (len(inner), len(leaves))
    nodes = np.concatenate([inner, leaves])
    np.testing.assert_array_equal(ka["bd_nodes"].numpy(),
                                  np.stack([nodes, np.asarray(topo.parent)[nodes]], axis=1))


def test_plan_refuses_a_root_off_node_0():
    topo, *_ = _models(clocks.UNCORRELATED_GAMMA)

    class Moved:
        parent = np.roll(np.asarray(topo.parent), 1)
        is_leaf = np.roll(np.asarray(topo.is_leaf), 1)

    with pytest.raises(ValueError, match="node 0"):
        prior_plan(Moved)


@pytest.mark.parametrize("clock", clocks.MODELS)
def test_passes_assemble_the_term_vector(clock):
    _, jm, js, pm, ps = _models(clock)
    got = by_pass(pm, ps)
    assert not torch.isnan(got).any(), "a term no pass writes"
    close(got, prior_terms_plain(pm, ps))
    close(got, jax.vmap(jm.log_prior_terms)(js))
