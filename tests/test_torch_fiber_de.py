"""The fiber differential evolution of the PyTorch port against the JAX
package's, on the CPU at float64: one red-black round of F2's plain version
(``kernels.fiber_de``, through ``engine.ensemble.FiberDE``) against the JAX
``make_fiber_de`` on its key schedule (identical accepts, heights and rates
within 1e-10, the same acceptance); its log-Jacobian against
``torch.autograd.functional.jacobian``'s log-determinant of the move's map;
the rounds through ``ChainRunner`` (``round(N)`` rounds a chunk, a gate
below 1, off with fewer than 4 chains, logged); and a short
``run_analysis`` at 8 leaves with all three optional moves on, whose node
ages hold those of the plain port run."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcdate_tpu.engine.ensemble import make_fiber_de
from mcmcdate_tpu.models.state import State as JState
from mcmcdate_tpu_torch.engine import chains as TC, mh as TMH
from mcmcdate_tpu_torch.engine.ensemble import FiberDE
from mcmcdate_tpu_torch.kernels.fiber_de import fiber_de_plain
from mcmcdate_tpu_torch.models.state import FIELDS, State
from torch_fast_common import C, Case, close, t

F64 = jnp.float64


@functools.lru_cache(maxsize=None)
def dispersed():
    """A calibrated 12-leaf case whose chains' inner heights are each moved a
    random fraction toward their parents (in pre-order: every span stays
    positive), so that donor differences vary node by node."""
    cs = Case("full", priors=True)
    h = cs.state["heights"].copy()
    parent = np.asarray(cs.topo.parent)
    leaf = np.asarray(cs.topo.is_leaf)
    rng = np.random.default_rng(9)
    for c in range(C):
        for i in range(1, h.shape[1]):
            if not leaf[i]:
                h[c, i] += rng.uniform(0, 0.3) * (h[c, parent[i]] - h[c, i])
    return cs, dict(cs.state, heights=h)


def _jax_draws(key, m, n_oth):
    """A JAX half-update's draws from its key: ``(a, b, u_jump, z, u_acc)``."""
    k_a, k_b, k_g, k_j, k_u = jax.random.split(key, 5)
    a = jax.random.randint(k_a, (m,), 0, n_oth)
    b0 = jax.random.randint(k_b, (m,), 0, n_oth - 1)
    b = jnp.where(b0 >= a, b0 + 1, b0)
    u_jump = jax.random.uniform(k_j, (m,), F64)  # bernoulli's own uniform at float64
    assert bool((jax.random.bernoulli(k_j, 0.2, (m,)) == (u_jump < 0.2)).all())
    z = jax.random.normal(k_g, (m,), F64)
    u = jax.random.uniform(k_u, (m,), F64, minval=jnp.finfo(F64).tiny)
    return tuple(np.asarray(x) for x in (a, b, u_jump, z, u))


def test_fiber_de_round_matches_jax():
    cs, state = dispersed()
    jb = JState(**{k: jnp.asarray(v) for k, v in state.items()})
    key = jax.random.PRNGKey(4)
    jb2, rate = jax.jit(make_fiber_de(cs.jm, F64))(jb, key)
    ps = State(**{k: torch.as_tensor(state[k]) for k in FIELDS})
    h0 = ps.heights.clone()
    de = FiberDE(cs.pm)
    h = C // 2
    n_acc = 0
    for kk, (act0, m, oth0) in zip(jax.random.split(key), ((0, h, h), (h, C - h, 0))):
        a, b, u_jump, z, u = _jax_draws(kk, m, C - m)
        draws = (t(a).int(), t(b).int(), t(u_jump), t(z), t(u))
        out = de.half_update(ps, act0, m, oth0, draws)
        moved = (np.asarray(jb2.heights)[act0:act0 + m] != h0[act0:act0 + m].numpy()).any(1)
        np.testing.assert_array_equal(out.accept.numpy(), moved)
        n_acc += int(out.accept.sum())
    assert 0 < n_acc < C
    assert abs(n_acc / C - float(rate)) < 1e-12
    close(ps.heights, jb2.heights)
    close(ps.rates, jb2.rates)


def test_log_jacobian_matches_autograd():
    """For fixed donors and step the move maps (inner heights, non-root
    rates) one to one; the plain version's log_jac is the log-determinant of
    that map's Jacobian."""
    cs, state = dispersed()
    topo = cs.pm.topo
    inner = torch.as_tensor([i for i in range(1, topo.n) if not bool(topo.is_leaf[i])])
    free_r = torch.arange(1, topo.n)
    base = State(**{k: torch.as_tensor(state[k][:4]) for k in FIELDS})
    a, b = torch.tensor([0], dtype=torch.int32), torch.tensor([1], dtype=torch.int32)
    g = torch.tensor([0.7], dtype=torch.float64)
    ones = torch.ones(1, dtype=torch.float64)

    def propose(x, out=None):
        h = base.heights.clone()
        r = base.rates.clone()
        h[3, inner] = x[:len(inner)]
        r[3, free_r] = x[len(inner):]
        st = base.replace(heights=h, rates=r)
        o = fiber_de_plain(cs.pm, st, 3, 1, 1, a, b, ones, ones, ones, 0.1, g=g)
        if out is not None:
            out.append(o)
        return torch.cat([o.h_prop[0, inner], o.r_prop[0, free_r]])

    x0 = torch.cat([base.heights[3, inner], base.rates[3, free_r]])
    J = torch.autograd.functional.jacobian(propose, x0)
    sign, logdet = torch.linalg.slogdet(J)
    outs = []
    propose(x0, outs)
    assert float(sign) > 0
    assert abs(float(logdet) - float(outs[0].log_jac[0])) < 1e-9


def _runner(cs, n_chains, fiber_de, log):
    s = TC.RunSettings("t", n_chains=n_chains, seed=1, dtype="float64", device="cpu",
                       fiber_de=fiber_de)
    return TC.ChainRunner(cs.pm, cs.ptable, s, log=log)


def test_rounds_through_chain_runner():
    cs = Case("full", leaves=8)
    lines = []
    r2 = _runner(cs, 2, 1.0, lines.append)
    assert r2.de_move is None and lines[-1].startswith("fiber DE: not applied")
    # round(N) rounds after each chunk of sweeps, their acceptances kept.
    runner = _runner(cs, C, 2.0, lines.append)
    assert runner.de_move is not None and "fiber-DE ensemble phase" in lines[-1]
    batch = State(**{k: getattr(cs.ps, k).clone() for k in FIELDS})
    h0 = batch.heights.clone()
    batch, _, _, _, _ = runner._run_window(batch, t(cs.tuning), TC.new_key(3), 10)
    accs = runner._extra_accs["fiber DE"]
    assert len(accs) == 2 and all(0.0 <= x <= 1.0 for x in accs), accs
    assert not torch.equal(batch.heights, h0)
    # Below 1, one round with that probability, drawn on the host.
    gated = _runner(cs, C, 0.5, lines.append)
    for seed in range(12):
        gated._de_rounds(batch, seed)
    assert 0 < len(gated._extra_accs["fiber DE"]) < 12


def test_optional_moves_hold_the_posterior(tmp_path):
    """A short run with the bold mixture, the fiber node-slide and the fiber
    DE on: the node-age means agree with the plain port run's within Monte
    Carlo error (|z| < 5, each mean's error over the chains)."""
    from mcmcdate_tpu_torch import prepare as tprep
    from mcmcdate_tpu_torch.io import lhdata
    from mcmcdate_tpu_torch.models import DatingModel, init_state
    from mcmcdate_tpu_torch.tree import FlatTopology, read_one_newick
    from mcmcdate_tpu_torch.utils.simulate import simulate, write_fixture

    write_fixture(simulate(n_leaves=8, n_trees=300, seed=7, rate_var=0.05), str(tmp_path / "d"))
    tprep.prepare("an", str(tmp_path / "d/time.tree"), str(tmp_path / "d/trees.nwk"), "full",
                  out_dir=str(tmp_path), log=lambda *a: None)
    tree = read_one_newick(str(tmp_path / "an.meantree"))
    topo = FlatTopology.from_tree(tree)
    model = DatingModel(topo=topo, likelihood=lhdata.load_data(str(tmp_path / "an.data")),
                        device="cpu")
    ages = {}
    lines = []
    for name, kw in (("plain", {}), ("moves", dict(bold_contra=0.4, fiber_slide=1.0,
                                                   fiber_de=1.0))):
        settings = TC.RunSettings(name, burn_in=TMH.BurnInSettings([10], []), iterations=10,
                                  n_chains=64, out_dir=str(tmp_path), seed=3, dtype="float64",
                                  device="cpu", **kw)
        runner = TC.run_analysis(model, init_state(tree, topo, device="cpu"), settings,
                                 log=lines.append)
        with np.load(tmp_path / f"{name}.trace.npz") as z:
            ages[name] = {lbl: z[f"age[{lbl}]"] for lbl in runner.diag_labels}
    for prefix in ("bold contrary kernels: p=0.4", "fiber node-slide: mean acceptance",
                   "fiber DE: mean acceptance"):
        assert any(s.startswith(prefix) for s in lines), prefix
    for lbl, a in ages["moves"].items():
        b = ages["plain"][lbl]
        ma, mb = a.mean(0), b.mean(0)  # per-chain means [chains]
        se = np.sqrt(ma.var(ddof=1) / len(ma) + mb.var(ddof=1) / len(mb))
        if se == 0:
            assert ma.mean() == mb.mean(), lbl  # the root
            continue
        assert abs(ma.mean() - mb.mean()) < 5 * se, (lbl, ma.mean(), mb.mean(), se)
