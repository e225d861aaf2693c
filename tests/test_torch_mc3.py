"""The port's MC3 through its CLI on the CPU (``run --mc3``, ``continue`` of
an MC3 checkpoint, with and without ``--hamiltonian``), and ``continue`` of
an MC3 checkpoint written by the JAX package.  ``run --mc3 --profile``
writes the JAX package's log lines, the cold chain's monitor rows, the
pooled cold chains' ``diagnostics.tsv`` and the MC3 meta with the ladder's
``mc3_dt``; ``continue`` resumes as MC3 (NUTS too where the meta says so)
from the saved state, tuning and ladder.  The schedules are cut by
monkeypatching: burn-in windows of 2 iterations, NUTS trajectories of one
doubling."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcdate_tpu.engine import checkpoint as jckpt
from mcmcdate_tpu.engine.proposals import build_proposal_table as j_table
from mcmcdate_tpu.models.state import init_state as j_init_state
from mcmcdate_tpu.ops.node_priors import BraceSet
from mcmcdate_tpu.tree import FlatTopology, read_one_newick
from mcmcdate_tpu_torch import cli
from mcmcdate_tpu_torch.engine import checkpoint as tckpt, fast_sweep as TF, hmc, mc3 as TM, \
    mh as TMH

GROUPS = 2
C = GROUPS * TM.N_TEMPS


@pytest.fixture
def prepared(tmp_path, monkeypatch):
    """A 7-leaf full-MVN preparation; burn-in cut to one fast and one slow
    window of 2 iterations, NUTS to one doubling."""
    monkeypatch.setattr(TMH, "BURN_IN_PROF_FAST", [2])
    monkeypatch.setattr(TMH, "BURN_IN_PROF_SLOW", [2])
    monkeypatch.setattr(hmc, "MAX_DEPTH", 1)
    d = str(tmp_path)
    cli.main(["simulate", "--leaves", "7", "--trees", "80", "--seed", "3", "--out",
              os.path.join(d, "data")])
    cli.main(["prepare", "-a", "x", "--rooted-tree", os.path.join(d, "data", "time.tree"),
              "--trees", os.path.join(d, "data", "trees.nwk"), "--likelihood-spec", "full",
              "--out-dir", d])
    return d


def _meta(d):
    with open(os.path.join(d, "x.mcmc.json")) as fh:
        return json.load(fh)


def _its(d, name="params"):
    with open(os.path.join(d, f"x.{name}.monitor")) as fh:
        return [int(line.split("\t")[0]) for line in fh.read().splitlines()[1:]]


def _log(d, mode):
    with open(os.path.join(d, f"x.{mode}.log")) as fh:
        return fh.read()


def _mc3_dt(d):
    return tckpt.load_arrays("x", ("mc3_dt",), in_dir=d)["mc3_dt"]


def _run(d, *extra):
    return cli.main(["run", "-a", "x", "--device", "cpu", "--chains", str(GROUPS), "--mc3",
                     "--profile", "--seed", "2", "--iterations", "4", "--out-dir", d, *extra])


def _continue(d, *extra):
    return cli.main(["continue", "-a", "x", "--device", "cpu", "--profile", "--seed", "5",
                     "--iterations", "4", "--out-dir", d, *extra])


@pytest.mark.parametrize("hamiltonian", (False, True), ids=("mhg", "nuts"))
def test_run_mc3_then_continue(prepared, hamiltonian):
    d = prepared
    flag = ("--hamiltonian",) if hamiltonian else ()
    runner = _run(d, *flag)
    assert runner.s.n_chains == C and (runner.nuts is not None) == hamiltonian
    log = _log(d, "run")
    assert f"MC3: {GROUPS} groups x 4 temperatures (betas [1.0, 0.909, 0.826, 0.751])" in log
    windows = [line for line in log.splitlines() if line.startswith("burn-in [")]
    assert len(windows) == 2 and all(", dt [" in w for w in windows)
    assert "per temperature pair: 0<->1: " in log and "2<->3: " in log
    assert ("NUTS adaptation: eps" in log) == hamiltonian
    meta = _meta(d)
    assert meta["mc3"] is True and meta["n_groups"] == GROUPS and meta["n_temps"] == 4
    assert meta["iteration"] == 4 and meta.get("hamiltonian", False) == hamiltonian
    dt = _mc3_dt(d)
    assert dt.shape == (3,) and np.array_equal(dt, runner.mc3["dt"])
    assert not np.allclose(dt, TM.DELTA_T)  # tuned over the burn-in windows
    assert _its(d) == [2, 4] and _its(d, "timetree") == [2, 4]
    trace = tckpt.load_trace("x", in_dir=d)
    assert trace["lp_post"].shape == (4, GROUPS)
    assert os.path.exists(os.path.join(d, "x.diagnostics.tsv"))
    state0, _, _, _ = tckpt.load("x", in_dir=d, device="cpu")
    assert state0.n_chains == C
    if hamiltonian:
        eps = float(tckpt.load_arrays("x", ("nuts_eps",), in_dir=d)["nuts_eps"])

    runner2 = _continue(d)
    log = _log(d, "continue")
    assert "Saved chain is an MC3 run; continuing with MC3." in log
    assert "Continuing MC3 from iteration 4." in log and "burn-in" not in log
    assert runner2.s.n_chains == C and (runner2.nuts is not None) == hamiltonian
    if hamiltonian:
        assert runner2.nuts.eps == eps
    meta = _meta(d)
    assert meta["iteration"] == 8 and meta["mc3"] is True and meta["n_groups"] == GROUPS
    assert meta.get("hamiltonian", False) == hamiltonian
    np.testing.assert_array_equal(_mc3_dt(d), dt)  # no burn-in: the saved ladder
    assert _its(d) == [2, 4, 6, 8]
    trace2 = tckpt.load_trace("x", in_dir=d)
    assert trace2["lp_post"].shape == (8, GROUPS)
    for k, v in trace.items():
        np.testing.assert_array_equal(trace2[k][:4], v, err_msg=k)
    state1, _, _, _ = tckpt.load("x", in_dir=d, device="cpu")
    assert not torch.equal(state0.heights, state1.heights)
    assert 0 < runner2.accepted < runner2.attempted


def test_continue_a_jax_mc3_checkpoint(prepared, monkeypatch):
    """A float64 MC3 checkpoint saved by the JAX package's
    ``checkpoint.save`` (its meta, ``mc3_dt``, PRNG key, tuning and trace
    sidecar) continues in the port as MC3 at float64: the first sweep starts
    from the saved state, the ladder and the tuning are the saved ones, the
    saved trace comes first."""
    d = prepared
    _run(d)  # the trace's names as an MC3 run writes them
    names = sorted(tckpt.load_trace("x", in_dir=d))
    tree = read_one_newick(os.path.join(d, "x.meantree"))
    topo = FlatTopology.from_tree(tree)
    one = j_init_state(tree, topo, dtype=jnp.float64)
    batch = jax.tree.map(lambda x: jnp.broadcast_to(x, (C,) + x.shape), one)
    rng = np.random.default_rng(6)
    batch = batch.replace(rates=jnp.asarray(rng.gamma(5.0, 0.2, (C, topo.n))),
                          birth=jnp.asarray(rng.uniform(0.5, 2.0, C)))
    n_prop = j_table(topo, BraceSet.empty(), False).n_proposals
    tuning = rng.uniform(0.5, 2.0, (C, n_prop))
    dt = np.asarray([0.05, 0.2, 0.35])
    jckpt.save("x", batch, jnp.asarray(tuning), jax.random.PRNGKey(5), 40, n_prop, out_dir=d,
               extra={"mc3": True, "n_groups": GROUPS, "n_temps": 4},
               extra_arrays={"mc3_dt": dt})
    jckpt.save_trace("x", {k: rng.uniform(size=(6, GROUPS)) for k in names}, out_dir=d)
    seen = []
    real = TF.FastSweeps.sweeps

    def spy(self, b, tu, seed, n, **kw):
        seen.append((b.heights.clone(), b.rates.clone(), b.birth.clone(), tu.clone(),
                     kw["beta"].clone(), kw["beta_prior"].clone()))
        return real(self, b, tu, seed, n, **kw)

    monkeypatch.setattr(TF.FastSweeps, "sweeps", spy)
    runner = _continue(d)
    assert str(runner.dtype) == "torch.float64" and runner.s.n_chains == C
    h0, r0, b0, tu0, beta, beta_prior = seen[0]
    np.testing.assert_array_equal(h0.numpy(), np.asarray(batch.heights))
    np.testing.assert_array_equal(r0.numpy(), np.asarray(batch.rates))
    np.testing.assert_array_equal(b0.numpy(), np.asarray(batch.birth))
    np.testing.assert_array_equal(tu0.numpy(), tuning)
    ladder = np.tile(TM.ladder_of(dt), GROUPS)
    np.testing.assert_array_equal(beta.numpy(), ladder)
    np.testing.assert_array_equal(beta_prior.numpy(), ladder)
    meta = _meta(d)
    assert meta["iteration"] == 44 and meta["mc3"] is True and meta["dtype"] == "float64"
    np.testing.assert_array_equal(_mc3_dt(d), dt)
    _, tuning1, _, _ = tckpt.load("x", in_dir=d, device="cpu")
    np.testing.assert_array_equal(tuning1.numpy(), tuning)  # sampling does not tune
    trace = tckpt.load_trace("x", in_dir=d)
    assert sorted(trace) == names and all(v.shape == (10, GROUPS) for v in trace.values())
    assert _its(d)[-2:] == [42, 44]
