"""The port's ``continue`` (``cli.cmd_continue``, ``run_analysis(
continue_from=)``) on the CPU: a port run continued by the port appends its
monitors with iterations numbered after the checkpoint's and preloads the
saved trace; a float64 checkpoint written by the JAX package continues in
the port at float64; an MC3 checkpoint continues as MC3, a NUTS one with
the NUTS move."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmcdate_tpu.engine import checkpoint as jckpt
from mcmcdate_tpu.engine.proposals import build_proposal_table as j_table
from mcmcdate_tpu.models.state import init_state as j_init_state
from mcmcdate_tpu.ops.node_priors import BraceSet
from mcmcdate_tpu.tree import FlatTopology, read_one_newick
from mcmcdate_tpu_torch import cli
from mcmcdate_tpu_torch.engine import chains as TC, checkpoint as tckpt, mh as TM

C = 4


@pytest.fixture
def prepared(tmp_path, monkeypatch):
    """A 7-leaf full-MVN preparation, and a sampler cut to chunks of 2
    sweeps and a 2-sweep burn-in."""
    monkeypatch.setattr(TC, "CHUNK", 2)
    monkeypatch.setattr(TM, "BURN_IN_PROF_FAST", [2])
    monkeypatch.setattr(TM, "BURN_IN_PROF_SLOW", [])
    d = str(tmp_path)
    cli.main(["simulate", "--leaves", "7", "--trees", "80", "--seed", "3", "--out",
              os.path.join(d, "data")])
    cli.main(["prepare", "-a", "x", "--rooted-tree", os.path.join(d, "data", "time.tree"),
              "--trees", os.path.join(d, "data", "trees.nwk"), "--likelihood-spec", "full",
              "--out-dir", d])
    return d


def _rows(d, name):
    with open(os.path.join(d, f"x.{name}.monitor")) as fh:
        lines = fh.read().splitlines()
    return lines[0], [int(line.split("\t")[0]) for line in lines[1:]]


def _meta(d):
    with open(os.path.join(d, "x.mcmc.json")) as fh:
        return json.load(fh)


def _continue(d, iterations, *extra):
    return cli.main(["continue", "-a", "x", "--device", "cpu", "--profile", "--seed", "9",
                     "--iterations", str(iterations), "--out-dir", d, *extra])


def test_run_then_continue(prepared):
    d = prepared
    cli.main(["run", "-a", "x", "--device", "cpu", "--chains", str(C), "--iterations", "6",
              "--seed", "2", "--profile", "--out-dir", d])
    assert _meta(d)["iteration"] == 6
    trace0 = tckpt.load_trace("x", in_dir=d)
    assert trace0["lp_post"].shape == (6, C)
    state0, _, _, _ = tckpt.load("x", in_dir=d, device="cpu")
    runner = _continue(d, 4)
    assert runner.s.n_chains == C
    meta = _meta(d)
    assert meta["iteration"] == 10 and meta["dtype"] == "float32"
    for name in ("params", "timetree", "ratetree", "prior"):
        header, its = _rows(d, name)
        assert header.startswith("Iteration")
        assert its == [2, 4, 6, 8, 10], name
    trace = tckpt.load_trace("x", in_dir=d)
    assert trace["lp_post"].shape == (10, C)
    for k, v in trace0.items():  # the saved draws come first, unchanged
        np.testing.assert_array_equal(trace[k][:6], v, err_msg=k)
    state1, _, _, _ = tckpt.load("x", in_dir=d, device="cpu")
    assert not np.array_equal(state0.heights.numpy(), state1.heights.numpy())
    assert 0 < runner.accepted < runner.attempted
    with open(os.path.join(d, "x.continue.log")) as fh:
        assert "Continuing from iteration 6." in fh.read()


def test_continue_a_jax_checkpoint(prepared):
    """A float64 checkpoint saved by the JAX package's ``checkpoint.save``
    (its PRNG key, tuning, iteration and trace sidecar) continues in the
    port at float64."""
    d = prepared
    # the trace's names as a run writes them (scalars and diagnostic ages)
    cli.main(["run", "-a", "x", "--device", "cpu", "--chains", "2", "--iterations", "2",
              "--seed", "2", "--profile", "--out-dir", d])
    names = sorted(tckpt.load_trace("x", in_dir=d))
    tree = read_one_newick(os.path.join(d, "x.meantree"))
    topo = FlatTopology.from_tree(tree)
    one = j_init_state(tree, topo, dtype=jnp.float64)
    batch = jax.tree.map(lambda x: jnp.broadcast_to(x, (C,) + x.shape), one)
    rng = np.random.default_rng(4)
    batch = batch.replace(rates=jnp.asarray(rng.gamma(5.0, 0.2, (C, topo.n))))
    n_prop = j_table(topo, BraceSet.empty(), False).n_proposals
    jckpt.save("x", batch, jnp.ones((C, n_prop), jnp.float64), jax.random.PRNGKey(5), 40,
               n_prop, out_dir=d)
    jckpt.save_trace("x", {k: rng.uniform(size=(8, C)) for k in names}, out_dir=d)
    runner = _continue(d, 4, "--chains", str(C))
    assert runner.dtype.is_floating_point and str(runner.dtype) == "torch.float64"
    meta = _meta(d)
    assert meta["iteration"] == 44 and meta["dtype"] == "float64"
    header, its = _rows(d, "params")
    assert its[-2:] == [42, 44]
    trace = tckpt.load_trace("x", in_dir=d)
    assert sorted(trace) == names
    assert all(v.shape == (12, C) for v in trace.values())
    state, tuning, key, _ = tckpt.load("x", in_dir=d, device="cpu")
    assert state.heights.dtype.is_floating_point and str(state.heights.dtype) == "torch.float64"
    assert tuning.shape == (C, n_prop) and key.dtype == np.uint32


@pytest.mark.parametrize("flag", ("mc3", "hamiltonian"))
def test_unported_checkpoints_raise(prepared, flag, monkeypatch):
    """Checkpoints of the modes ported after ``continue``: one marked
    ``mc3`` (here a 4-chain run's, one group of 4 temperatures) continues as
    MC3, one marked ``hamiltonian`` with the NUTS move (its trajectories
    cut to one doubling)."""
    from mcmcdate_tpu_torch.engine import hmc

    monkeypatch.setattr(hmc, "MAX_DEPTH", 1)
    d = prepared
    chains = "4" if flag == "mc3" else "2"
    cli.main(["run", "-a", "x", "--device", "cpu", "--chains", chains, "--iterations", "2",
              "--seed", "2", "--profile", "--out-dir", d])
    meta = _meta(d)
    meta[flag] = True
    if flag == "mc3":
        meta["n_groups"] = 1
    with open(os.path.join(d, "x.mcmc.json"), "w") as fh:
        json.dump(meta, fh)
    if flag == "mc3":
        runner = _continue(d, 2)
        meta = _meta(d)
        assert runner.mc3 is not None and runner.s.n_chains == 4
        assert meta["mc3"] is True and meta["n_groups"] == 1 and meta["iteration"] == 4
        assert "mc3_dt" in tckpt.load_arrays("x", ("mc3_dt",), in_dir=d)
        return
    runner = _continue(d, 2)
    assert runner.nuts is not None and _meta(d)["hamiltonian"] is True
