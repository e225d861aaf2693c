"""The bold contrary mixture of the PyTorch port against the JAX package's,
on the CPU at float64, with injected draws: K6's range-mode plain version
with the bold uniforms ``u_bold`` against the JAX ``_mega_range_contra`` of a
``FastSweeps(bold_p=0.25)``, block by block, and G1's sub_contra family
(``glob_scan``'s plain version with ``u_bold``) against the JAX
``_glob_step``, ticket by ticket: identical accepts, states and terms
within 1e-10; ``u_bold`` None equal to the call without it.  And the CLI:
``run``, ``continue`` and ``marginal-likelihood`` take ``--bold-contra``,
``--bold-factor``, ``--fiber-slide`` and ``--fiber-de``; ``run --mc3
--fiber-slide`` completes; ``--fiber-de`` under ``--mc3`` and under
``marginal-likelihood`` logs that it is not applied."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmcdate_tpu.engine import proposals as JP
from mcmcdate_tpu.engine.fast_sweep import FastSweeps as JFast
from mcmcdate_tpu_torch import cli
from mcmcdate_tpu_torch.engine import fast_sweep as TF, mh as TMH
from mcmcdate_tpu_torch.kernels import glob_step as G
from torch_fast_common import (C, Case, close, close_carry, jcarry_of, run_glob_jax, t)

F64 = jnp.float64
BOLD_P, BOLD_FACTOR = 0.25, 8.0


@functools.lru_cache(maxsize=None)
def case():
    """The calibrated 12-leaf case, and both packages' FastSweeps with the
    bold mixture."""
    cs = Case("full", priors=True)
    return (cs, JFast(cs.jm, cs.table, bold_p=BOLD_P, bold_factor=BOLD_FACTOR),
            TF.FastSweeps(cs.pm, cs.ptable, bold_p=BOLD_P, bold_factor=BOLD_FACTOR))


def test_range_contra_bold_matches_jax():
    cs, jfs, pfs = case()
    js, terms, d, z, q = cs.jcarry()
    tuning = jnp.asarray(cs.tuning)
    acc = jnp.zeros((C, cs.table.n_proposals), jnp.int32)
    port = cs.pcarry()
    ptun = t(cs.tuning)
    hT, rT, teT, dT, zT = js.heights.T, js.rates.T, terms.T, d.T, z.T
    scal = (js.birth, js.death, js.rate_var, js.height * js.rate_mean, js.height)
    keys = [k for k in jfs.plan.range_specs if k[0] == JP.K_SCALE_SUBTREES_CONTRA]
    assert keys
    n_acc = n_bold = 0
    for key_r in keys:
        spec = jfs.plan.range_specs[key_r]
        # Pad slots draw with sd 1 (see test_torch_fast_sweep_steps.py).
        spec = dataclasses.replace(spec, sd=np.where(spec.valid, spec.sd, 1.0))
        step, nspec = jfs._mega_range_contra(spec, F64)
        step = jax.jit(step)
        key = jax.random.PRNGKey(key_r[1] + 100)
        for m in range(spec.n_blocks):
            key, km = jax.random.split(key)
            sx = {k: v[m] for k, v in nspec.items()}
            k1, k2 = jax.random.split(km)
            k1, kb = jax.random.split(k1)
            shape = (spec.rows.shape[1], C)
            u_prop = jax.random.uniform(k1, shape, F64)
            u_bold = jax.random.uniform(kb, shape, F64)
            assert bool((jax.random.bernoulli(kb, BOLD_P, shape) == (u_bold < BOLD_P)).all())
            u_acc = jax.random.uniform(k2, shape, F64)
            acc0 = acc
            (hT, rT, teT, dT, zT, q, _, _, acc, _), _ = step(
                (hT, rT, teT, dT, zT, q, scal, tuning.T, acc, key), (sx, km))
            psx = pfs.range_t[key_r][m]
            n = psx["rows"].shape[0]
            ub = t(u_bold[:n].T)
            accept = pfs.range_contra_step(port, ptun, psx, t(u_prop[:n].T), t(u_acc[:n].T),
                                           ub)
            ref = ((np.asarray(acc) - np.asarray(acc0))[:, np.asarray(sx["rows"])]
                   * np.asarray(sx["valid"]) == 1)
            np.testing.assert_array_equal(accept.numpy(), ref[:, :n])
            n_acc += int(accept.sum())
            n_bold += int((ub < BOLD_P).sum())
            js = js.replace(heights=hT.T, rates=rT.T)
            for f in ("heights", "rates"):
                close(getattr(port.batch, f), getattr(js, f))
            close(port.terms, teT.T)
    assert n_acc > 0 and n_bold > 0


def test_range_contra_bold_off_is_plain():
    """``u_bold`` None runs the step without the mixture; uniforms all above
    ``bold_p`` leave every value as the plain step's, bitwise."""
    cs, _, pfs = case()
    key_r = next(k for k in pfs.range_t if k[0] == JP.K_SCALE_SUBTREES_CONTRA)
    psx = pfs.range_t[key_r][0]
    S = psx["rows"].shape[0]
    rng = np.random.default_rng(2)
    u_prop, u_acc = t(rng.uniform(size=(C, S))), t(rng.uniform(size=(C, S)))
    outs = []
    for ub in (None, t(np.full((C, S), 0.5))):
        port = cs.pcarry()
        outs.append((pfs.range_contra_step(port, t(cs.tuning), psx, u_prop, u_acc, ub), port))
    (a0, p0), (a1, p1) = outs
    assert np.array_equal(a0.numpy(), a1.numpy())
    for x, y in ((p0.batch.heights, p1.batch.heights), (p0.terms, p1.terms)):
        assert np.array_equal(x.numpy(), y.numpy())


def test_sub_contra_bold_matches_jax():
    cs, jfs, _ = case()
    tag = "sub_contra"
    grp = jfs.plan.glob_groups[tag]
    fam = cs.pfs.glob_fam[tag]
    assert grp.n_tickets == fam.n > 0
    port = cs.pcarry()
    jc = jcarry_of(port)
    key = jax.random.PRNGKey(5)
    keyed, bold = [], []
    for s in range(grp.n_tickets):
        key, kt = jax.random.split(key)
        k1, k2 = jax.random.split(kt)
        k1, kb = jax.random.split(k1)
        tune = jnp.asarray(cs.tuning[:, grp.rows[s]])
        keyed.append((kt, tune, jax.random.uniform(k1, (C,), F64),
                      jax.random.uniform(k2, (C,), F64)))
        bold.append(np.asarray(jax.random.uniform(kb, (C,), F64)))
    jc, ref = run_glob_jax(jax.jit(jfs._glob_step(tag, F64)), grp, keyed, jc)
    tun = t(cs.tuning[:, fam.grp.rows])
    draws = t(np.stack([np.asarray(k[2]) for k in keyed], 1))
    u_acc = t(np.stack([np.asarray(k[3]) for k in keyed], 1))
    u_bold = t(np.stack(bold, 1))
    out = G.glob_scan(cs.pfs.glob, fam, port, tun, draws, u_acc, u_bold=u_bold,
                      bold_p=BOLD_P, bold_factor=BOLD_FACTOR)
    np.testing.assert_array_equal(out.accept.numpy(), ref)
    assert 0 < int(out.accept.sum()) and bool((u_bold < BOLD_P).any())
    close_carry(port, jc, True)
    # None is the family without the mixture.
    p0, p1 = cs.pcarry(), cs.pcarry()
    a = G.glob_scan(cs.pfs.glob, fam, p0, tun, draws, u_acc).accept
    b = G.glob_scan(cs.pfs.glob, fam, p1, tun, draws, u_acc, u_bold=None, bold_p=BOLD_P).accept
    assert np.array_equal(a.numpy(), b.numpy())
    assert np.array_equal(p0.batch.heights.numpy(), p1.batch.heights.numpy())


@pytest.fixture
def prepared(tmp_path, monkeypatch):
    """A 7-leaf full-MVN preparation; burn-in cut to one window of 2
    iterations (a chunk of 10 sweeps)."""
    monkeypatch.setattr(TMH, "BURN_IN_PROF_FAST", [2])
    monkeypatch.setattr(TMH, "BURN_IN_PROF_SLOW", [])
    d = str(tmp_path)
    cli.main(["simulate", "--leaves", "7", "--trees", "80", "--seed", "3", "--out",
              os.path.join(d, "data")])
    cli.main(["prepare", "-a", "x", "--rooted-tree", os.path.join(d, "data", "time.tree"),
              "--trees", os.path.join(d, "data", "trees.nwk"), "--likelihood-spec", "full",
              "--out-dir", d])
    return d


def _log(d, mode):
    with open(os.path.join(d, f"x.{mode}.log")) as fh:
        return fh.read()


MOVES = ("--bold-contra", "0.4", "--bold-factor", "6", "--fiber-slide", "1", "--fiber-de", "2")


def test_cli_takes_the_flags(prepared, monkeypatch):
    from mcmcdate_tpu_torch.engine import stepping_stone as SS

    d = prepared
    common = ("-a", "x", "--device", "cpu", "--profile", "--out-dir", d, *MOVES)
    runner = cli.main(["run", "--chains", "4", "--seed", "2", "--iterations", "4", *common])
    assert runner.kern.bold_p == 0.4 and runner.kern.bold_factor == 6.0
    assert runner.kern.fiber_slide_p == 1.0 and runner.de_move is not None
    log = _log(d, "run")
    for line in ("bold contrary kernels: p=0.4, factor=6", "fiber node-slide phase: p=1",
                 "fiber-DE ensemble phase: 2 round(s)/chunk over 4 chains",
                 "fiber node-slide: mean acceptance", "fiber DE: mean acceptance"):
        assert line in log, line
    runner = cli.main(["continue", "--seed", "3", "--iterations", "4", *common])
    assert runner.kern.fiber_slide_p == 1.0 and runner.de_move is not None
    assert "fiber DE: mean acceptance" in _log(d, "continue")
    monkeypatch.setattr(SS, "N_POINTS_PROF", 4)
    monkeypatch.setattr(SS, "REPETITIVE_BURN_IN_PROF", TMH.BurnInSettings([], []))
    monkeypatch.setattr(SS, "CASCADE_SWEEPS", 1)
    res = cli.main(["marginal-likelihood", "--iterations", "10", *common])
    assert np.isfinite(res.log_marginal_likelihood)
    log = _log(d, "mlh")
    assert "fiber DE: not applied (marginal-likelihood does not run it)" in log
    assert "fiber node-slide phase: p=1" in log and "fiber-DE ensemble phase" not in log


def test_mc3_with_the_fiber_slide(prepared):
    d = prepared
    runner = cli.main(["run", "-a", "x", "--device", "cpu", "--chains", "1", "--mc3",
                       "--profile", "--seed", "2", "--iterations", "4", "--out-dir", d,
                       "--fiber-slide", "1", "--fiber-de", "1", "--bold-contra", "0.3"])
    assert runner.s.n_chains == 4 and runner.kern.fiber_slide_p == 1.0
    assert runner.de_move is None
    log = _log(d, "run")
    assert "fiber DE: not applied (MC3 does not run it)" in log
    assert "fiber-DE ensemble phase" not in log and "sampling done; swap acceptance" in log
