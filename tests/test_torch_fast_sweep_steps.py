"""The PyTorch port's batched FastSweeps steps against the JAX package's, on
the CPU at float64, with injected draws: every mega-step of the contrary
slides, the likelihood-coupled slides and branch-rate scales, the contrary
subtree scales and the ultrametric and rate subtree scales, on a calibrated
model.  The likelihood-coupled steps run with the full likelihood and with
none (which skips the z/q carry); the contrary steps touch no likelihood,
and a univariate likelihood takes the full code with a diagonal precision
in both packages, so they run with the full one only (compiling a JAX step
takes seconds on the CPU).  The JAX step functions run one step at a time,
each compiled once; the port gets the uniforms and gamma variates that JAX
draws from the step's keys.  Accept masks must be
identical, and heights, rates, terms, d, z, q and accept counts equal to
1e-10 of scale.  Every range block here has pad slots, so the accepts
counted show that padded blocks accept."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmcdate_tpu.engine import proposals as JP
from torch_fast_common import C, Case, close, t

F64 = jnp.float64


def grid(contra, coupled):
    """``(kind, likelihood)`` cases: the contrary kind with the full
    likelihood, the likelihood-coupled kinds with full and none."""
    return [(contra, "full")] + [(k, lik) for k in coupled for lik in ("full", "none")]


@functools.lru_cache(maxsize=None)
def case(lik):
    return Case(lik, priors=True)


def _compare(cs, port, js, terms, d, z, q, acc):
    b = port.batch
    for f in ("heights", "rates", "birth", "death", "height", "rate_mean", "rate_var"):
        close(getattr(b, f), getattr(js, f))
    close(port.terms, terms)
    close(port.d, d)
    if cs.pfs.use_lik:
        close(port.z, z)
        close(port.q, q)
    np.testing.assert_array_equal(port.acc.numpy(), np.asarray(acc))


def _check_accept(accept, acc0, acc1, rows, valid):
    """The port's accept mask (over the step's valid slots, which come
    first) against the JAX step's, read from its accept counts (rows of a
    step are distinct); JAX's pad slots never accept."""
    ref = (np.asarray(acc1) - np.asarray(acc0))[:, np.asarray(rows)] * np.asarray(valid) == 1
    n = accept.shape[1]
    np.testing.assert_array_equal(accept.numpy(), ref[:, :n])
    assert not ref[:, n:].any() and np.asarray(valid)[:n].all()


@pytest.mark.parametrize("kind,lik", grid(JP.K_SLIDE_NODES_CONTRA,
                                          (JP.K_SLIDE_NODE_ULTRA, JP.K_SCALE_BRANCH_RATE)))
def test_point_steps_match_jax(kind, lik):
    cs = case(lik)
    jfs, pfs = cs.jfs, cs.pfs
    spec = jfs.plan.specs[kind]
    if kind == JP.K_SLIDE_NODES_CONTRA:
        step, nspec = jfs._mega_contra_slide(spec, F64)
    else:
        step, nspec = jfs._mega_point_lik(spec, F64)
    step = jax.jit(step)  # compiled once for all the kind's steps
    js, terms, d, z, q = cs.jcarry()
    tuning = jnp.asarray(cs.tuning)
    acc = jnp.zeros((C, cs.table.n_proposals), jnp.int32)
    port = cs.pcarry()
    ptun = t(cs.tuning)
    key = jax.random.PRNGKey(kind)
    n_acc = 0
    for m in range(spec.n_mega):
        key, km = jax.random.split(key)
        sx = {k: v[m] for k, v in nspec.items()}
        k1, k2 = jax.random.split(km)
        shape = (C, spec.b)
        if kind == JP.K_SCALE_BRANCH_RATE:
            draw = jax.random.gamma(k1, jnp.asarray(sx["sd"], F64) / tuning[:, sx["rows"]],
                                    dtype=F64)
        else:
            draw = jax.random.uniform(k1, shape, F64)
        u_acc = jax.random.uniform(k2, shape, F64)
        acc0 = acc
        if kind == JP.K_SLIDE_NODES_CONTRA:
            (js, terms, _, acc, _), _ = step((js, terms, tuning, acc, key), (sx, km))
        else:
            (js, terms, d, z, q, _, acc, _), _ = step(
                (js, terms, d, z, q, tuning, acc, key), (sx, km))
        psx = pfs.spec_t[kind][m]
        n = psx["rows"].shape[0]
        if kind == JP.K_SLIDE_NODES_CONTRA:
            accept = pfs.contra_slide_step(port, ptun, psx, t(draw[:, :n]), t(u_acc[:, :n]))
        else:
            accept = pfs.point_lik_step(kind, port, ptun, psx, t(draw[:, :n]), t(u_acc[:, :n]))
        _check_accept(accept, acc0, acc, sx["rows"], sx["valid"])
        n_acc += int(accept.sum())
        _compare(cs, port, js, terms, d, z, q, acc)
    assert 0 < n_acc


@pytest.mark.parametrize("kind,lik", grid(JP.K_SCALE_SUBTREES_CONTRA,
                                          (JP.K_SCALE_SUBTREE_ULTRA, JP.K_SCALE_SUBTREE_RATE)))
def test_range_steps_match_jax(kind, lik):
    cs = case(lik)
    jfs, pfs = cs.jfs, cs.pfs
    js, terms, d, z, q = cs.jcarry()
    tuning = jnp.asarray(cs.tuning)
    acc = jnp.zeros((C, cs.table.n_proposals), jnp.int32)
    port = cs.pcarry()
    ptun = t(cs.tuning)
    # The JAX range phase runs in the transposed [param, chains] layout.
    hT, rT, teT, dT, zT = js.heights.T, js.rates.T, terms.T, d.T, z.T
    scal = (js.birth, js.death, js.rate_var, js.height * js.rate_mean, js.height)
    keys = [k for k in jfs.plan.range_specs if k[0] == kind]
    assert keys
    n_acc = 0
    for key_r in keys:
        spec = jfs.plan.range_specs[key_r]
        # Pad slots draw with sd 1, not 0: with sd 0 their factor is NaN and
        # the JAX scan's cross terms (0 * NaN) reject every ticket of a block
        # that has pads (ROADMAP.md, Queue 3); the port zeroes the pads'
        # coefficient instead, which is the JAX result for sd 1.
        spec = dataclasses.replace(spec, sd=np.where(spec.valid, spec.sd, 1.0))
        if kind == JP.K_SCALE_SUBTREES_CONTRA:
            step, nspec = jfs._mega_range_contra(spec, F64)
        else:
            step, nspec = jfs._mega_range_lik(spec, F64)
        step = jax.jit(step)
        key = jax.random.PRNGKey(key_r[1])
        for m in range(spec.n_blocks):
            key, km = jax.random.split(key)
            sx = {k: v[m] for k, v in nspec.items()}
            k1, k2 = jax.random.split(km)
            shape = (spec.rows.shape[1], C)
            if kind == JP.K_SCALE_SUBTREE_RATE:
                draw = jax.random.gamma(
                    k1, jnp.asarray(sx["sd"], F64)[:, None] / tuning.T[sx["rows"]], dtype=F64)
            else:
                draw = jax.random.uniform(k1, shape, F64)
            u_acc = jax.random.uniform(k2, shape, F64)
            acc0 = acc
            (hT, rT, teT, dT, zT, q, _, _, acc, _), _ = step(
                (hT, rT, teT, dT, zT, q, scal, tuning.T, acc, key), (sx, km))
            psx = pfs.range_t[key_r][m]
            n = psx["rows"].shape[0]
            draw, u_acc = t(draw[:n].T), t(u_acc[:n].T)
            if kind == JP.K_SCALE_SUBTREES_CONTRA:
                accept = pfs.range_contra_step(port, ptun, psx, draw, u_acc)
            else:
                accept = pfs.range_lik_step(kind, port, ptun, psx, draw, u_acc)
            _check_accept(accept, acc0, acc, sx["rows"], sx["valid"])
            n_acc += int(accept.sum())
            js = js.replace(heights=hT.T, rates=rT.T)
            _compare(cs, port, js, teT.T, dT.T, zT.T, q, acc)
    assert 0 < n_acc
