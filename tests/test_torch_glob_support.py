"""The subtree families' support rows: a sub_ultra or sub_rate ticket moves
only its subtree's distances, so FastSweeps forms its product over those
rows alone (``delta_S @ P[S]``, :meth:`FastSweeps.glob_product`), and the
range-restricted glob kernels keep the JAX invalid rule through a count of
bad entries.  On the CPU at float64, on the 12-leaf calibrated model of
``torch_fast_common`` (both root-adjacent subtrees among the tickets):

- the plain prologue's ``delta`` is exactly 0 off the support rows that
  ``GlobConsts.support`` gives, and its ``delta_S`` is ``delta`` on them;
- ``glob_phase`` with the restricted product against the full one:
  identical accept counts and state, d, z and q within 1e-12 of scale;
- the subtree families through the wrappers (plain prologue, restricted
  product, plain epilogue) against the JAX ``_glob_step`` over the same
  keys: identical accept masks, state, terms, d, z and q to 1e-10 of scale;
- a chain with a NaN or -inf term outside a ticket's subtree (a negative
  leaf rate: its clock term is -inf) rejects every ticket of the subtree
  families, as the JAX step does."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcdate_tpu_torch.kernels import glob_step as G
from mcmcdate_tpu_torch.ops.dists import standard_gamma
from torch_fast_common import C, Case, close, close_carry, jcarry_of, keyed_glob_draws, \
    run_glob_jax, run_glob_port, t

F64 = jnp.float64
SUBTREE = ("sub_contra", "sub_ultra", "sub_rate")
BAD_NODE = 2  # a leaf under the left root child, outside most subtrees


@functools.lru_cache(maxsize=None)
def case(lik):
    return Case(lik, priors=True)


def _distinct(grp):
    """The family's first ticket of each subtree, as a group of its own."""
    _, first = np.unique(grp.lo, return_index=True)
    idx = np.sort(first)
    return dataclasses.replace(grp, **{f.name: getattr(grp, f.name)[idx]
                                       for f in dataclasses.fields(grp) if f.name != "tag"})


@functools.lru_cache(maxsize=None)
def _jax_step(lik, tag):
    return jax.jit(case(lik).jfs._glob_step(tag, F64))


def _run_jax(cs, lik, tag, grp, keyed, jc):
    return run_glob_jax(_jax_step(lik, tag), grp, keyed, jc)


def _run_port(cs, tag, grp, keyed, carry):
    """The family through the wrappers on CPU tensors: glob_scan, or per
    ticket the prologue, FastSweeps.glob_product and the epilogue."""
    fam = G.GlobFamily.of(grp, "cpu", torch.float64, cs.pfs.glob.pos)
    return run_glob_port(cs, tag, fam, keyed, carry)


@pytest.mark.parametrize("tag", ("sub_ultra", "sub_rate"))
def test_subtree_delta_is_zero_off_support(tag):
    cs = case("full")
    fs = cs.pfs
    fam = fs.glob_fam[tag]
    carry = cs.pcarry()
    gen = torch.Generator().manual_seed(11)
    tun = t(cs.tuning[:, fam.grp.rows])
    draws = (standard_gamma(fam.sd / tun, gen) if tag in G.GAMMA_TAGS
             else torch.rand(C, fam.n, generator=gen, dtype=torch.float64))
    u_acc = torch.rand(C, fam.n, generator=gen, dtype=torch.float64)
    D = carry.d.shape[1]
    n_acc = 0
    for s in range(fam.n):
        lo, hi = int(fam.grp.lo[s]), int(fam.grp.hi[s])
        rows = fs.glob.support(lo, hi)
        assert len(rows) == hi - lo and np.all(np.diff(rows) > 0)
        pro = G.glob_dense_prologue(fs.glob, fam, s, carry, tun, draws)
        off = np.setdiff1d(np.arange(D), rows)
        assert torch.equal(pro.delta[:, off], torch.zeros(C, len(off), dtype=torch.float64))
        assert torch.equal(pro.delta_s, pro.delta[:, rows])
        w = fs.glob_product(fam, s, pro)
        close(w, (pro.delta @ fs.P).numpy(), tol=1e-13)
        n_acc += int(G.glob_dense_epilogue(fs.glob, fam, s, carry, pro, w, u_acc).sum())
    assert 0 < n_acc < C * fam.n


@pytest.mark.parametrize("lik", ("full", "uni"))
def test_glob_phase_restricted_product_matches_full(lik):
    cs = Case(lik, priors=True) if lik == "uni" else case(lik)
    fs = cs.pfs
    tuning = t(cs.tuning)
    runs = []
    for restricted in (True, False):
        carry = cs.pcarry()
        if not restricted:
            fs.glob_product = lambda fam, s, pro: fs._x_P(pro.delta)
        try:
            fs.glob_phase(carry, tuning, torch.Generator().manual_seed(5))
        finally:
            fs.__dict__.pop("glob_product", None)
        runs.append(carry)
    a, b = runs
    assert torch.equal(a.acc, b.acc)
    assert int(a.acc.sum()) > 0
    for f in ("heights", "rates", "birth", "death", "height", "rate_mean", "rate_var"):
        assert torch.equal(getattr(a.batch, f), getattr(b.batch, f))
    assert torch.equal(a.terms, b.terms)
    for x, y in ((a.d, b.d), (a.z, b.z), (a.q, b.q)):
        close(x, y.numpy(), tol=1e-12)


@pytest.mark.parametrize("lik", ("full", "none"))
@pytest.mark.parametrize("tag", ("sub_ultra", "sub_rate"))
def test_subtree_families_match_jax(lik, tag):
    cs = case(lik)
    grp = _distinct(cs.pfs.plan.glob_groups[tag])
    keyed = keyed_glob_draws(cs, grp, tag, seed=17 + len(tag))
    jc, ref = _run_jax(cs, lik, tag, grp, keyed, cs.jcarry())
    port = cs.pcarry()
    accept = _run_port(cs, tag, grp, keyed, port)
    np.testing.assert_array_equal(accept, ref)
    assert 0 < int(ref.sum()) < ref.size
    close_carry(port, jc, cs.pfs.use_lik)


@pytest.mark.parametrize("tag", SUBTREE)
def test_bad_term_outside_subtree_rejects_every_ticket(tag):
    cs = case("full")
    grp = _distinct(cs.pfs.plan.glob_groups[tag])
    # Some of the family's subtrees leave the bad node out.
    assert np.any((grp.lo > BAD_NODE) | (grp.hi <= BAD_NODE))
    rates = cs.state["rates"].copy()
    rates[0, BAD_NODE] = -0.5
    keyed = keyed_glob_draws(cs, grp, tag, seed=29 + len(tag))

    # Both packages start from the port's carry of the bad state (float64).
    port = cs.pfs.init_carry(cs.ps.replace(rates=t(rates)))
    port.z, port.q = cs.pfs._zq_from_y(cs.pm.whitened_residual_internal(port.batch))
    assert int(torch.isneginf(port.terms[0]).sum()) == 1
    jc = jcarry_of(port)
    jc, ref = _run_jax(cs, "full", tag, grp, keyed, jc)
    accept = _run_port(cs, tag, grp, keyed, port)
    np.testing.assert_array_equal(accept, ref)
    assert not ref[0].any()
    assert ref[1:].any()
    close_carry(port, jc, True)
