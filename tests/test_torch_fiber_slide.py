"""The fiber node-slide of the PyTorch port against the JAX package's, on the
CPU at float64: the colour-class plan (``fast_sweep.fiber_slide_plan``)
equal to the JAX ``FastSweeps._fiber_slide_plan`` on a binary and a
multifurcating model, each with calibrations, a constraint and a brace; and
one phase of F1's plain version (``kernels.fiber_slide``, class by class)
against the JAX ``_fiber_slide_move`` on the JAX key schedule, at a prior
temperature of 1 and on a 4-rung ladder of prior temperatures: identical
accepts, heights, rates and terms within 1e-10, every branch distance
unchanged to 1e-12.  The JAX move multiplies a ``[C]`` temperature into a
``[C, m]`` delta, which does not broadcast (ROADMAP.md, Queue 3): the
ladder runs JAX once per rung at that rung's scalar temperature, on the
same keys, and takes that rung's chains."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcdate_tpu_torch.engine import fast_sweep as TF
from mcmcdate_tpu_torch.kernels.fiber_slide import FiberClass, fiber_slide
from mcmcdate_tpu_torch.models.state import FIELDS, State
from torch_fast_common import C, Case, close, t

F64 = jnp.float64
LADDER = (1.0, 0.8, 0.6, 0.4)


@functools.lru_cache(maxsize=None)
def case(shape):
    return Case("full", shape=shape, priors=True)


@pytest.mark.parametrize("shape", ["binary", "multi"])
def test_plan_matches_jax(shape):
    cs = case(shape)
    ref = cs.jfs._fiber_slide_plan()
    port = TF.fiber_slide_plan(cs.pm)
    assert len(port) == len(ref) >= 2
    for a, b in zip(port, ref):
        assert list(a) == list(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # The fixtures exercise the constraint and brace conflicts and owners.
    assert cs.jm.constraints.n and cs.jm.braces.n
    T = len(ref[0]["owner"])
    nn = cs.jm.calibrations.n + cs.jm.constraints.n + cs.jm.braces.n
    assert any((c["owner"][T - nn:] < len(c["idx"])).any() for c in ref)
    if shape == "multi":
        assert max(c["ch"].shape[1] for c in ref) > 2
    # Each class's owned rows, as F1 reads them, are the owner map's.
    for c in port:
        fc = FiberClass.of(c, T, "cpu")
        ptr, rows = fc.own_ptr.numpy(), fc.own_rows.numpy()
        for j in range(fc.m):
            np.testing.assert_array_equal(rows[ptr[j]:ptr[j + 1]],
                                          np.nonzero(c["owner"] == j)[0])


def _draws(classes, seed):
    """Per class, the JAX move's draws from its key schedule: ``u`` in
    [1e-6, 1) and the accept uniforms, ``[C, m]``."""
    key = jax.random.PRNGKey(seed)
    out = []
    for c in classes:
        key, k_u, k_a = jax.random.split(key, 3)
        m = len(c["idx"])
        out.append((jax.random.uniform(k_u, (C, m), F64, minval=1e-6, maxval=1.0),
                    jax.random.uniform(k_a, (C, m), F64)))
    return out


def _distances(h, r, parent):
    d = (h[:, parent] - h) * r
    d[:, 0] = 0.0
    return d


@pytest.mark.parametrize("shape,ladder", [("binary", False), ("binary", True),
                                          ("multi", False)])
def test_fiber_slide_matches_jax(shape, ladder):
    cs = case(shape)
    seed = 11
    plan = TF.fiber_slide_plan(cs.pm)
    js, jterms = cs.jcarry()[:2]
    bp = np.tile(LADDER, C // len(LADDER)) if ladder else np.ones(C)
    # The JAX phase, once per distinct temperature, each rung's chains kept.
    ref = {f: np.zeros_like(np.asarray(getattr(js, f))) for f in ("heights", "rates")}
    ref_terms = np.zeros_like(np.asarray(jterms))
    for beta in sorted(set(bp.tolist())):
        move = jax.jit(cs.jfs._fiber_slide_move(F64, beta))
        jb, jt, _ = move(js, jterms, jax.random.PRNGKey(seed))
        rows = bp == beta
        for f in ref:
            ref[f][rows] = np.asarray(getattr(jb, f))[rows]
        ref_terms[rows] = np.asarray(jt)[rows]

    ps = State(**{f: getattr(cs.ps, f).clone() for f in FIELDS})
    terms = cs.pm.log_prior_terms(ps)
    close(terms, jterms)
    h0, r0 = ps.heights.clone(), ps.rates.clone()
    T = terms.shape[1]
    count = torch.zeros(1, dtype=torch.int32)
    beta_prior = t(bp) if ladder else None
    n_acc = 0
    for c, (u, u_acc) in zip(plan, _draws(plan, seed)):
        cls = FiberClass.of(c, T, "cpu")
        out = fiber_slide(cs.pm, ps, terms, cls, t(u), t(u_acc), beta_prior, count)
        # JAX's accepts: the class's nodes whose height moved.
        idx = c["idx"]
        moved = ref["heights"][:, idx] != h0[:, idx].numpy()
        np.testing.assert_array_equal(out.accept.numpy(), moved)
        n_acc += int(out.accept.sum())
    assert 0 < n_acc < C * sum(len(c["idx"]) for c in plan)
    assert int(count) == n_acc
    close(ps.heights, ref["heights"])
    close(ps.rates, ref["rates"])
    close(terms, ref_terms)
    parent = cs.pm.topo.parent_t
    d0 = _distances(h0, r0, parent)
    d1 = _distances(ps.heights, ps.rates, parent)
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), rtol=0, atol=1e-12)


def test_fiber_phase_in_sweeps():
    """FastSweeps with ``fiber_slide``: one more element of ``sweeps`` (the
    phase's acceptance a sweep, NaN where the coin skipped it), the carried
    terms equal to a fresh evaluation, and with the phase off the sweeps
    bitwise those of a FastSweeps built without the option."""
    cs = Case("none", priors=True, leaves=8)
    fs0 = TF.FastSweeps(cs.pm, cs.ptable)
    fs1 = TF.FastSweeps(cs.pm, cs.ptable, fiber_slide=0.5)
    fs2 = TF.FastSweeps(cs.pm, cs.ptable, fiber_slide=0.0, bold_p=0.0)
    tun = t(cs.tuning)
    out = fs1.sweeps(cs.ps, tun, 6, 8)
    assert len(out) == 7
    acc = out[6].numpy()
    assert acc.shape == (8,) and np.isnan(acc).any() and not np.isnan(acc).all()
    ran = acc[~np.isnan(acc)]
    assert ((ran > 0) & (ran < 1)).all()
    lp = cs.pm.log_prior_terms(out[0]).sum(-1)
    np.testing.assert_allclose(out[1].numpy(), lp.numpy(), rtol=1e-10)
    a, b = fs0.sweeps(cs.ps, tun, 5, 2), fs2.sweeps(cs.ps, tun, 5, 2)
    assert len(b) == 6
    for f in FIELDS:
        assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
