"""The port's global-move family scans (``kernels/glob_step.py``) against
the JAX package's ``_glob_step``, on the CPU at float64, with injected
draws: each of the 14 families' first tickets as one scan, on a calibrated
model with a constraint and a brace, with the full likelihood and with
none.  ``glob_family_plain`` must give identical accept masks and accept
counts, and the state, terms, d, z and q to 1e-10 of scale; the kernel
wrappers on CPU tensors (G1 ``glob_scan``, or G2 and G3 around the product
for the dense families) must equal it exactly and count no launch; and a
replay of its own proposals and decisions (``given``) must equal it
exactly."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcdate_tpu_torch.engine import fast_sweep as TF
from mcmcdate_tpu_torch.kernels import glob_step as G
from torch_fast_common import C, Case, close, t

F64 = jnp.float64
TICKETS = 4  # per family


@functools.lru_cache(maxsize=None)
def case(lik):
    return Case(lik, priors=True)


def _first(grp, n):
    """The family's first ``n`` tickets as a group of their own."""
    return dataclasses.replace(grp, **{f.name: getattr(grp, f.name)[:n]
                                       for f in dataclasses.fields(grp) if f.name != "tag"})


def _carry_tensors(carry):
    b = carry.batch
    return [b.heights, b.rates, b.birth, b.death, b.height, b.rate_mean, b.rate_var,
            carry.terms, carry.d, carry.z, carry.q, carry.acc]


@pytest.mark.parametrize("lik", ("full", "none"))
@pytest.mark.parametrize("tag", TF.GLOB_ORDER)
def test_glob_family_scan_matches_jax(lik, tag):
    cs = case(lik)
    grp = cs.jfs.plan.glob_groups[tag]
    n = min(TICKETS, grp.n_tickets)
    step = cs.jfs._glob_step(tag, F64)
    jc = cs.jcarry()
    key = jax.random.PRNGKey(7 + len(tag))
    draws, u_acc, refs = [], [], []
    for s in range(n):
        key, kt = jax.random.split(key)
        sx = {"sd": jnp.asarray(grp.sd[s], F64), "aux": grp.aux[s], "lo": grp.lo[s],
              "hi": grp.hi[s], "n_inner": grp.n_inner[s], "n_nodes": grp.n_nodes[s],
              "rj": grp.rj[s]}
        tune = jnp.asarray(cs.tuning[:, grp.rows[s]])
        k1, k2 = jax.random.split(kt)
        if tag in TF.GAMMA_TAGS:
            draws.append(jax.random.gamma(k1, sx["sd"] / tune, dtype=F64))
        else:
            draws.append(jax.random.uniform(k1, (C,), F64))
        u_acc.append(jax.random.uniform(k2, (C,), F64))
        jc, ref = step(jc, (sx, kt, tune))
        refs.append(np.asarray(ref))
    js, terms, d, z, q = jc
    draws, u_acc = t(np.stack(draws, 1)), t(np.stack(u_acc, 1))
    ref_acc = np.stack(refs, 1)                                  # [C, n]

    fs = cs.pfs
    fam = G.GlobFamily.of(_first(fs.plan.glob_groups[tag], n), "cpu", torch.float64, fs.glob.pos)
    tun = t(cs.tuning[:, fam.grp.rows])
    port = cs.pcarry()
    out = G.glob_family_plain(fs.glob, fam, port, tun, draws, u_acc)
    np.testing.assert_array_equal(out.accept.numpy(), ref_acc, err_msg=tag)
    for f in ("heights", "rates", "birth", "death", "height", "rate_mean", "rate_var"):
        close(getattr(port.batch, f), getattr(js, f))
    close(port.terms, terms)
    close(port.d, d)
    if fs.use_lik:
        close(port.z, z)
        close(port.q, q)
    acc = np.zeros(port.acc.shape, np.int64)
    for s in range(n):
        acc[:, fam.grp.rows[s]] += ref_acc[:, s]
    np.testing.assert_array_equal(port.acc.numpy(), acc)
    n_acc = int(ref_acc.sum())
    assert n_acc > 0 or tag in ("var_tree", "var_auto")

    # The wrappers on CPU tensors run the plain version and count nothing.
    wrappers = (G.glob_scan, G.glob_dense_prologue, G.glob_dense_epilogue)
    before = [w.launches for w in wrappers]
    wrapped = cs.pcarry()
    if G.FAMILIES[tag].lik == G.DENSE:
        accept = []
        for s in range(n):
            pro = G.glob_dense_prologue(fs.glob, fam, s, wrapped, tun, draws)
            w = fs._x_P(pro.delta) if fs.use_lik else None
            accept.append(G.glob_dense_epilogue(fs.glob, fam, s, wrapped, pro, w, u_acc))
        accept = torch.stack(accept, 1)
    else:
        accept = G.glob_scan(fs.glob, fam, wrapped, tun, draws, u_acc).accept
    assert [w.launches for w in wrappers] == before
    assert torch.equal(accept, out.accept)
    for a, b in zip(_carry_tensors(wrapped), _carry_tensors(port)):
        assert torch.equal(a, b)

    # Replaying the scan's own proposals and decisions gives its state.
    replay = cs.pcarry()
    forced = torch.where(out.accept, 0.0, math.nan).to(torch.float64)
    rep = G.glob_family_plain(fs.glob, fam, replay, tun, draws, forced,
                              given=dict(prop=out.prop, mean=out.mean))
    assert torch.equal(rep.accept, out.accept)
    assert torch.equal(rep.prop, out.prop)
    for a, b in zip(_carry_tensors(replay), _carry_tensors(port)):
        assert torch.equal(a, b)
