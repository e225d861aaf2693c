"""What G3 ``glob_dense_epilogue`` reads of a subtree ticket: its support
rows.  On the card G3 forms a sub_ultra or sub_rate ticket's ``dq`` from
``delta_S`` and the rows ``GlobFamily.srow`` names (bound when FastSweeps
is built), and writes ``d`` back on those rows only.  On the CPU at
float64, on a 16-leaf calibrated model (both root-adjacent subtrees among
the tickets) with 16 chains:

- for every ticket, the rows ``srow`` gives are ``GlobConsts.support`` of
  its subtree and exactly the rows where ``delta`` or ``d_new - d`` is not
  zero;
- ``dq`` over those rows equals the plain epilogue's full-D ``dq`` within
  1e-12 of its scale, with the same decisions;
- the whole family, every ticket in order, through the wrappers' CPU path
  matches the JAX ``_glob_step`` stepped over the same keys from the same
  carry."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcdate_tpu_torch.kernels import glob_step as G
from torch_fast_common import C, Case, close, close_carry, jcarry_of, keyed_glob_draws, \
    run_glob_jax, run_glob_port, support_rows, t

TAGS = ("sub_ultra", "sub_rate")


@functools.lru_cache(maxsize=None)
def case():
    return Case("full", priors=True, leaves=16)


@pytest.mark.parametrize("tag", TAGS)
def test_support_rows_and_dq(tag):
    cs = case()
    fs = cs.pfs
    fam = fs.glob_fam[tag]
    root_ch = set(fs.glob.child_list)
    assert {int(lo) for lo in fam.grp.lo} >= root_ch  # both root-adjacent subtrees
    carry = cs.pcarry()
    keyed = keyed_glob_draws(cs, fam.grp, tag, seed=41 + len(tag))
    tun = t(cs.tuning[:, fam.grp.rows])
    draws = t(np.stack([np.asarray(k[2]) for k in keyed], 1))
    u_acc = t(np.stack([np.asarray(k[3]) for k in keyed], 1))
    D = carry.d.shape[1]
    n_acc = 0
    for s in range(fam.n):
        lo, hi = int(fam.grp.lo[s]), int(fam.grp.hi[s])
        rows = support_rows(fam, s)
        np.testing.assert_array_equal(rows, fs.glob.support(lo, hi))
        pro = G.glob_dense_prologue(fs.glob, fam, s, carry, tun, draws)
        moved = ((pro.delta != 0) | (pro.d_new != carry.d)).any(0).numpy()
        np.testing.assert_array_equal(np.nonzero(moved)[0], rows)
        assert rows.max() < D
        w = fs.glob_product(fam, s, pro)
        z, q = carry.z.clone(), carry.q.clone()
        dq_full = torch.sum(pro.delta * (2.0 * z + w), dim=-1)
        dq_rows = torch.sum(pro.delta_s * (2.0 * z[:, rows] + w[:, rows]), dim=-1)
        close(dq_rows, dq_full.numpy(), tol=1e-12)
        accept = G.glob_dense_epilogue(fs.glob, fam, s, carry, pro, w, u_acc)
        la = pro.d_pr - 0.5 * dq_rows + pro.lmhg + pro.lj
        la = torch.where(pro.invalid | torch.isnan(la), -torch.inf, la)
        assert torch.equal(torch.log(u_acc[:, s]) < la, accept)
        close(carry.q, torch.where(accept, q + dq_rows, q).numpy(), tol=1e-12)
        n_acc += int(accept.sum())
    assert 0 < n_acc < C * fam.n


@functools.lru_cache(maxsize=None)
def _jax_step(tag):
    return jax.jit(case().jfs._glob_step(tag, jnp.float64))


@pytest.mark.parametrize("tag", TAGS)
def test_whole_family_matches_jax(tag):
    cs = case()
    fam = cs.pfs.glob_fam[tag]
    keyed = keyed_glob_draws(cs, fam.grp, tag, seed=7 + len(tag))
    port = cs.pcarry()
    jc, ref = run_glob_jax(_jax_step(tag), fam.grp, keyed, jcarry_of(port))
    accept = run_glob_port(cs, tag, fam, keyed, port)
    np.testing.assert_array_equal(accept, ref)
    assert 0 < int(ref.sum()) < ref.size
    close_carry(port, jc, True)
