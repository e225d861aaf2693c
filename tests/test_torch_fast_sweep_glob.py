"""The PyTorch port's global-move families of FastSweeps against the JAX
package's ``_glob_step``, on the CPU at float64, with injected draws: the
first tickets of each of the 14 families, on a calibrated model with a
constraint and a brace, with the full likelihood and with none (a
univariate likelihood takes the full code with a diagonal precision in
both packages).  Accept masks must be identical, and the state, terms, d,
z and q equal to 1e-10 of scale."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmcdate_tpu_torch.engine import fast_sweep as TF
from torch_fast_common import C, Case, close, t

F64 = jnp.float64
TICKETS = 2  # per family


@functools.lru_cache(maxsize=None)
def case(lik):
    return Case(lik, priors=True)


@pytest.mark.parametrize("lik", ("full", "none"))
@pytest.mark.parametrize("tag", TF.GLOB_ORDER)
def test_glob_family_matches_jax(lik, tag):
    cs = case(lik)
    grp = cs.jfs.plan.glob_groups[tag]
    pgrp = cs.pfs.plan.glob_groups[tag]
    step = cs.jfs._glob_step(tag, F64)
    js, terms, d, z, q = cs.jcarry()
    port = cs.pcarry()
    key = jax.random.PRNGKey(len(tag))
    n_acc = 0
    for s in range(min(TICKETS, grp.n_tickets)):
        key, kt = jax.random.split(key)
        sx = {"sd": jnp.asarray(grp.sd[s], F64), "aux": grp.aux[s], "lo": grp.lo[s],
              "hi": grp.hi[s], "n_inner": grp.n_inner[s], "n_nodes": grp.n_nodes[s],
              "rj": grp.rj[s]}
        tune = jnp.asarray(cs.tuning[:, grp.rows[s]])
        k1, k2 = jax.random.split(kt)
        if tag in TF.GAMMA_TAGS:
            draw = jax.random.gamma(k1, sx["sd"] / tune, dtype=F64)
        else:
            draw = jax.random.uniform(k1, (C,), F64)
        u_acc = jax.random.uniform(k2, (C,), F64)
        (js, terms, d, z, q), ref = step((js, terms, d, z, q), (sx, kt, tune))
        psx = dict(sd=pgrp.sd[s], aux=pgrp.aux[s], lo=pgrp.lo[s], hi=pgrp.hi[s],
                   n_inner=pgrp.n_inner[s], n_nodes=pgrp.n_nodes[s], rj=bool(pgrp.rj[s]))
        accept = cs.pfs.glob_step(tag, port, t(tune), psx, t(draw), t(u_acc))
        np.testing.assert_array_equal(accept.numpy(), np.asarray(ref), err_msg=tag)
        n_acc += int(accept.sum())
        for f in ("heights", "rates", "birth", "death", "height", "rate_mean", "rate_var"):
            close(getattr(port.batch, f), getattr(js, f))
        close(port.terms, terms)
        close(port.d, d)
        if cs.pfs.use_lik:
            close(port.z, z)
            close(port.q, q)
    assert 0 < n_acc < C * min(TICKETS, grp.n_tickets) or tag in ("var_tree", "var_auto")
