"""The port's batched NUTS trajectory (``engine/hmc.py:nuts_kernel``, the
plain versions of H1, H2 and H3 on the CPU) and its in-cycle move against
the JAX package's ``nuts_kernel`` vmapped over the chains and its
``make_in_cycle_move``, at float64, with the port's random numbers drawn by
``jax.random`` on the JAX key schedule: ``k_mom, k_loop = split(key)``; per
doubling ``key, k_dir = split(key)``, per leaf ``key_s, k_g =
split(key_s)`` (done chains too), then ``key, k_m = split(key)``.

Step counts must be identical; ``q'`` and the acceptance statistic agree
within 1e-10 of their scale at max_depth 4.  At ``MAX_DEPTH`` a trajectory
runs up to 255 steps, and the two packages sum the energies and dot
products in other orders: rounding differences of 1e-15 of a step grow
along the trajectory, so those checks allow 1e-8."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcdate_tpu.engine import hmc as jhmc
from mcmcdate_tpu_torch.engine import hmc
from test_torch_hmc import C, fix
from torch_fast_common import close

EPS = {"full": 0.05, "uni": 0.05, "none": 0.3}


def schedule(keys, dim: int, max_depth: int):
    """The draws the JAX ``nuts_kernel`` takes from each chain's key, as a
    :class:`~mcmcdate_tpu_torch.engine.hmc.NutsReplay`."""
    n_leaf = 2 ** (max_depth - 1)

    def one(key):
        k_mom, key = jax.random.split(key)
        normals = jax.random.normal(k_mom, (dim,), jnp.float64)
        dirs, leaves, merges = [], [], []
        for k in range(max_depth):
            key, k_dir = jax.random.split(key)
            dirs.append(jax.random.bernoulli(k_dir))
            def leaf(kk, _):
                kk, k_g = jax.random.split(kk)
                return kk, jax.random.uniform(k_g, dtype=jnp.float64)

            key, us = jax.lax.scan(leaf, key, None, length=2 ** k)
            leaves.append(jnp.pad(us, (0, n_leaf - 2 ** k), constant_values=0.5))
            key, k_m = jax.random.split(key)
            merges.append(jax.random.uniform(k_m, dtype=jnp.float64))
        return normals, jnp.stack(dirs), jnp.stack(leaves), jnp.stack(merges)

    out = jax.jit(jax.vmap(one))(keys)
    return hmc.NutsReplay(*(torch.as_tensor(np.array(x)) for x in out))


def inv_mass_of(f):
    """A diagonal inverse mass near the chains' scale (``[dim]``)."""
    q = f.q0().numpy()
    return np.maximum(np.var(q, axis=0), 1e-3 * np.abs(q).mean(axis=0) ** 2) + 1e-4


@functools.lru_cache(maxsize=None)
def jax_nuts(kind: str, max_depth: int):
    """The JAX trajectories of the fixture's chains (one target, the first
    chain's fixed coordinates, as ``nuts_kernel`` takes one template)."""
    f = fix(kind, critical=False)
    im = inv_mass_of(f)
    template = jax.tree.map(lambda x: x[0], f.jstate())
    step = jhmc.nuts_kernel(jhmc.make_log_density(f.jm, f.jcoords, template), max_depth)
    keys = jax.random.split(jax.random.PRNGKey(7), C)
    q, a, n = jax.jit(jax.vmap(step, in_axes=(0, 0, None, None)))(
        keys, jnp.asarray(f.q0().numpy()), EPS[kind], jnp.asarray(im))
    return f, im, keys, np.asarray(q), np.asarray(a), np.asarray(n)


@pytest.mark.parametrize("kind,max_depth,tol", [
    ("full", 4, 1e-10), ("uni", 4, 1e-10), ("none", 4, 1e-10),
    ("full", hmc.MAX_DEPTH, 1e-8)])
def test_trajectory_matches_jax(kind, max_depth, tol):
    f, im, keys, jq, ja, jn = jax_nuts(kind, max_depth)
    state = type(f.ps)(**{k: getattr(f.ps, k)[:1].expand_as(getattr(f.ps, k)).contiguous()
                          for k in f.state})
    draws = schedule(keys, f.coords.dim, max_depth)
    step = hmc.nuts_kernel(f.pm, max_depth)
    q, a, n = step(state, f.q0(), EPS[kind], torch.as_tensor(im), draws)
    np.testing.assert_array_equal(n.numpy(), jn)
    # Trajectories of several lengths, some ended by a U-turn.
    assert len(set(jn.tolist())) > 1 and jn.min() > 0
    close(q, jq, tol)
    close(a, ja, tol)


def test_in_cycle_move_matches_jax():
    """``make_in_cycle_move`` with its ``split(key, C)``, per-chain β_lik
    and β_prior and each chain's own fixed coordinates."""
    f = fix("full", priors=True, critical=False)
    im = inv_mass_of(f)
    bl = np.linspace(0.2, 1.0, C)
    bp = np.linspace(1.0, 0.6, C)
    key = jax.random.PRNGKey(3)
    move, _ = jhmc.make_in_cycle_move(f.jm, 4)
    jb, ja = jax.jit(move)(f.jstate(), key, EPS["full"], jnp.asarray(im), jnp.asarray(bl),
                           jnp.asarray(bp))
    pmove, coords = hmc.make_in_cycle_move(f.pm, 4)
    batch = type(f.ps)(**{k: getattr(f.ps, k).clone() for k in f.state})
    draws = schedule(jax.random.split(key, C), coords.dim, 4)
    a = pmove(batch, None, EPS["full"], torch.as_tensor(im), torch.as_tensor(bl),
              torch.as_tensor(bp), draws=draws)
    close(a, ja)
    for k in f.state:
        close(getattr(batch, k), getattr(jb, k))
    moved = np.abs(batch.heights.numpy() - f.state["heights"]).max(axis=1)
    assert (moved > 0).sum() >= C // 2
