"""The port's MC3 swap move (``engine/mc3.py``'s ``make_swap_fn`` over M1's
plain version, ``kernels/mc3_swap.py``) against the JAX package's
``make_swap_fn`` on the CPU at float64, on JAX's own key schedule: the
swap's keys split into ``N_SWAPS`` draws, each a ``randint`` pair and a
``uniform`` (``mcmcdate_tpu/engine/mc3.py:55-62``), handed to the port with
the JAX model's untempered log posteriors.  The permuted batch must be
identical, and so must every draw's decision (read from the JAX scan's
outputs), the per-pair counts and the mean swap rate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcdate_tpu.engine import mc3 as jmc3
from mcmcdate_tpu_torch.engine import mc3 as tmc3
from mcmcdate_tpu_torch.kernels.mc3_swap import mc3_swap_plain
from mcmcdate_tpu_torch.models.state import FIELDS, State
from torch_fast_common import C, Case

F64 = jnp.float64
T = tmc3.N_TEMPS
G = C // T


def _jax_draws(key):
    """The draws the JAX swap takes from ``key``: ``pair`` and ``u`` ``[N_SWAPS,
    G]``."""
    pairs, us = [], []
    for ks in jax.random.split(key, tmc3.N_SWAPS):
        k_pair, k_acc = jax.random.split(ks)
        pairs.append(np.asarray(jax.random.randint(k_pair, (G,), 0, T - 1)))
        us.append(np.asarray(jax.random.uniform(k_acc, (G,), dtype=F64)))
    return np.stack(pairs), np.stack(us)


def _jax_swap(swap, batch, key, betas, monkeypatch):
    """The JAX swap run eagerly, with its scan's outputs (each draw's
    decision and the per-pair counts) recorded."""
    seen = {}
    real = jax.lax.scan

    def recorded(*a, **kw):
        out = real(*a, **kw)
        seen["ys"] = out[1]
        return out

    monkeypatch.setattr(jax.lax, "scan", recorded)
    with jax.disable_jit():
        out = swap(batch, key, betas)
    monkeypatch.setattr(jax.lax, "scan", real)
    return out, np.asarray(seen["ys"][0])


@pytest.mark.parametrize("dt", (0.5, 2.0))
def test_swap_matches_jax_make_swap_fn(dt, monkeypatch):
    cs = Case("full", priors=True)
    js = cs.jstate()
    U = np.asarray(jax.vmap(cs.jm.log_posterior)(js))
    assert np.isfinite(U).all() and np.ptp(U) > 1.0
    betas = tmc3.temperature_ladder(T, dt)
    jswap = jmc3.make_swap_fn(cs.jm, G, T, F64)
    pswap = tmc3.make_swap_fn(G, T)
    n_acc = n = 0
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        (jb, jrate, jacc, jtot), jaccepts = _jax_swap(jswap, js, key, jnp.asarray(betas),
                                                      monkeypatch)
        pair, u = _jax_draws(key)
        batch = State(**{k: torch.as_tensor(np.array(v)) for k, v in cs.state.items()})
        Ut = torch.as_tensor(U.copy())
        pb, accept, pa, pt = pswap(batch, Ut, torch.as_tensor(pair.astype(np.int32)),
                                   torch.as_tensor(u), torch.as_tensor(betas))
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(pb, f).numpy(), np.asarray(getattr(jb, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(accept.numpy(), jaccepts)
        assert float(accept.double().mean()) == float(jrate)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(jacc))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jtot))
        # U moves with its state: each slot's U is its new state's.
        np.testing.assert_array_equal(
            Ut.numpy(), np.asarray(jax.vmap(cs.jm.log_posterior)(jb)))
        n_acc += int(accept.sum())
        n += accept.numel()
    assert 0 < n_acc < n


def test_swap_draws_and_counts():
    """``swap_draws`` gives int32 pairs in ``[0, T - 1)`` and uniforms; the
    plain version's counts add up to its decisions, the identity
    permutation leaves the batch as it was, and a group whose draws all
    accept swaps its states."""
    gen = torch.Generator().manual_seed(4)
    pair, u = tmc3.swap_draws(gen, 50, dtype=torch.float64)
    assert pair.dtype == torch.int32 and pair.shape == (tmc3.N_SWAPS, 50)
    assert int(pair.min()) == 0 and int(pair.max()) == T - 2
    assert 0 < float(u.min()) and float(u.max()) < 1
    rng = np.random.default_rng(1)
    state = {f: rng.normal(size=(8, 5) if f in ("heights", "rates") else 8) for f in FIELDS}
    betas = torch.as_tensor(tmc3.temperature_ladder(T, 0.3))
    # Never accepted (u = 1), then always accepted (u -> 0).
    for u_val in (1.0, 1e-300):
        batch = State(**{f: torch.as_tensor(v.copy()) for f, v in state.items()})
        U = torch.zeros(8, dtype=torch.float64)
        pair = torch.as_tensor([[0, 2], [1, 1], [2, 0]], dtype=torch.int32)
        acc, pa, pt = mc3_swap_plain(batch, U, pair, torch.full((3, 2), u_val,
                                                                dtype=torch.float64), betas)
        assert int(pt.sum()) == 6 and int(pa.sum()) == int(acc.sum())
        if u_val == 1.0:
            assert not acc.any()
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(batch, f).numpy(), state[f])
        else:
            assert acc.all()
            # group 0: swaps (0,1), (1,2), (2,3): slot k holds old k + 1, the
            # last the old slot 0; group 1: (2,3), (1,2), (0,1) rotates the
            # other way.
            h = state["heights"]
            np.testing.assert_array_equal(batch.heights[:4].numpy(), h[[1, 2, 3, 0]])
            np.testing.assert_array_equal(batch.heights[4:].numpy(), h[4:][[3, 0, 1, 2]])
