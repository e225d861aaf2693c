"""The banded likelihood kind in the PyTorch port's sweeps, on the CPU at
float64: the sequential sweep's tickets (T1, B1's plain version, K3)
against the JAX ``MHKernel`` with injected draws; FastSweeps on the banded
model against the port's own FastSweeps on its densified full twin with the
same draws (the JAX FastSweeps has faults the port repaired, ROADMAP Queue
3); the carried log posterior against a fresh evaluation; no ``[D, D]`` or
``[rows, D]`` tensor in a banded FastSweeps; and ``prepare "banded W"`` ->
``run`` -> ``continue`` -> ``analyze`` and ``marginal-likelihood`` through
the CLI.  The port's block size is cut to ``WB`` so that the products'
windows of output blocks are live at 10 and 12 leaves."""

import math
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcmcdate_tpu.engine import mh as jmh, proposals as JP
from mcmcdate_tpu.models import DatingModel as JModel, init_state as j_init
from mcmcdate_tpu.models.state import State as JState
from mcmcdate_tpu.ops import heights as JH, mvn as jmvn
from mcmcdate_tpu.tree import FlatTopology
from mcmcdate_tpu.utils.simulate import random_ultrametric_tree
from mcmcdate_tpu_torch import cli
from mcmcdate_tpu_torch.engine import chains as TC, fast_sweep as TF, mh as TM, proposals as TP
from mcmcdate_tpu_torch.engine import stepping_stone as SS
from mcmcdate_tpu_torch.kernels.ticket_step import ticket_prologue_plain
from mcmcdate_tpu_torch.models import from_numpy
from mcmcdate_tpu_torch.models.state import FIELDS
from mcmcdate_tpu_torch.ops import banded as tb, mvn as tmvn

from torch_fast_common import node_priors

WB = 8  # the port's block size here (the JAX package's is 128)
W = 5   # bandwidth
C = 12


def close(port, ref, tol=1e-10):
    """Equal to ``tol`` relative to the reference's scale (finite entries),
    with identical non-finite entries."""
    port = np.asarray(port.numpy() if isinstance(port, torch.Tensor) else port)
    ref = np.asarray(ref.numpy() if isinstance(ref, torch.Tensor) else ref)
    np.testing.assert_array_equal(np.isfinite(port), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(port[~fin], ref[~fin])
    scale = max(1.0, float(np.abs(ref[fin]).max(initial=0.0)))
    np.testing.assert_allclose(port[fin], ref[fin], rtol=0, atol=tol * scale)


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(tb, "default_block_size", lambda w: max(w, WB))


def banded_data(topo, d0, rng):
    """A banded likelihood estimated from samples around ``d0``, correlated
    along the internal layout; ``(mu, band, log_det, perm)``."""
    k = topo.n - 2
    perm = topo.ref_to_internal_perm
    mu_int = np.asarray(d0)[perm] * rng.uniform(0.9, 1.1, k)
    e = rng.normal(size=(80, k + 2))
    xs = mu_int + 0.03 * (e[:, :k] + 0.5 * e[:, 1:k + 1] + 0.25 * e[:, 2:k + 2])
    _, band, log_det = tb.estimate_banded_chol(xs, W)
    mu = np.empty(k)
    mu[perm] = mu_int
    return mu, band, log_det, perm


def dense_twin(data: tmvn.LikelihoodData) -> tmvn.LikelihoodData:
    """The full likelihood of the same precision, densified from the band."""
    pband = tb.pband_from_chol_upper(data.band_chol)
    D = pband.shape[0]
    P = np.zeros((D, D))
    for s in range(pband.shape[1]):
        P[np.arange(D - s), np.arange(s, D)] = pband[:D - s, s]
        P[np.arange(s, D), np.arange(D - s)] = pband[:D - s, s]
    inv = np.argsort(data.band_perm)
    return tmvn.LikelihoodData.full(data.mu, P[np.ix_(inv, inv)], data.log_det_sigma)


# ---------------------------------------------------------------------------
# The sequential sweep against the JAX MHKernel
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mh_case():
    rng = np.random.default_rng(21)
    t = random_ultrametric_tree(rng, 10)
    topo = FlatTopology.from_tree(t)
    s0 = j_init(t, topo)
    mu, band, log_det, perm = banded_data(topo, JH.distances_from_state(s0, topo), rng)
    cal, con, br = node_priors(topo)
    jm = JModel(topo=topo, likelihood=jmvn.LikelihoodData.banded(mu, band, log_det, perm),
                calibrations=cal, braces=br, mean_root_height=1.2)
    table = JP.build_proposal_table(topo, br, True)
    h = np.asarray(s0.heights)[None].repeat(C, 0) * rng.uniform(0.95, 1.0, size=(C, 1))
    h[:, 0] = 1.0
    h[:, topo.is_leaf] = 0.0
    state = dict(heights=h, rates=rng.gamma(20.0, 0.05, size=(C, topo.n)),
                 birth=rng.uniform(0.5, 2, C), death=rng.uniform(0.1, 1, C),
                 height=rng.uniform(1.0, 1.4, C), rate_mean=rng.uniform(0.8, 1.2, C),
                 rate_var=rng.uniform(0.05, 0.5, C))
    tuning = rng.uniform(0.3, 3.0, size=(C, table.n_proposals))
    return topo, cal, br, jm, table, state, tuning, (mu, band, log_det, perm)


def _port_mh(mh_case):
    topo, cal, br, _, _, state, _, (mu, band, log_det, perm) = mh_case
    pm, ps = from_numpy(topo, tmvn.LikelihoodData.banded(mu, band, log_det, perm), state,
                        calibrations=cal, braces=br, mean_root_height=1.2, device="cpu")
    return pm, ps, TM.MHKernel(pm, TP.build_proposal_table(pm.topo, pm.braces, True))


def _draws(table, pidx, keys, tuning):
    kind = int(table.kind[pidx])
    if kind in TP.GAMMA_KINDS:
        k = float(table.par[pidx]) / jnp.asarray(tuning[:, pidx])
        return jax.vmap(lambda kk, a: jax.random.gamma(kk, a, dtype=jnp.float64))(keys, k)
    return jax.vmap(lambda kk: jax.random.uniform(kk, dtype=jnp.float64))(keys)


def _rows_per_kind(table):
    rows = {}
    for p, kind in enumerate(table.kind):
        key = (int(kind), int(table.aux[p])) if kind == JP.K_SCALE_SCALAR else int(kind)
        rows.setdefault(key, p)
        rows.setdefault(("dc", int(table.d_class[p]), int(table.kind[p])), p)
    return sorted(set(rows.values()))


def test_mh_banded_tickets_match_jax(mh_case):
    """One ticket per proposal kind and likelihood class through T1, B1 and
    K3's plain versions (the port) and the JAX ``_ticket_step`` with the
    same draws: identical accepts; terms, d and y within 1e-10."""
    topo, cal, br, jm, table, state, tuning, _ = mh_case
    pm, ps, tk = _port_mh(mh_case)
    assert tk.tt.banded and pm.band_L3_internal.shape[0] > 2  # live windows
    js = JState(**{k: jnp.asarray(v) for k, v in state.items()})
    step = jax.jit(jmh.MHKernel(jm, table)._ticket_step(JP.make_kernel_switch(topo, br), 1.0,
                                                         jnp.float64))
    terms = jax.vmap(jm.log_prior_terms)(js)
    y = jax.vmap(jm.whitened_residual_internal)(js)
    d = jax.vmap(lambda s: JH.distances_internal(s, topo))(js)
    close(pm.whitened_residual_internal(ps), y)
    acc = jnp.zeros((C, table.n_proposals), jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    tuning_t = torch.as_tensor(tuning)
    n_accepts = 0
    rows = _rows_per_kind(table)
    for p in rows:
        out, _ = step((js, terms, d, y, jnp.asarray(tuning), acc, keys), jnp.int32(p))
        j_batch, j_terms, j_d, j_y, _, j_acc, _ = out
        keys2 = jax.vmap(lambda kk: jax.random.split(kk, 3))(keys)
        draw = torch.as_tensor(np.asarray(_draws(table, p, keys2[:, 1], tuning)))
        u = torch.as_tensor(np.asarray(
            jax.vmap(lambda kk: jax.random.uniform(kk, dtype=jnp.float64))(keys2[:, 2])))
        carry = tk.init_carry(ps)
        accept = tk.ticket_step(carry, tuning_t, p, draw, u)
        np.testing.assert_array_equal(accept.numpy(), np.asarray(j_acc[:, p]) == 1,
                                      err_msg=table.names[p])
        n_accepts += int(accept.sum())
        close(carry.terms, j_terms)
        close(carry.d, j_d)
        close(carry.y, j_y)
        for f in FIELDS:
            close(getattr(carry.batch, f), getattr(j_batch, f))
    assert 0 < n_accepts < C * len(rows)


def test_mh_banded_windows_hold_every_delta(mh_case):
    """Every table row's distance delta is zero outside the span of rows its
    class can move (``TicketTable.band_rows``) but for rounding, and B1
    over its window, reading delta on the span, is the whole product of
    delta on the span."""
    _, _, _, _, table, _, tuning, _ = mh_case
    pm, ps, tk = _port_mh(mh_case)
    carry = tk.init_carry(ps)
    rng = np.random.default_rng(9)
    tuning_t = torch.as_tensor(tuning)
    L3 = pm.band_L3_internal_t
    windows = 0
    for p in range(table.n_proposals):
        if int(tk.tt.d_class[p]) == TP.DC_INV:
            continue
        draw = torch.as_tensor(rng.uniform(0.05, 0.95, C))
        if int(table.kind[p]) in TP.GAMMA_KINDS:
            draw = torch.as_tensor(rng.gamma(2.0, 1.0, C))
        pro = ticket_prologue_plain(tk.tt, carry, tuning_t, p, draw)
        lo, hi = tk.tt.band_rows[p]
        inside = torch.zeros(pro.delta.shape[1], dtype=torch.bool)
        inside[lo:hi] = True
        assert float(torch.where(inside, 0.0, pro.delta).abs().max()) <= 1e-14, table.names[p]
        np.testing.assert_array_equal(tk.tt.rows(p).numpy(), np.arange(lo, hi))
        full = tb.block_tridiag_matmul(torch.where(inside, pro.delta, 0.0), L3)
        win = tb.block_tridiag_matmul(pro.delta, L3, window=tk.band_win[p], upper=True,
                                      x_rows=(lo, hi))
        close(win, full, tol=1e-15)
        windows += tk.band_win[p] != (0, L3.shape[0])
    assert windows > 0


# ---------------------------------------------------------------------------
# FastSweeps against the port's FastSweeps on the densified full twin
# ---------------------------------------------------------------------------


def _fast_models(seed=3, leaves=12, chains=16):
    rng = np.random.default_rng(seed)
    t = random_ultrametric_tree(rng, leaves)
    topo = FlatTopology.from_tree(t)
    s0 = j_init(t, topo)
    mu, band, log_det, perm = banded_data(topo, JH.distances_from_state(s0, topo), rng)
    data = tmvn.LikelihoodData.banded(mu, band, log_det, perm)
    cal, con, br = node_priors(topo)
    h = np.asarray(s0.heights)[None].repeat(chains, 0) * rng.uniform(0.9, 1.0, size=(chains, 1))
    h[:, 0] = 1.0
    h[:, topo.is_leaf] = 0.0
    state = dict(heights=h, rates=rng.gamma(20.0, 0.05, size=(chains, topo.n)),
                 birth=rng.uniform(0.5, 2, chains), death=rng.uniform(0.1, 1, chains),
                 height=rng.uniform(1.0, 1.4, chains), rate_mean=rng.uniform(0.8, 1.2, chains),
                 rate_var=rng.uniform(0.05, 0.5, chains))
    out = []
    for lik in (data, dense_twin(data)):
        pm, ps = from_numpy(topo, lik, state, calibrations=cal, constraints=con, braces=br,
                            mean_root_height=1.2, device="cpu")
        table = TP.build_proposal_table(pm.topo, pm.braces, True)
        out.append((pm, ps, TF.FastSweeps(pm, table)))
    tuning = torch.as_tensor(rng.uniform(0.3, 3.0, size=(chains, table.n_proposals)))
    return out[0], out[1], tuning


@pytest.fixture(scope="module")
def fast_case():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tb, "default_block_size", lambda w: max(w, WB))
        return _fast_models()


def _sweep(fs, pm, ps, tuning, seed, n):
    """``n`` sweeps with the generators of ``seed``; per sweep the accept
    counts, the state and the carried terms, d, z and q."""
    host_gen = torch.Generator().manual_seed(seed)
    gen = torch.Generator().manual_seed(seed)
    carry = fs.init_carry(ps)
    y = pm.whitened_residual_internal(carry.batch)
    out = []
    for _ in range(n):
        y = fs.sweep_once(carry, y, tuning, host_gen, gen)
        out.append(dict(acc=carry.acc.clone(), terms=carry.terms.clone(), d=carry.d.clone(),
                        z=carry.z.clone(), q=carry.q.clone(), yy=(y * y).sum(-1),
                        **{f: getattr(carry.batch, f).clone() for f in FIELDS}))
    return out


def test_fast_banded_matches_dense_twin(fast_case):
    """The same draws through FastSweeps on the banded model and on its
    densified full twin: identical accepts in every phase; terms, d, z, q
    and the state within 1e-10 after each of two sweeps."""
    (bm, bs, bfs), (fm, fs_, ffs), tuning = fast_case
    assert bfs.banded and not ffs.banded and bfs.nb > 2
    assert bfs.seq_kern.tt.banded and len(bfs.plan.seq_table.tickets) > 0
    got = _sweep(bfs, bm, bs, tuning, 5, 2)
    want = _sweep(ffs, fm, fs_, tuning, 5, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["acc"].numpy(), w["acc"].numpy())
        for k in ("terms", "d", "z", "q", "yy", *FIELDS):
            close(g[k], w[k])
    acc = got[-1]["acc"].numpy()
    assert 0 < acc.sum() < 2 * C * len(bfs.table.tickets)


def test_fast_banded_carry_is_exact(fast_case):
    """After three sweeps the carried log prior and log likelihood equal a
    fresh evaluation of the final state (1e-10)."""
    (bm, bs, bfs), _, tuning = fast_case
    batch, lp_pr, lp_lik, *_ = bfs.sweeps(bs, tuning, 11, 3)
    close(lp_lik, bm.log_likelihood(batch))
    close(lp_pr, bm.log_prior(batch))


def _tensors(obj, seen=None):
    """Every tensor reachable from ``obj`` through the port's objects,
    dicts, lists and tuples."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v, seen)
    elif type(obj).__module__.startswith("mcmcdate_tpu_torch"):
        yield from _tensors(vars(obj) if hasattr(obj, "__dict__") else {}, seen)


def test_fast_banded_holds_no_dense_precision(fast_case):
    """No tensor of a banded FastSweeps (its model, plan steps, glob
    constants and sequential kernel included) has D columns on other rows
    than a chain batch's (``[D, D]``, ``[rows, D]``); its dense twin has
    such tensors."""
    (bm, bs, bfs), (_, _, ffs), tuning = fast_case
    D = bm.likelihood.dim
    bfs.sweeps(bs, tuning, 2, 1)

    def dense(fs):
        return [tuple(t.shape) for t in _tensors(fs)
                if t.dim() >= 2 and t.shape[-1] == D and t.shape[-2] != bs.n_chains]

    assert dense(ffs)
    assert dense(bfs) == []


# ---------------------------------------------------------------------------
# The CLI on banded data
# ---------------------------------------------------------------------------


def test_cli_banded_workflow(tmp_path, monkeypatch):
    """``prepare "banded 4"`` -> ``run`` (FastSweeps) -> ``continue`` ->
    ``analyze``, and ``marginal-likelihood --profile``, on the CPU with the
    schedules cut: the run's carried log posterior equals a fresh one and
    log Z is finite."""
    monkeypatch.setattr(TC, "CHUNK", 2)
    monkeypatch.setattr(TM, "BURN_IN_PROF_FAST", [2])
    monkeypatch.setattr(TM, "BURN_IN_PROF_SLOW", [])
    monkeypatch.setattr(SS, "REPETITIVE_BURN_IN_PROF", TM.BurnInSettings([2], []))
    monkeypatch.setattr(SS, "CASCADE_SWEEPS", 1)
    d = str(tmp_path)
    cli.main(["simulate", "--leaves", "8", "--trees", "120", "--seed", "5", "--out",
              os.path.join(d, "data")])
    res = cli.main(["prepare", "-a", "b", "--rooted-tree", os.path.join(d, "data", "time.tree"),
                    "--trees", os.path.join(d, "data", "trees.nwk"), "--likelihood-spec",
                    "banded 4", "--out-dir", d])
    assert res.data.kind == tmvn.BANDED and res.data.bandwidth == 4
    runner = cli.main(["run", "-a", "b", "--device", "cpu", "--chains", "4", "--profile",
                       "--iterations", "4", "--seed", "1", "--out-dir", d])
    assert isinstance(runner.kern, TF.FastSweeps) and runner.kern.banded
    cli.main(["continue", "-a", "b", "--device", "cpu", "--profile", "--iterations", "2",
              "--seed", "2", "--out-dir", d])
    cli.main(["analyze", "-a", "b", "--out-dir", d])
    assert os.path.getsize(os.path.join(d, "b.timetree.ages.summary")) > 0
    ml = cli.main(["marginal-likelihood", "-a", "b", "--device", "cpu", "--profile",
                   "--iterations", "2", "--seed", "1", "--out-dir", d])
    assert math.isfinite(ml.log_marginal_likelihood)
