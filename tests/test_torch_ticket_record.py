"""The ticket kernels' packed records (``TicketTable.rec``) and the
univariate kind's subtree rows (``DC_RANGE``: row 0 and the subtree's own
rows, whatever the subtree's size), on the CPU at float64.

Every row's record must decode to the table's columns and index sets, as
the kernels read them (inline, or from the CSR arrays).  With every subtree
move's row given the whole-D class (``DC_FULL``, as the proposal table
gives a subtree above 1,024 distances: the threshold lowered to 0 for this
14-leaf tree), ``ticket_scan_plain`` and ``MHKernel.sweep_once(given=)``,
which evaluate such a row on its own rows, must match the JAX package's
``_ticket_step``, which evaluates all D, over the same order and injected
draws: identical accept masks, terms, d, y and state within 1e-10.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcmcdate_tpu.engine import mh as jmh, proposals as JP
from mcmcdate_tpu.models import DatingModel as JModel, init_state as j_init
from mcmcdate_tpu.models.state import State as JState
from mcmcdate_tpu.ops import heights as JH, mvn as jmvn, node_priors as jnp_
from mcmcdate_tpu.tree import FlatTopology
from mcmcdate_tpu.utils.simulate import random_ultrametric_tree
from mcmcdate_tpu_torch.engine import mh as tmh, proposals as TP
from mcmcdate_tpu_torch.kernels import ticket_step as TS
from mcmcdate_tpu_torch.models import from_numpy
from test_torch_ticket_step import _agree, _scan_draws

C = 16
N_TICKETS = 48
SUBTREE_KINDS = (JP.K_SCALE_SUBTREE_ULTRA, JP.K_SCALE_SUBTREE_RATE)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    t = random_ultrametric_tree(rng, 14)
    topo = FlatTopology.from_tree(t)
    k = topo.n - 2
    s0 = j_init(t, topo)
    inner = [int(i) for i in topo.inner_nodes if i]
    cal = jnp_.CalibrationSet(np.asarray([0, inner[1]], np.int32), np.asarray([0.8, 0.1]),
                              np.asarray([0.01, 0.02]), np.asarray([1.6, np.inf]),
                              np.asarray([0.01, 1.0]), names=("root", "a"))
    con = jnp_.ConstraintSet(np.asarray([inner[-1]], np.int32), np.asarray([inner[-2]], np.int32),
                             np.asarray([0.01]))
    br = jnp_.BraceSet(np.asarray([[inner[2], inner[-1]]], np.int32), np.asarray([0.05]),
                       names=("b",))
    table = JP.build_proposal_table(topo, br, True)
    # Every subtree move's row as the table gives a subtree above the
    # threshold: the whole-D class.
    big = np.isin(table.kind, SUBTREE_KINDS)
    table = dataclasses.replace(table, d_class=np.where(big, JP.DC_FULL, table.d_class),
                                d_lo=np.where(big, 1, table.d_lo))
    h = np.asarray(s0.heights)[None].repeat(C, 0) * rng.uniform(0.95, 1.0, size=(C, 1))
    h[:, 0] = 1.0
    h[:, topo.is_leaf] = 0.0
    state = dict(heights=h, rates=rng.gamma(20.0, 0.05, size=(C, topo.n)),
                 birth=rng.uniform(0.5, 2, C), death=rng.uniform(0.1, 1, C),
                 height=rng.uniform(1.0, 1.4, C), rate_mean=rng.uniform(0.8, 1.2, C),
                 rate_var=rng.uniform(0.05, 0.5, C))
    datas = {"univariate": jmvn.LikelihoodData.univariate(rng.uniform(0.05, 0.5, k),
                                                          rng.uniform(1e-4, 1e-3, k)),
             "full": jmvn.LikelihoodData.full(np.full(k, 0.1), np.eye(k) * 100.0, 0.0),
             "none": jmvn.LikelihoodData.none()}
    tuning = rng.uniform(0.3, 3.0, size=(C, table.n_proposals))
    return topo, table, br, cal, con, datas, state, tuning


def _jcarry(jm, js, topo, tuning, keys):
    """The JAX step's carry of ``js`` (as tests/test_torch_ticket_step.py's)."""
    terms = jax.vmap(jm.log_prior_terms)(js)
    y = jax.vmap(jm.whitened_residual_internal)(js)
    d = jax.vmap(lambda s: JH.distances_internal(s, topo))(js)
    acc = jnp.zeros((C, len(tuning[0])), jnp.int32)
    return (js, terms, d, y, jnp.asarray(tuning), acc, keys)


def _port(setup, lik):
    topo, table, br, cal, con, datas, state, _ = setup
    pm, ps = from_numpy(topo, datas[lik], state, calibrations=cal, constraints=con, braces=br,
                        mean_root_height=1.2, device="cpu")
    return pm, ps, tmh.MHKernel(pm, table)


@pytest.mark.parametrize("lik", ("univariate", "full", "none"))
def test_records_decode_to_the_table(setup, lik):
    """Each row's record holds the table's columns, its class row count,
    its node's parent and children and its lists; a record whose lists were
    not inline reads the same lists from the CSR arrays."""
    topo, table = setup[0], setup[1]
    pm, _, tk = _port(setup, lik)
    tt = tk.tt
    assert tt.rec.shape == (table.n_proposals, TS.REC_WORDS) and tt.rec.dtype == np.int32
    children = np.asarray(pm.topo.children)
    for p in range(table.n_proposals):
        r = tt.decode(p)
        assert r["row"] == p
        for k, col in tt.cols.items():
            assert r[k] == int(col[p]), (k, p)
        assert r["sd"] == float(np.float32(table.par[p]))
        assert r["rj"] == int(bool(table.root_jac[p]))
        assert (r["d_class"], r["d_lo"], r["d_n"], r["row0"]) == (
            int(tt.d_class[p]), int(tt.d_lo[p]), int(tt.d_n[p]), int(tt.row0[p]))
        node = int(table.node[p])
        assert r["parent"] == (int(topo.parent[node]) if node >= 0 else -1)
        kids = np.full(TS.REC_KIDS, -1)
        if node >= 0:
            kids[:children.shape[1]] = children[node]
        np.testing.assert_array_equal(r["kids"], kids)
        np.testing.assert_array_equal(r["nodes"], tt.n_idx[tt.n_off[p]:tt.n_off[p + 1]])
        np.testing.assert_array_equal(r["terms"], tt.t_idx[tt.t_off[p]:tt.t_off[p + 1]])
        if tt.d_class[p] == TP.DC_GATHER:
            np.testing.assert_array_equal(r["grows"], tt.didx[p])
        else:
            assert r["grows"] is None
        tix = tt.tix(p).numpy()
        assert set(r["terms"].tolist()) <= set(tix.tolist())
        if r["inline"]:
            rec = tt.rec[p].copy()
            tt.rec[p, TS.R["inline"]] = 0
            out = tt.decode(p)
            tt.rec[p] = rec
            for k in ("nodes", "terms", "grows"):
                np.testing.assert_array_equal(out[k], r[k])
    assert tt.rec[:, TS.R["inline"]].all()
    big = np.isin(table.kind, SUBTREE_KINDS)
    if lik == "univariate":
        assert (tt.d_class[big] == TS.DC_RANGE).all()
        for p in np.nonzero(big)[0]:
            sub = range(int(table.node[p]), int(topo.subtree_end[int(table.node[p])]))
            # Row 0 only where the subtree holds a root child.
            own = sorted({int(pm.topo.internal_pos[i]) for i in sub} - {-1})
            assert tt.rows(int(p)).tolist() == own
    else:
        assert not (tt.d_class == TS.DC_RANGE).any()
    assert (tt.d_class[~big] == np.asarray(table.d_class)[~big]).all()


def test_big_subtree_rows_match_jax(setup):
    """Under the univariate kind, subtree rows of the whole-D class: the
    port's scan and sweep (their own rows) against the JAX step (all D)."""
    topo, table, br, cal, con, datas, state, tuning = setup
    jm = JModel(topo=topo, likelihood=datas["univariate"], calibrations=cal, constraints=con,
                braces=br, mean_root_height=1.2)
    js = JState(**{k: jnp.asarray(v) for k, v in state.items()})
    step = jax.jit(jmh.MHKernel(jm, table)._ticket_step(JP.make_kernel_switch(topo, br), 1.0,
                                                         jnp.float64))
    pm, ps, tk = _port(setup, "univariate")
    tickets = np.asarray(table.tickets)
    big = np.isin(table.kind, SUBTREE_KINDS)
    rng = np.random.default_rng(9)
    order = np.concatenate([rng.choice(tickets[big[tickets]], N_TICKETS // 2),
                            rng.choice(tickets, N_TICKETS // 2)])
    order = rng.permutation(order).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(13), C)
    shape = jnp.asarray(np.asarray(table.par)[None, :] / tuning)
    is_gamma = jnp.asarray(np.isin(table.kind, sorted(TP.GAMMA_KINDS)))
    draws, u_acc = _scan_draws(keys, jnp.asarray(order), shape, is_gamma)
    draws = torch.as_tensor(np.array(draws).T.copy())
    u_acc = torch.as_tensor(np.array(u_acc).T.copy())
    jc = _jcarry(jm, js, topo, tuning, keys)
    for p in order:
        jc, _ = step(jc, jnp.int32(p))
    tuning_t = torch.as_tensor(tuning)
    carry = tk.init_carry(ps)
    res = TS.ticket_scan_plain(tk.tt, carry, tuning_t, TS.TicketDraws(order, None, draws, None,
                                                                      None, None, u_acc),
                               0, len(order))
    acc_big = res.accept[:, big[order]]
    assert 0 < int(acc_big.sum()) < acc_big.numel()
    _agree("univariate", carry, jc)
    carry = tk.init_carry(ps)
    tk.sweep_once(carry, tuning_t, None, None, given=(order, draws, u_acc))
    _agree("univariate", carry, jc)


def _touched(tt, topo, p):
    """Row ``p``'s state as its tickets touch it: ``(nodes written, nodes
    read, term entries, distance rows)``, from the table's own index sets."""
    parent = np.asarray(topo.parent)
    node = int(tt.cols["node"][p])
    wrote = set(tt.n_idx[tt.n_off[p]:tt.n_off[p + 1]].tolist())
    read = set(wrote)
    if node >= 0:
        read |= {node, int(parent[node])} | {int(c) for c in topo.children[node] if c >= 0}
    n = topo.n
    for t in tt.tix(p).tolist():
        j = (t - 4) % (n + 1)
        if 4 <= t < 4 + 2 * (n + 1) and j < n:
            read |= {j, int(parent[j])}
    rows = tt.rows(p)
    rows = set(range(tt.D) if rows is None else rows.tolist())
    dist = np.asarray(topo.internal_dist_index)
    for r in rows:
        read |= {int(dist[r]), int(parent[dist[r]])}
        if r == 0:
            read |= {int(topo.root_children[1]), 0}
    return wrote, read - {-1}, set(tt.tix(p).tolist()), rows


def test_windows_touch_disjoint_state(setup):
    """Two rows that do not conflict touch disjoint state: neither writes a
    node the other reads, and their term entries and distance rows are
    disjoint; every window of a drawn order holds such tickets only."""
    topo, table = setup[0], setup[1]
    pm, _, tk = _port(setup, "univariate")
    tt = tk.tt
    rng = np.random.default_rng(3)
    P = table.n_proposals
    touch = [_touched(tt, pm.topo, p) for p in range(P)]
    p, q = rng.integers(0, P, 4000), rng.integers(0, P, 4000)
    free = ~tt.conflicts(p, q)
    assert free.sum() > 200
    for a, b in zip(p[free], q[free]):
        wa, ra, ta, da = touch[a]
        wb, rb, tb, db = touch[b]
        assert not (wa & rb) and not (wb & ra) and not (ta & tb) and not (da & db), (a, b)
    order = rng.permutation(np.asarray(table.tickets))
    lead = tt.windows(order)
    starts = np.flatnonzero(lead)
    assert len(starts) < len(order)
    for s, e in zip(starts, list(starts[1:]) + [len(order)]):
        assert e - s <= TS.RUN_SLOTS
        for i in range(s, e):
            for k in range(i + 1, e):
                assert not tt.conflicts(order[i:i + 1], order[k:k + 1])[0]
