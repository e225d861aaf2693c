"""``band_rows_add``, the banded point and range steps' ``z += dacc P[rows]``
as a row-sparse band product, on the CPU at float64: the row band
``ops.banded.rows_from_sym_band``; the plan of column tiles
(``band_rows_plan``: every (row slot, column of its band) pair in exactly
one tile's list, and the kernel's walk over the tiles equal to the plain
version); the plain version against the JAX ``dacc @
block_tridiag_matmul(one_hot(rows), P3)`` and against the scatter into a
zero buffer with B1's windowed ``into`` product that it replaced, with
duplicate rows, pad rows and rows 0 and D - 1, for a bandwidth below and at
the block size; and a banded FastSweeps' steps (16 leaves) against their
rows' densified precision."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcmcdate_tpu.ops import banded as jb
from mcmcdate_tpu_torch import synthetic
from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP
from mcmcdate_tpu_torch.kernels import band_matmul as B
from mcmcdate_tpu_torch.ops import banded as tb

D, C, WB = 29, 12, 8  # the distances of a 16-leaf tree; the block size


def close(port, ref, rtol=1e-12):
    """Equal within ``rtol`` of the reference's largest entry."""
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * max(1.0, np.abs(ref).max()))


def _pband(w, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(60, D + 3))
    xs = 0.3 + e[:, :D] + 0.6 * e[:, 1:D + 1] + 0.3 * e[:, 3:D + 3]
    _, lb, _ = tb.estimate_banded_chol(xs, w)
    return tb.pband_from_chol_upper(lb)


def _dense(pband):
    """The symmetric matrix whose band is ``pband``."""
    n = pband.shape[0]
    P = np.zeros((n, n))
    for s in range(pband.shape[1]):
        P[np.arange(n - s), np.arange(s, n)] = pband[:n - s, s]
        P[np.arange(s, n), np.arange(n - s)] = pband[:n - s, s]
    return P


# Row slots of a step: duplicates (7 three times, 12 twice), the first and
# last rows, neighbours across a tile edge, and pad slots (ok False) whose
# rows must add nothing.
ROWS = np.array([7, 0, 12, 7, D - 1, 12, 15, 16, 3, 7, 22, 5])
OK = np.array([1, 1, 1, 1, 1, 0, 1, 1, 0, 1, 1, 0], bool)


@pytest.mark.parametrize("w", [3, 5, 8])
def test_row_band_is_the_precision(w):
    """``rows_from_sym_band(pband)[r, t] = P[r, r - w + t]``, zero outside
    the matrix."""
    pband = _pband(w)
    P = _dense(pband)
    prows = tb.rows_from_sym_band(pband)
    assert prows.shape == (D, 2 * w + 1)
    for r in range(D):
        for t in range(2 * w + 1):
            j = r - w + t
            assert prows[r, t] == (P[r, j] if 0 <= j < D else 0.0), (r, t)


@pytest.mark.parametrize("tn", [4, 8, B.ROWS_TILE])
@pytest.mark.parametrize("w", [5, 8])
def test_plan_covers_each_pair_once(w, tn):
    """Every valid (row slot, column within its band) pair lies in exactly
    one tile's list, the tile that holds the column; a tile lists only slots
    that reach it, in slot order; the tiles are in order."""
    plan = B.band_rows_plan(ROWS, OK, w, D, tn=tn)
    assert plan.w == w and plan.tn == tn
    np.testing.assert_array_equal(plan.slots.numpy(), np.flatnonzero(OK))
    np.testing.assert_array_equal(plan.rows.numpy(), ROWS[OK])
    col0, ptr, ent = plan.col0.numpy(), plan.ptr.numpy(), plan.ent.numpy()
    assert np.all(np.diff(col0) > 0) and np.all(col0 % tn == 0)
    assert ptr[0] == 0 and ptr[-1] == len(ent) and np.all(np.diff(ptr) > 0)
    seen = {}
    for t, j0 in enumerate(col0):
        ents = ent[ptr[t]:ptr[t + 1]]
        assert np.all(np.diff(ents[:, 0]) > 0), "slots out of order"
        for slot, r in ents:
            assert OK[slot] and ROWS[slot] == r
            cols = [j for j in range(j0, min(j0 + tn, D)) if abs(j - r) <= w]
            assert cols, f"tile {j0} lists slot {slot}, which does not reach it"
            for j in cols:
                seen[(slot, j)] = seen.get((slot, j), 0) + 1
    want = {(s, j) for s in np.flatnonzero(OK) for j in range(D) if abs(j - ROWS[s]) <= w}
    assert set(seen) == want and set(seen.values()) == {1}


def _inputs(w, seed):
    rng = np.random.default_rng(seed)
    pband = _pband(w, seed)
    z0 = rng.normal(size=(C, D))
    dacc = rng.normal(size=(C, len(ROWS)))
    return pband, z0, dacc


@pytest.mark.parametrize("w", [5, 8])  # below and at the block size WB
def test_plain_matches_jax_and_scatter(w):
    """The plain ``band_rows_add`` against the JAX steps' ``z + dacc @
    Prow``, ``Prow = block_tridiag_matmul(one_hot(rows), P3)`` (pad rows
    all zero), and against the scatter into a zero ``[C, D]`` buffer with
    B1's product on the rows' window added ``into`` z; float64, 1e-12."""
    pband, z0, dacc = _inputs(w, w)
    P3 = tb.blocks_from_sym_band(pband, WB)
    T = torch.as_tensor
    plan = B.band_rows_plan(ROWS, OK, w, D)
    z = B.band_rows_add(T(z0.copy()), T(dacc), T(tb.rows_from_sym_band(pband)), plan)
    onehot = np.zeros((len(ROWS), D))
    onehot[np.arange(len(ROWS)), ROWS] = OK
    prow = np.asarray(jax.vmap(lambda r: jb.block_tridiag_matmul(r, jnp.asarray(P3), D))(
        jnp.asarray(onehot)))
    close(z, z0 + dacc @ prow)
    close(z, z0 + dacc @ (onehot @ _dense(pband)))
    buf = torch.zeros((C, D), dtype=torch.float64)
    buf.index_add_(1, T(ROWS[OK]), T(dacc[:, OK]))
    win = tb.block_window(int(ROWS[OK].min()), int(ROWS[OK].max()) + 1, WB, P3.shape[0])
    old = T(z0.copy())
    B.band_matmul(buf, T(P3), window=win, into=old)
    close(z, old)


@pytest.mark.parametrize("tn", [4, B.ROWS_TILE])
def test_tile_walk_matches_plain(tn):
    """The kernel's order of work, tile by tile and each tile's entries in
    list order, on the plan's tensors alone, gives the plain version's
    ``z``."""
    w = 5
    pband, z0, dacc = _inputs(w, 11)
    prows = tb.rows_from_sym_band(pband)
    plan = B.band_rows_plan(ROWS, OK, w, D, tn=tn)
    z = z0.copy()
    col0, ptr, ent = plan.col0.numpy(), plan.ptr.numpy(), plan.ent.numpy()
    for t, j0 in enumerate(col0):
        cols = np.arange(j0, min(j0 + tn, D))
        acc = np.zeros((C, len(cols)))
        for slot, r in ent[ptr[t]:ptr[t + 1]]:
            tt = cols - r + w
            seg = np.where((tt >= 0) & (tt <= 2 * w), prows[r, np.clip(tt, 0, 2 * w)], 0.0)
            acc += dacc[:, slot, None] * seg[None]
        z[:, cols] += acc
    want = B.band_rows_add_plain(torch.as_tensor(z0.copy()), torch.as_tensor(dacc),
                                 torch.as_tensor(prows), plan)
    close(z, want)


def test_wrapper_on_cpu():
    """For CPU tensors the wrapper runs the plain version in place and
    counts no launch; a plan with no valid row leaves ``z`` as it was."""
    w = 5
    pband, z0, dacc = _inputs(w, 2)
    T = torch.as_tensor
    prows = T(tb.rows_from_sym_band(pband))
    plan = B.band_rows_plan(ROWS, OK, w, D)
    before = B.band_rows_add.launches
    z = T(z0.copy())
    assert B.band_rows_add(z, T(dacc), prows, plan) is z
    close(z, B.band_rows_add_plain(T(z0.copy()), T(dacc), prows, plan), rtol=0)
    empty = B.band_rows_plan(ROWS, np.zeros_like(OK), w, D)
    assert empty.col0.numel() == 0 and empty.ent.shape == (0, 2)
    z = T(z0.copy())
    B.band_rows_add(z, T(dacc), prows, empty)
    np.testing.assert_array_equal(z.numpy(), z0)
    assert B.band_rows_add.launches == before
    with pytest.raises(ValueError, match="rows outside"):
        B.band_rows_plan([0, D], [True, True], w, D)


def test_fast_sweeps_steps_use_their_rows(monkeypatch):
    """A banded FastSweeps (16 leaves, 8 chains, bandwidth 5, block size 8):
    every point step's and likelihood range block's plan holds its valid
    rows, and ``_z_add`` adds ``dacc @ P[d_flat]`` (pad rows zero) with
    ``P`` densified from the band."""
    monkeypatch.setattr(tb, "default_block_size", lambda w: max(w, WB))
    model, _ = synthetic.build(16, 8, dtype=torch.float64, device="cpu", kind="banded",
                               bandwidth=5)
    table = TP.build_proposal_table(model.topo, model.braces, False)
    fs = TF.FastSweeps(model, table)
    assert fs.banded and fs.prows.shape == (fs.dim, 11)
    P = _dense(fs.pband.numpy())
    steps = [sx for steps in list(fs.spec_t.values()) + list(fs.range_t.values())
             for sx in steps if "zplan" in sx]
    assert steps
    rng = np.random.default_rng(4)
    for sx in steps:
        rows = sx["d_flat"].numpy()
        ok = (sx["d_rows"] if "d_rows" in sx else sx["own"]).reshape(-1).numpy() >= 0
        np.testing.assert_array_equal(sx["zplan"].slots.numpy(), np.flatnonzero(ok))
        np.testing.assert_array_equal(sx["zplan"].rows.numpy(), rows[ok])
        z0 = rng.normal(size=(8, fs.dim))
        dacc = rng.normal(size=(8, len(rows)))
        z = torch.as_tensor(z0.copy())
        fs._z_add(z, torch.as_tensor(dacc), sx)
        close(z, z0 + (dacc * ok) @ P[rows])

