"""The banded likelihood kind of the PyTorch port against the JAX package,
on the CPU at float64: the host helpers of ``ops/banded.py``, the plain
versions of kernels B1 ``band_matmul`` and B2 ``band_matmul_t`` (with a
window of output blocks, ``sub``, both reductions and ``into``), the banded
log likelihood, the ``BandedS`` ``.data`` file, ``prepare "banded W"``
byte for byte and the CLI's spec."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcmcdate_tpu import cli as jcli, prepare as jprep
from mcmcdate_tpu.io import lhdata as jlh
from mcmcdate_tpu.ops import banded as jb, mvn as jmvn
from mcmcdate_tpu.utils.simulate import simulate, write_fixture
from mcmcdate_tpu_torch import cli as tcli, prepare as tprep, synthetic
from mcmcdate_tpu_torch.io import lhdata as tlh
from mcmcdate_tpu_torch.kernels import band_matmul as B
from mcmcdate_tpu_torch.ops import banded as tb, mvn as tmvn

D, W = 101, 7
C = 6


def close(port, ref, rtol=1e-12, atol=1e-14):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def band():
    """Correlated samples in a layout, their banded estimate and its
    symmetric band (by the port's helpers, each checked below)."""
    rng = np.random.default_rng(5)
    e = rng.normal(size=(60, D + 3))
    xs = 0.3 + e[:, :D] + 0.6 * e[:, 1:D + 1] + 0.3 * e[:, 3:D + 3]
    mu, lb, log_det = tb.estimate_banded_chol(xs, W)
    return xs, mu, lb, log_det, tb.pband_from_chol_upper(lb)


def test_host_helpers_match_jax(band):
    xs, mu, lb, log_det, pband = band
    jmu, jlb, jld = jb.estimate_banded_chol(xs, W)
    close(mu, jmu)
    close(lb, jlb)
    assert abs(log_det - jld) <= 1e-12 * abs(jld)
    close(pband, jb.pband_from_chol_upper(jlb))
    x = np.random.default_rng(1).normal(size=D)
    close(tb.sym_band_matvec(pband, x), jb.sym_band_matvec(pband, x))
    for wb in (8, 16, 33):
        close(tb.blocks_from_sym_band(pband, wb), jb.blocks_from_sym_band(pband, wb))
        close(tb.blocks_from_upper_band(lb, wb), jb.blocks_from_upper_band(lb, wb))
    for w in (3, 128, 200):
        assert tb.default_block_size(w) == jb.default_block_size(w)
    with pytest.raises(ValueError, match="exceeds block size"):
        tb.blocks_from_sym_band(pband, W - 1)
    # The estimate is a positive-definite banded precision: P = L L' from
    # the band equals its densified form.
    Ld = np.zeros((D, D))
    for t in range(W + 1):
        Ld[np.arange(D - t), np.arange(t, D)] = lb[:D - t, t]
    P = Ld @ Ld.T
    close(np.diag(P), pband[:, 0], rtol=1e-12)
    close(np.diag(P, 3), pband[:D - 3, 3], rtol=1e-12, atol=1e-12)


def _windows(nb):
    return [None, (0, nb), (1, nb - 1), (0, 1), (nb - 1, nb), (2, 3)]


@pytest.mark.parametrize("wb", [8, 16, 33])
@pytest.mark.parametrize("which", ["L3", "P3"])
def test_products_match_jax(band, wb, which):
    """B1's and B2's plain versions against block_tridiag_matmul(_t): on a
    window of output blocks the product's columns there (the rest zero, or
    ``into`` unchanged) and each reduction over them."""
    _, mu, lb, _, pband = band
    M3 = tb.blocks_from_upper_band(lb, wb) if which == "L3" else tb.blocks_from_sym_band(
        pband, wb)
    nb = M3.shape[0]
    rng = np.random.default_rng(wb)
    x = rng.normal(size=(C, D)) + 0.3
    y = rng.normal(size=(C, D))
    sub = mu
    upper = which == "L3"
    ref = {False: np.asarray(jax.vmap(lambda r: jb.block_tridiag_matmul(r, jnp.asarray(M3), D))(
               jnp.asarray(x - sub))),
           True: np.asarray(jax.vmap(lambda r: jb.block_tridiag_matmul_t(r, jnp.asarray(M3), D))(
               jnp.asarray(x - sub)))}
    T = torch.as_tensor
    for trans, fn in ((False, B.band_matmul), (True, B.band_matmul_t)):
        for win in _windows(nb):
            lo, hi = (0, D) if win is None else (win[0] * wb, min(win[1] * wb, D))
            want = np.zeros((C, D))
            want[:, lo:hi] = ref[trans][:, lo:hi]
            out, red = fn(T(x), T(M3), sub=T(sub), window=win, upper=upper)
            close(out, want, atol=1e-13)
            close(red, np.sum(want * want, -1), atol=1e-12)
            out, red = fn(T(x), T(M3), sub=T(sub), window=win, y=T(y), upper=upper)
            close(out, want, atol=1e-13)
            close(red, -0.5 * np.sum(want * (2.0 * y + want), -1), atol=1e-12)
            into = T(y.copy())
            out, red = fn(T(x), T(M3), sub=T(sub), window=win, into=into, upper=upper)
            assert out is into and red is None
            close(into, y + want, atol=1e-13)
    # The convenience entry points: the JAX functions' signature.
    close(tb.block_tridiag_matmul(T(x - sub), T(M3), D), ref[False], atol=1e-13)
    close(tb.block_tridiag_matmul_t(T(x - sub), T(M3), D), ref[True], atol=1e-13)


def test_block_window_reach(band):
    """A product of an input that is zero off rows [lo, hi) is zero outside
    ``block_window``'s output blocks, which hold all of it."""
    _, _, lb, _, pband = band
    wb = 8
    rng = np.random.default_rng(3)
    for which, M3 in (("L3", tb.blocks_from_upper_band(lb, wb)),
                      ("P3", tb.blocks_from_sym_band(pband, wb))):
        nb = M3.shape[0]
        for lo, hi in ((0, 1), (7, 9), (8, 16), (50, 51), (95, 101), (3, 40)):
            x = np.zeros((2, D))
            x[:, lo:hi] = rng.normal(size=(2, hi - lo))
            full = B.band_matmul_plain(torch.as_tensor(x), torch.as_tensor(M3))[0].numpy()
            n0, n1 = tb.block_window(lo, hi, wb, nb, upper=which == "L3")
            inside = np.zeros(D, bool)
            inside[n0 * wb:n1 * wb] = True
            assert not full[:, ~inside].any(), (which, lo, hi)
            win = B.band_matmul_plain(torch.as_tensor(x), torch.as_tensor(M3),
                                      window=(n0, n1))[0].numpy()
            np.testing.assert_array_equal(win, full)
    assert tb.block_window(5, 5, 8, 13) == (0, 0)


def test_log_likelihood_matches_jax(band):
    _, mu_int, lb, log_det, _ = band
    rng = np.random.default_rng(8)
    perm = rng.permutation(D)
    mu = np.empty(D)
    mu[perm] = mu_int
    d = mu + 0.2 * rng.normal(size=(C, D))
    tdata = tmvn.LikelihoodData.banded(mu, lb, log_det, perm)
    jdata = jmvn.LikelihoodData.banded(mu, lb, log_det, perm)
    assert tdata.bandwidth == jdata.bandwidth == W
    got = tmvn.make_log_likelihood(tdata, device="cpu")(torch.as_tensor(d))
    close(got, jax.vmap(jmvn.make_log_likelihood(jdata))(jnp.asarray(d)), rtol=1e-12)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_banded_data_file_matches_jax(band, tmp_path):
    _, mu, lb, log_det, _ = band
    perm = np.random.default_rng(2).permutation(D)
    tlh.save_data(str(tmp_path / "port.data"), tmvn.LikelihoodData.banded(mu, lb, log_det, perm))
    jlh.save_data(str(tmp_path / "jax.data"), jmvn.LikelihoodData.banded(mu, lb, log_det, perm))
    assert _read(tmp_path / "port.data") == _read(tmp_path / "jax.data")
    back = tlh.load_data(str(tmp_path / "jax.data"))
    assert back.kind == tmvn.BANDED and back.bandwidth == W
    for f in ("mu", "band_chol", "band_perm"):
        np.testing.assert_array_equal(getattr(back, f), getattr(
            jlh.load_data(str(tmp_path / "port.data")), f))
    assert back.log_det_sigma == log_det
    tlh.save_data(str(tmp_path / "again.data"), back)
    assert _read(tmp_path / "again.data") == _read(tmp_path / "jax.data")


def test_prepare_banded_matches_jax(tmp_path):
    write_fixture(simulate(n_leaves=12, n_trees=90, seed=6), str(tmp_path / "data"))
    logs = {}
    for name, mod in (("jax", jprep), ("port", tprep)):
        out = tmp_path / name
        out.mkdir()
        lines = logs[name] = []
        mod.prepare("an", str(tmp_path / "data/time.tree"), str(tmp_path / "data/trees.nwk"),
                    "banded", banded_w=5, out_dir=str(out), log=lines.append)
    for f in ("an.data", "an.meantree"):
        assert _read(tmp_path / "jax" / f) == _read(tmp_path / "port" / f), f
    # The same log lines, but for the output directory.
    assert [line.replace(str(tmp_path / "port"), "OUT") for line in logs["port"]] == [
        line.replace(str(tmp_path / "jax"), "OUT") for line in logs["jax"]]
    assert any("bandwidth of: 5" in line for line in logs["port"])


@pytest.mark.parametrize("spec", ["banded", "banded 64", "b 5", "full", "sparse 0.2"])
def test_cli_spec_parse_matches_jax(spec):
    assert tcli._parse_likelihood_spec(spec) == jcli._parse_likelihood_spec(spec)


def test_synthetic_banded_model():
    """``synthetic.build(kind="banded")``: the estimator's band in the
    internal layout of the model's own topology, and a log likelihood whose
    quadratic form is the whitened residual's."""
    model, batch = synthetic.build(16, 4, dtype=torch.float64, device="cpu", kind="banded",
                                   bandwidth=6)
    lik = model.likelihood
    assert lik.kind == tmvn.BANDED and lik.bandwidth == 6 and lik.dim == 29
    np.testing.assert_array_equal(lik.band_perm, model.topo.ref_to_internal_perm)
    assert (lik.band_chol[:, 0] > 0).all()
    y = model.whitened_residual_internal(batch)
    close(model.log_likelihood(batch), model.log_lik_const - 0.5 * (y * y).sum(-1))
