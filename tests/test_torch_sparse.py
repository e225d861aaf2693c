"""The sparse likelihood kind in the port against the JAX package, on the
CPU at float64: ``prepare "sparse 0.1"`` writes the JAX package's files (by
the host BCD, and by the ADMM above ``GLASSO_HOST_MAX`` dims), the two
packages read each other's ``SparseS`` files, the log likelihood matches,
and a FastSweeps run on sparse data is the run on its dense precision."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcdate_tpu import prepare as jprep
from mcmcdate_tpu.io import lhdata as jlh
from mcmcdate_tpu.ops import mvn as jmvn
from mcmcdate_tpu.utils.simulate import simulate, write_fixture
from mcmcdate_tpu_torch import cli, prepare as tprep
from mcmcdate_tpu_torch.engine import chains as TC, fast_sweep as TF, mh as TM
from mcmcdate_tpu_torch.io import lhdata as tlh
from mcmcdate_tpu_torch.ops import mvn as tmvn

# The ADMM routes of the two packages: the same float64 iteration with
# LAPACK's eigh and a product whose last bits differ (test_torch_glasso.py:
# 1e-12 on the correlation scale), rescaled to branch-length precisions.
ADMM_REL = 1e-10


def quiet(*a):
    pass


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sparse")
    write_fixture(simulate(n_leaves=12, n_trees=200, seed=5), str(d / "data"))
    return d


def _prepare(mod, d, out, spec="sparse", **kw):
    os.makedirs(out, exist_ok=True)
    return mod.prepare("an", str(d / "data/time.tree"), str(d / "data/trees.nwk"), spec,
                       out_dir=str(out), log=quiet, **kw)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_prepare_sparse_files_identical(fixture_dir):
    _prepare(jprep, fixture_dir, fixture_dir / "jax", sparse_rho=0.1)
    res = _prepare(tprep, fixture_dir, fixture_dir / "port", sparse_rho=0.1)
    assert res.data.kind == tmvn.SPARSE
    for f in ("an.data", "an.meantree"):
        assert _read(fixture_dir / "jax" / f) == _read(fixture_dir / "port" / f), f
    assert b'"tag": "SparseS"' in _read(fixture_dir / "port" / "an.data")


def test_prepare_sparse_admm_route(fixture_dir, monkeypatch):
    """Below the host limit the ADMM route: D = 21 > 5 in both packages."""
    bcd = _prepare(tprep, fixture_dir, fixture_dir / "port_bcd_ref", sparse_rho=0.1).data
    monkeypatch.setattr(jprep, "GLASSO_HOST_MAX", 5)
    monkeypatch.setattr(tprep, "GLASSO_HOST_MAX", 5)
    j = _prepare(jprep, fixture_dir, fixture_dir / "jax_admm", sparse_rho=0.1).data
    t = _prepare(tprep, fixture_dir, fixture_dir / "port_admm", sparse_rho=0.1,
                 device="cpu").data
    assert [ij for ij, _ in t.precision_assoc] == [ij for ij, _ in j.precision_assoc]
    scale = np.abs(j.precision).max()
    assert np.abs(t.precision - j.precision).max() <= ADMM_REL * scale
    assert abs(t.log_det_sigma - j.log_det_sigma) <= ADMM_REL * abs(j.log_det_sigma)
    np.testing.assert_array_equal(t.mu, j.mu)
    # and not the BCD's solution bit for bit: the route was taken
    assert not np.array_equal(bcd.precision, t.precision)


def test_prepare_sparse_admm_needs_the_device(fixture_dir, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from mcmcdate_tpu_torch.utils.device import NoCardError

    monkeypatch.setattr(tprep, "GLASSO_HOST_MAX", 5)
    with pytest.raises(NoCardError):
        _prepare(tprep, fixture_dir, fixture_dir / "nocard")


def test_sparse_files_cross_load(fixture_dir, tmp_path):
    _prepare(jprep, fixture_dir, fixture_dir / "jax_x", sparse_rho=0.2)
    _prepare(tprep, fixture_dir, fixture_dir / "port_x", sparse_rho=0.2)
    t = tlh.load_data(str(fixture_dir / "jax_x" / "an.data"))
    j = jlh.load_data(str(fixture_dir / "port_x" / "an.data"))
    assert t.kind == tmvn.SPARSE and j.kind == jmvn.SPARSE
    for field in ("mu", "precision", "chol_precision", "log_det_sigma"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
    assert tuple(t.precision_assoc) == tuple(j.precision_assoc)
    tlh.save_data(str(tmp_path / "rt.data"), t)
    assert _read(tmp_path / "rt.data") == _read(fixture_dir / "jax_x" / "an.data")
    # a sparse LikelihoodData without its list writes the same file
    bare = tmvn.LikelihoodData.sparse(t.mu, t.precision, t.log_det_sigma)
    tlh.save_data(str(tmp_path / "bare.data"), bare)
    assert _read(tmp_path / "bare.data") == _read(fixture_dir / "jax_x" / "an.data")


def test_sparse_log_likelihood_matches_jax():
    rng = np.random.default_rng(2)
    k, C = 9, 5
    a = rng.normal(size=(k, k)) / np.sqrt(k)
    prec = np.linalg.inv(a @ a.T + np.eye(k) * 0.1)
    prec[np.abs(prec) < 0.3 * np.abs(prec).mean()] = 0.0
    prec = 0.5 * (prec + prec.T) + np.eye(k) * 2.0
    mu = rng.uniform(0.1, 0.5, k)
    d = mu + rng.normal(size=(C, k)) * 0.1
    ld = -np.linalg.slogdet(prec)[1]
    got = tmvn.make_log_likelihood(tmvn.LikelihoodData.sparse(mu, prec, ld),
                                   device="cpu")(torch.as_tensor(d))
    want = jax.vmap(jmvn.make_log_likelihood(jmvn.LikelihoodData.sparse(mu, prec, ld)))(
        jnp.asarray(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def _small_run(monkeypatch):
    monkeypatch.setattr(TC, "CHUNK", 2)
    monkeypatch.setattr(TM, "BURN_IN_PROF_FAST", [2])
    monkeypatch.setattr(TM, "BURN_IN_PROF_SLOW", [])


def test_fast_sweeps_sparse_is_the_dense_run(fixture_dir, monkeypatch, tmp_path):
    """A sparse ``.data`` and a ``FullS`` one holding its dense precision
    give the same FastSweeps run, bit for bit."""
    _small_run(monkeypatch)
    _prepare(tprep, fixture_dir, tmp_path, sparse_rho=0.1)
    sp = tlh.load_data(str(tmp_path / "an.data"))
    full = tmvn.LikelihoodData.full(sp.mu, sp.precision, sp.log_det_sigma)
    os.makedirs(tmp_path / "full")
    tlh.save_data(str(tmp_path / "full" / "an.data"), full)
    os.link(tmp_path / "an.meantree", tmp_path / "full" / "an.meantree")
    runs = {}
    for kind, d in (("sparse", tmp_path), ("full", tmp_path / "full")):
        runner = cli.main(["run", "-a", "an", "--device", "cpu", "--dtype", "float64",
                           "--chains", "4", "--iterations", "4", "--seed", "3", "--profile",
                           "--out-dir", str(d)])
        assert isinstance(runner.kern, TF.FastSweeps)
        assert runner.model.likelihood.kind == kind
        with np.load(d / "an.mcmc.npz") as z:
            runs[kind] = {k: z[k] for k in z.files}
    assert runs["sparse"].keys() == runs["full"].keys()
    for k in runs["sparse"]:
        np.testing.assert_array_equal(runs["sparse"][k], runs["full"][k], err_msg=k)


def test_cli_passes_rho(fixture_dir, monkeypatch, tmp_path):
    seen = {}
    real = tprep.prepare

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(tprep, "prepare", spy)
    res = cli.main(["prepare", "-a", "an", "--rooted-tree",
                    str(fixture_dir / "data/time.tree"), "--trees",
                    str(fixture_dir / "data/trees.nwk"), "--likelihood-spec", "sparse 0.3",
                    "--device", "cpu", "--out-dir", str(tmp_path)])
    assert seen["sparse_rho"] == 0.3 and seen["device"] == "cpu"
    _prepare(jprep, fixture_dir, tmp_path / "jax", sparse_rho=0.3)
    assert _read(tmp_path / "an.data") == _read(tmp_path / "jax" / "an.data")
    assert res.data.kind == tmvn.SPARSE
