"""The PyTorch port's host I/O against the JAX package's, on the CPU: the
files each package writes must be byte-identical, and each package must
read the other's files to identical arrays."""

import json

import numpy as np
import pytest
import jax.numpy as jnp

from mcmcdate_tpu import prepare as jprep
from mcmcdate_tpu.engine import checkpoint as jckpt, monitor as jmon
from mcmcdate_tpu.io import lhdata as jlh, specs as jspecs
from mcmcdate_tpu.models import DatingModel as JModel
from mcmcdate_tpu.models.state import State as JState
from mcmcdate_tpu.ops import mvn as jmvn
from mcmcdate_tpu.tree import FlatTopology, read_one_newick
from mcmcdate_tpu.utils.simulate import simulate, write_fixture
from mcmcdate_tpu_torch import prepare as tprep
from mcmcdate_tpu_torch.engine import checkpoint as tckpt, monitor as tmon
from mcmcdate_tpu_torch.io import lhdata as tlh, specs as tspecs
from mcmcdate_tpu_torch.models import from_numpy
from mcmcdate_tpu_torch.models.state import FIELDS


def quiet(*a):
    pass


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fx")
    write_fixture(simulate(n_leaves=8, n_trees=120, seed=4), str(d / "data"))
    return d


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("spec", ["full", "univariate", "none"])
def test_prepare_files_identical(fixture_dir, spec):
    outs = {}
    for name, mod in (("jax", jprep), ("port", tprep)):
        out = fixture_dir / f"{name}_{spec}"
        out.mkdir()
        mod.prepare("an", str(fixture_dir / "data/time.tree"), str(fixture_dir / "data/trees.nwk"),
                    spec, out_dir=str(out), log=quiet)
        outs[name] = out
    for f in ("an.data", "an.meantree"):
        assert _read(outs["jax"] / f) == _read(outs["port"] / f), f
    # each package reads the other's .data to the same arrays and writes it back unchanged
    port_data = tlh.load_data(str(outs["jax"] / "an.data"))
    jax_data = jlh.load_data(str(outs["port"] / "an.data"))
    for field in ("mu", "precision", "chol_precision", "log_det_sigma", "variances"):
        a, b = getattr(port_data, field), getattr(jax_data, field)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    tlh.save_data(str(fixture_dir / f"rt_{spec}.data"), port_data)
    assert _read(fixture_dir / f"rt_{spec}.data") == _read(outs["jax"] / "an.data")


def test_unported_kinds_raise(fixture_dir, tmp_path):
    # Every likelihood kind is ported (the banded kind last): a BandedS
    # file loads, and only an unknown spec or tag raises.
    with pytest.raises(ValueError, match="Unknown likelihood spec"):
        tprep.prepare("x", str(fixture_dir / "data/time.tree"),
                      str(fixture_dir / "data/trees.nwk"), "bogus", out_dir=str(tmp_path),
                      log=quiet)
    path = tmp_path / "b.data"
    path.write_text(json.dumps({"tag": "BandedS",
                                "contents": [[0.1], [[1.0]], 0.0, [0]]}))
    data = tlh.load_data(str(path))
    assert data.kind == "banded" and data.bandwidth == 0
    path.write_text(json.dumps({"tag": "NoSuchS", "contents": []}))
    with pytest.raises(ValueError, match="Could not decode"):
        tlh.load_data(str(path))


def _state(C=3, N=15, seed=0):
    rng = np.random.default_rng(seed)
    return {"heights": rng.uniform(size=(C, N)), "rates": rng.gamma(5, 0.2, (C, N)),
            "birth": rng.uniform(size=C), "death": rng.uniform(size=C),
            "height": rng.uniform(size=C), "rate_mean": rng.uniform(size=C),
            "rate_var": rng.uniform(size=C)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_checkpoint_round_trips(tmp_path, dtype):
    st = {k: v.astype(dtype) for k, v in _state().items()}
    tuning = np.random.default_rng(1).uniform(size=(3, 7)).astype(dtype)
    key = np.asarray([0, 42], np.uint32)
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir(), tdir.mkdir()
    jckpt.save("an", JState(**{k: jnp.asarray(v) for k, v in st.items()}), jnp.asarray(tuning),
               jnp.asarray(key), 20, 7, out_dir=str(jdir))
    state, tun, k2, meta = tckpt.load("an", in_dir=str(jdir), device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(state, f).numpy(), st[f])
        assert getattr(state, f).numpy().dtype == dtype
    np.testing.assert_array_equal(tun.numpy(), tuning)
    np.testing.assert_array_equal(k2, key)
    assert meta["iteration"] == 20 and meta["format_version"] == jckpt.FORMAT_VERSION
    tckpt.save("an", state, tun, k2, 20, 7, out_dir=str(tdir))
    assert _read(jdir / "an.mcmc.json") == _read(tdir / "an.mcmc.json")
    with np.load(jdir / "an.mcmc.npz") as zj, np.load(tdir / "an.mcmc.npz") as zt:
        assert zj.files == zt.files
        for f in zj.files:
            assert zj[f].dtype == zt[f].dtype
            np.testing.assert_array_equal(zj[f], zt[f])
    j_state, _, _, _ = jckpt.load("an", in_dir=str(tdir))
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j_state, f)), st[f])
    trace = {"lp_post": np.arange(6.0).reshape(3, 2)}
    jckpt.save_trace("an", trace, out_dir=str(jdir))
    tckpt.save_trace("an", trace, out_dir=str(tdir))
    for k, v in tckpt.load_trace("an", in_dir=str(jdir)).items():
        np.testing.assert_array_equal(v, jckpt.load_trace("an", in_dir=str(tdir))[k])


def test_specs_and_monitor_files_identical(fixture_dir, tmp_path):
    tree = read_one_newick(str(fixture_dir / "data/time.tree"))
    topo = FlatTopology.from_tree(tree)
    leaves = [n.name for n in tree.preorder() if n.is_leaf]
    cal_csv = ("Name,LeafA,LeafB,Lower,LowerPM,Upper,UpperPM\n"
               f"root,{leaves[0]},{leaves[-1]},0.8,0.01,1.5,0.01\n"
               f"c1,{leaves[0]},{leaves[1]},0.1,0.02,,\n")
    con_csv = ("Name,YoungA,YoungB,OldA,OldB,PM\n"
               f"k1,{leaves[0]},{leaves[1]},{leaves[-2]},{leaves[-1]},0.01\n")
    braces = json.dumps([{"braceDataName": "b1",
                          "braceDataNodes": [[leaves[0], leaves[1]], [leaves[-2], leaves[-1]]],
                          "braceDataStandardDeviation": 0.02}])
    sets = {}
    for name, mod in (("jax", jspecs), ("port", tspecs)):
        sets[name] = (
            mod.load_calibrations_csv(cal_csv, tree, topo, is_text=True, log=quiet),
            mod.load_constraints_csv(con_csv, tree, topo, is_text=True, log=quiet),
            mod.load_braces_json(braces, tree, topo, is_text=True, log=quiet),
        )
    for a, b in zip(sets["jax"], sets["port"]):
        for f in a.__dataclass_fields__:
            va, vb = getattr(a, f), getattr(b, f)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb)
            else:
                assert va == vb
    assert tspecs.mean_root_height(sets["port"][0]) == jspecs.mean_root_height(sets["jax"][0])

    cal, con, br = sets["jax"]
    lik = jmvn.LikelihoodData.none()
    jm = JModel(topo=topo, likelihood=lik, calibrations=cal, constraints=con, braces=br)
    st = _state(C=2, N=topo.n, seed=3)
    pm, _ = from_numpy(topo, lik, st, calibrations=cal, constraints=con, braces=br,
                       device="cpu")
    rng = np.random.default_rng(5)
    T = 6
    rows = {k: rng.uniform(0.1, 2, size=T) for k in (
        "birth", "death", "height", "rate_mean", "rate_var", "lp_cal", "lp_bd", "lp_clock",
        "lp_post")}
    rows["heights"] = rng.uniform(size=(T, topo.n))
    rows["rates"] = rng.gamma(5, 0.2, (T, topo.n))
    for name, mod, model in (("j", jmon, jm), ("t", tmon, pm)):
        (tmp_path / name).mkdir()
        w = mod.MonitorWriter(model, "an", str(tmp_path / name), period=2, log=quiet).open()
        w.write_rows(0, rows)
        w.close()
    for f in ("params", "timetree", "ratetree", "prior"):
        assert _read(tmp_path / "j" / f"an.{f}.monitor") == _read(tmp_path / "t" / f"an.{f}.monitor")
