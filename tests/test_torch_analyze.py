"""The port's ``analyze`` (``mcmcdate_tpu_torch/analyze.py`` and
``cli.cmd_analyze``) against the JAX package's on the same monitor files,
on the CPU: every file written is byte-identical, and so is what the
command prints."""

import os
import shutil

import numpy as np
import pytest

from mcmcdate_tpu import analyze as JA, cli as jcli
from mcmcdate_tpu.tree.rose import read_one_newick as j_read, write_newick as j_write
from mcmcdate_tpu_torch import analyze as TA, cli
from mcmcdate_tpu_torch.engine import chains as TC, checkpoint as tckpt, mh as TM
from mcmcdate_tpu_torch.tree.rose import read_one_newick as t_read, write_newick as t_write

C = 8


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """Monitor files of a short 8-leaf port run, and a trace whose root age
    sits in two modes across the chains (so that ``mode_report`` writes)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(TC, "CHUNK", 2)
    mp.setattr(TM, "BURN_IN_PROF_FAST", [2])
    mp.setattr(TM, "BURN_IN_PROF_SLOW", [])
    d = str(tmp_path_factory.mktemp("analyze"))
    try:
        cli.main(["simulate", "--leaves", "8", "--trees", "80", "--seed", "6", "--out",
                  os.path.join(d, "data")])
        cli.main(["prepare", "-a", "x", "--rooted-tree", os.path.join(d, "data", "time.tree"),
                  "--trees", os.path.join(d, "data", "trees.nwk"), "--likelihood-spec",
                  "full", "--out-dir", d])
        cli.main(["run", "-a", "x", "--device", "cpu", "--chains", str(C), "--iterations",
                  "16", "--seed", "2", "--profile", "--out-dir", d])
    finally:
        mp.undo()
    trace = tckpt.load_trace("x", in_dir=d)
    rng = np.random.default_rng(3)
    n = 16
    trace["age[root]"] = (np.where(np.arange(C) < C // 2, 1.0, 2.0)
                          + 0.01 * rng.normal(size=(n, C)))
    trace["lp_post"] = rng.normal(size=(n, C))
    tckpt.save_trace("x", trace, out_dir=d)
    return d


def _inputs(src, dst):
    os.makedirs(dst)
    for f in os.listdir(src):
        if f.startswith("x.") and (f.endswith(".monitor") or f.endswith(".trace.npz")):
            shutil.copy(os.path.join(src, f), dst)


def test_analyze_outputs_identical(run_dir, tmp_path, capsys):
    argv = ["analyze", "-a", "x", "--burn-in", "0.2", "--thin", "3"]
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    _inputs(run_dir, jd)
    _inputs(run_dir, td)
    capsys.readouterr()
    jcli.cmd_analyze(jcli.build_parser().parse_args(argv + ["--out-dir", jd]))
    j_out = capsys.readouterr().out
    cli.main(argv + ["--out-dir", td])
    t_out = capsys.readouterr().out
    assert t_out == j_out
    files = sorted(os.listdir(jd))
    assert files == sorted(os.listdir(td))
    for want in ("x.params.thinned", "x.timetree.tree.mean", "x.timetree.tree.combined",
                 "x.timetree.ages.summary", "x.timetree.ages.full", "x.timetree.nexus",
                 "x.timetree.densitree.nex", "x.ratetree.tree.mean", "x.ages.modes"):
        assert want in files, want
    for f in files:
        with open(os.path.join(jd, f), "rb") as a, open(os.path.join(td, f), "rb") as b:
            assert a.read() == b.read(), f


def test_tree_tools_identical(run_dir, tmp_path):
    path = os.path.join(run_dir, "x.timetree.monitor")
    j = JA.summarize_trees(path, burn_in_fraction=0.1)
    t = TA.summarize_trees(path, burn_in_fraction=0.1)
    assert j == t
    assert JA.node_age_summary(path) == TA.node_age_summary(path)
    for a, b in zip(JA.read_tree_monitor(path), TA.read_tree_monitor(path)):
        assert len(a) == len(b)
    tree = os.path.join(run_dir, "data", "time.tree")
    assert j_write(JA.midpoint_root(j_read(tree))) == t_write(TA.midpoint_root(t_read(tree)))
    assert j_write(JA.identify(j_read(tree))) == t_write(TA.identify(t_read(tree)))
    jt, tt = str(tmp_path / "j.nex"), str(tmp_path / "t.nex")
    assert JA.densitree_prep(path, jt, thin_by=2) == TA.densitree_prep(path, tt, thin_by=2)
    with open(jt, "rb") as a, open(tt, "rb") as b:
        assert a.read() == b.read()
