"""The PyTorch port never imports JAX nor the JAX package: in a fresh
interpreter, import every module of ``mcmcdate_tpu_torch`` and run
``simulate``, ``prepare`` (full, and sparse by the host BCD and by the
ADMM's plain route), ``run --device cpu``, ``continue`` and ``analyze``
through its CLI on a 6-leaf fixture."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import os, pkgutil, importlib, sys
import mcmcdate_tpu_torch
for m in pkgutil.walk_packages(mcmcdate_tpu_torch.__path__, "mcmcdate_tpu_torch."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
from mcmcdate_tpu_torch import cli
from mcmcdate_tpu_torch.engine import mh
# One 10-sweep burn-in window in place of --profile's four keeps the test short.
mh.BURN_IN_PROF_FAST[:] = [10]
mh.BURN_IN_PROF_SLOW[:] = []
d = sys.argv[1]
cli.main(["simulate", "--leaves", "6", "--trees", "60", "--out", os.path.join(d, "data")])
cli.main(["prepare", "-a", "x", "--rooted-tree", os.path.join(d, "data", "time.tree"),
          "--trees", os.path.join(d, "data", "trees.nwk"), "--likelihood-spec", "full",
          "--out-dir", d])
runner = cli.main(["run", "-a", "x", "--device", "cpu", "--chains", "4", "--iterations", "10",
                   "--seed", "2", "--out-dir", d, "--profile"])
assert os.path.exists(os.path.join(d, "x.mcmc.npz"))
assert 0 < runner.accepted < runner.attempted
runner = cli.main(["continue", "-a", "x", "--device", "cpu", "--iterations", "10",
                   "--out-dir", d, "--profile"])
assert 0 < runner.accepted < runner.attempted
cli.main(["analyze", "-a", "x", "--out-dir", d])
assert os.path.exists(os.path.join(d, "x.timetree.ages.summary"))
from mcmcdate_tpu_torch import prepare
for host_max in (400, 2):
    prepare.GLASSO_HOST_MAX = host_max
    res = cli.main(["prepare", "-a", f"s{host_max}", "--rooted-tree",
                    os.path.join(d, "data", "time.tree"), "--trees",
                    os.path.join(d, "data", "trees.nwk"), "--likelihood-spec", "sparse 0.1",
                    "--device", "cpu", "--out-dir", d])
    assert res.data.kind == "sparse"
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "flax")))
assert not bad, bad
# Nor anything of the JAX package, not even its modules that import no JAX.
bad = sorted(m for m in sys.modules if m == "mcmcdate_tpu" or m.startswith("mcmcdate_tpu."))
assert not bad, bad
print("NOJAX-OK")
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)], capture_output=True,
                         text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-4000:]
    assert "NOJAX-OK" in out.stdout


def test_run_refuses_cuda_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "mcmcdate_tpu_torch", "run", "-a", "x", "--device", "cuda",
         "--out-dir", str(tmp_path)], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
