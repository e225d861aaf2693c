"""The PyTorch port's ``run_analysis`` against the JAX package's sampler, on
the CPU: on a simulated 8-leaf full-MVN fixture, prepared once, the node-age
means of the two agree within Monte Carlo error, |z| < 5, with the standard
error of each mean taken over independent chains."""

import numpy as np
import jax
import jax.numpy as jnp

from mcmcdate_tpu.engine import mh as jmh, proposals as JP
from mcmcdate_tpu.io import lhdata as jlh
from mcmcdate_tpu.models import DatingModel as JModel, init_state as j_init
from mcmcdate_tpu.tree import FlatTopology, read_one_newick
from mcmcdate_tpu.utils.simulate import simulate, write_fixture
from mcmcdate_tpu_torch import prepare as tprep
from mcmcdate_tpu_torch.engine import chains as tchains, mh as tmh
from mcmcdate_tpu_torch.io import lhdata as tlh
from mcmcdate_tpu_torch.models import DatingModel, init_state

Z_AGREE = 5.0


def test_run_analysis_node_ages_agree_with_jax(tmp_path):
    write_fixture(simulate(n_leaves=8, n_trees=300, seed=7, rate_var=0.05), str(tmp_path / "d"))
    tprep.prepare("an", str(tmp_path / "d/time.tree"), str(tmp_path / "d/trees.nwk"), "full",
                  out_dir=str(tmp_path), log=lambda *a: None)
    tree = read_one_newick(str(tmp_path / "an.meantree"))
    topo = FlatTopology.from_tree(tree)

    # The port: run_analysis on the CPU at float64.
    C = 48
    model = DatingModel(topo=topo, likelihood=tlh.load_data(str(tmp_path / "an.data")),
                        device="cpu")
    settings = tchains.RunSettings(
        "an", burn_in=tmh.BurnInSettings([10], []), iterations=20, n_chains=C,
        out_dir=str(tmp_path), seed=3, dtype="float64", device="cpu")
    runner = tchains.run_analysis(model, init_state(tree, topo, device="cpu"), settings,
                                  log=lambda *a: None)
    with np.load(tmp_path / "an.trace.npz") as z:
        port = {lbl: z[f"age[{lbl}]"] for lbl in runner.diag_labels}
    assert all(v.shape == (20, C) for v in port.values())

    # The JAX package's sequential sweep on the same prepared data.
    jm = JModel(topo=topo, likelihood=jlh.load_data(str(tmp_path / "an.data")))
    table = JP.build_proposal_table(topo, jm.braces, False)
    kern = jmh.MHKernel(jm, table)
    CJ = 64
    s0 = j_init(tree, topo)
    batch = jax.tree.map(lambda x: jnp.broadcast_to(x, (CJ,) + x.shape), s0)
    r = np.random.default_rng(1).gamma(5.0, 0.2, size=(CJ, topo.n))
    r[:, 0] = 1.0
    batch = batch.replace(rates=jnp.asarray(r))
    idx = jnp.asarray(runner.diag_idx)
    chunk = jax.jit(lambda b, tu, k: kern.sweeps(
        b, tu, k, 10, collect=lambda s, a, b2: s.heights[idx] * s.height))
    tuning = jnp.ones((CJ, table.n_proposals))
    targets = jnp.asarray(table.target_rates())
    tmax = jnp.asarray(table.tune_max())
    key = jax.random.PRNGKey(5)
    outs = []
    for i in range(3):
        key, k = jax.random.split(key)
        batch, _, _, acc, tot, o = chunk(batch, tuning, k)
        if i < 1:
            tuning = jmh.tune_step(tuning, acc.astype(float), tot.astype(float), targets,
                                   tune_max=tmax)
        else:
            outs.append(np.asarray(o))
    ref = np.concatenate(outs)  # [T, CJ, K]

    for j, lbl in enumerate(runner.diag_labels):
        p, q = port[lbl], ref[:, :, j]
        se = np.hypot(p.mean(0).std() / np.sqrt(p.shape[1]), q.mean(0).std() / np.sqrt(CJ))
        z = (p.mean() - q.mean()) / max(se, 1e-12)
        assert abs(z) < Z_AGREE, f"age[{lbl}]: port {p.mean():.5f} vs JAX {q.mean():.5f} (z={z:+.1f})"
