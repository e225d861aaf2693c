"""The port's stepping-stone marginal likelihood (``engine/stepping_stone.py``,
the ``marginal-likelihood`` command) on the CPU: the ladder and the
estimator against the JAX package's, the annealed cascade's seeding order
and ``cascade_seed``'s plain version, log Z = 0 without a likelihood and the
CLI (the slice against importance sampling: test_torch_stepping_stone_is.py).

The port's plain sweep costs about 0.4 s on the CPU at 8 leaves (a few
hundred plain tickets), so every run here cuts the sweep counts: the burn-in
and repetitive burn-in windows of ``--profile``, the cascade's sweeps a rung
and the iterations (each test says how far)."""

import math
import os

import numpy as np
import pytest
import torch
from scipy.special import logsumexp

from mcmcdate_tpu.engine import stepping_stone as JSS
from mcmcdate_tpu_torch import cli
from mcmcdate_tpu_torch.engine import hmc, mh as TM, stepping_stone as SS
from mcmcdate_tpu_torch.engine.chains import RunSettings, new_key, split_key
from mcmcdate_tpu_torch.kernels.cascade_seed import cascade_seed, cascade_seed_plain
from mcmcdate_tpu_torch.models import DatingModel, init_state
from mcmcdate_tpu_torch.models.state import FIELDS, State
from mcmcdate_tpu_torch.ops import mvn
from mcmcdate_tpu_torch.tree import FlatTopology
from mcmcdate_tpu_torch.tree.rose import parse_newick

EIGHT = ("(((a:0.25,b:0.25):0.35,(c:0.3,d:0.3):0.3):0.4,"
         "((e:0.2,f:0.2):0.5,(g:0.35,h:0.35):0.35):0.3);")
FOUR = "((a:1,b:1):1,(c:1,d:1):1);"


def _quiet(*a, **k):
    pass


@pytest.fixture
def one_thread():
    """One intra-op thread: the plain sweep's tensors are tiny, and more
    threads only add overhead (about 0.7 against 0.4 s a sweep here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def short_schedule(monkeypatch, one_thread):
    """``--profile``'s burn-in (60 sweeps) and repetitive burn-in (100) cut
    to one 10-sweep window each, the cascade to one sweep a rung."""
    monkeypatch.setattr(TM, "BURN_IN_PROF_FAST", [10])
    monkeypatch.setattr(TM, "BURN_IN_PROF_SLOW", [])
    monkeypatch.setattr(SS, "REPETITIVE_BURN_IN_PROF", TM.BurnInSettings([10], []))
    monkeypatch.setattr(SS, "CASCADE_SWEEPS", 1)


@pytest.mark.parametrize("k", (SS.N_POINTS_PROF, SS.N_POINTS))
def test_beta_ladder_matches_jax(k):
    np.testing.assert_array_equal(SS.beta_ladder(k), JSS.beta_ladder(k))
    assert (SS.N_POINTS, SS.N_POINTS_PROF, SS.ITERATIONS_ML, SS.ALPHA, SS.CASCADE_SWEEPS) == (
        JSS.N_POINTS, JSS.N_POINTS_PROF, JSS.ITERATIONS_ML, JSS.ALPHA, JSS.CASCADE_SWEEPS)
    for a, b in ((SS.REPETITIVE_BURN_IN, JSS.REPETITIVE_BURN_IN),
                 (SS.REPETITIVE_BURN_IN_PROF, JSS.REPETITIVE_BURN_IN_PROF)):
        assert (a.fast, a.slow) == (b.fast, b.slow)


def _jax_log_z(ll, betas):
    """The JAX ``run_marginal_likelihood``'s estimator, its lines
    (``mcmcdate_tpu/engine/stepping_stone.py:228-234``) as they stand."""
    b = np.asarray(betas)
    dbeta = b[1:] - b[:-1]
    x = ll[:, :-1] * dbeta[None, :]
    m = x.max(axis=0)
    log_ratios = m + np.log(np.mean(np.exp(x - m), axis=0))
    return float(log_ratios.sum())


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
def test_estimator_matches_jax(dtype):
    """On a seeded log-likelihood matrix: the JAX arithmetic bit for bit, and
    a log-sum-exp of each stone's bridge within 1e-12 (float64)."""
    rng = np.random.default_rng(7)
    k, n = SS.N_POINTS_PROF, 50
    ll = (rng.normal(-40.0, 6.0, size=(n, k)) + np.linspace(-30, 0, k)).astype(dtype)
    betas = SS.beta_ladder(k).astype(dtype)
    got = SS.stepping_stone_log_z(ll, betas)
    assert got == _jax_log_z(ll, betas)
    if dtype == np.float64:
        dbeta = np.diff(betas)
        ref = sum(logsumexp(dbeta[j] * ll[:, j]) - math.log(n) for j in range(k - 1))
        assert abs(got - ref) <= 1e-12 * max(1.0, abs(ref))


def test_cascade_seeding_order():
    """Stone j+1 is seeded from stone j after rung j's sweeps, rung after
    rung: with a mock sweeps that adds 1 to every field of every stone, every
    stone ends at K-1 (a naive or reversed order gives j + K - 1 or K - 2;
    tests/test_samplers.py holds the JAX cascade to the same).  Each rung's
    seed is the next of the key's split_key sequence, and the ladder goes
    to every rung's sweeps."""
    K = 8
    batch = State(**{f: torch.arange(K, dtype=torch.float64)[:, None].repeat(1, 3)
                     if f in ("heights", "rates") else torch.arange(K, dtype=torch.float64)
                     for f in FIELDS})
    betas = torch.as_tensor(SS.beta_ladder(K))
    seen = []

    def sweeps_fn(b, tuning, seed, n_sweeps, beta=None):
        assert n_sweeps == SS.CASCADE_SWEEPS and beta is betas
        seen.append(seed)
        return (State(**{f: getattr(b, f) + 1.0 for f in FIELDS}),)

    out = SS.annealed_cascade(sweeps_fn, batch, None, new_key(5), betas, K)
    for f in FIELDS:
        assert torch.equal(getattr(out, f), torch.full_like(getattr(batch, f), K - 1)), f
    key, want = new_key(5), []
    for _ in range(K - 1):
        key, seed = split_key(key)
        want.append(seed)
    assert seen == want


def test_cascade_seed_plain_is_the_field_copy():
    """``cascade_seed`` on CPU tensors (its plain version) equals the
    per-field copy of row j to row j+1; the other rows stay; the last row
    has no next row."""
    rng = np.random.default_rng(3)
    K, N = 6, 9
    arrays = {f: rng.normal(size=(K, N) if f in ("heights", "rates") else K) for f in FIELDS}
    for j in range(K - 1):
        batch = State(**{f: torch.as_tensor(a.copy()) for f, a in arrays.items()})
        cascade_seed(batch, j)
        for f, a in arrays.items():
            want = a.copy()
            want[j + 1] = a[j]
            np.testing.assert_array_equal(getattr(batch, f).numpy(), want)
    with pytest.raises(ValueError, match="no next row"):
        cascade_seed(batch, K - 1)
    plain = State(**{f: torch.as_tensor(a.copy()) for f, a in arrays.items()})
    cascade_seed_plain(plain, 2)
    assert torch.equal(plain.heights[3], torch.as_tensor(arrays["heights"][2]))


def test_no_likelihood_is_zero(short_schedule):
    """Without a likelihood every stone's log likelihood is 0, so log Z is
    exactly 0 (``tests/test_samplers.py`` holds the JAX package to 1e-5);
    the profile ladder, the schedule cut as above, 10 iterations."""
    topo = FlatTopology.from_tree(parse_newick(FOUR))
    model = DatingModel(topo=topo, likelihood=mvn.LikelihoodData.none(), device="cpu")
    init = init_state(parse_newick(FOUR), topo, device="cpu")
    res = SS.run_marginal_likelihood(
        model, init, RunSettings("ss", n_chains=4, seed=3, iterations=10, device="cpu",
                                 dtype="float64"), profile=True, log=_quiet)
    assert res.log_marginal_likelihood == 0.0
    assert res.betas.shape == (SS.N_POINTS_PROF,)
    assert not res.mean_log_lik_per_point.any()


def test_cli_marginal_likelihood_on_cpu(tmp_path, short_schedule, monkeypatch):
    """``marginal-likelihood --device cpu --profile --iterations 4`` on a
    ``simulate --leaves 8`` fixture writes ``<name>.mlh.log`` with the
    cascade's line and a finite log Z (the schedule cut as above), and so
    does ``--hamiltonian``; without a card ``--device cuda`` stops and
    never carries on on the CPU."""
    d = str(tmp_path)
    cli.main(["simulate", "--leaves", "8", "--trees", "200", "--out", os.path.join(d, "data")])
    cli.main(["prepare", "-a", "t", "--rooted-tree", os.path.join(d, "data", "time.tree"),
              "--trees", os.path.join(d, "data", "trees.nwk"), "--likelihood-spec", "full",
              "--out-dir", d])
    args = ["marginal-likelihood", "-a", "t", "--profile", "--iterations", "4", "--seed", "1",
            "--out-dir", d]
    res = cli.main(args + ["--device", "cpu"])
    with open(os.path.join(d, "t.mlh.log")) as fh:
        text = fh.read()
    assert "annealed-init cascade: 11 rungs x 1 sweeps" in text
    line = [s for s in text.splitlines() if s.startswith("log marginal likelihood")]
    assert len(line) == 1 and math.isfinite(float(line[0].rsplit(" ", 1)[1]))
    assert math.isfinite(res.log_marginal_likelihood)
    assert res.mean_log_lik_per_point.shape == (SS.N_POINTS_PROF,)
    # With --hamiltonian the NUTS move runs in every stone's sampling sweeps
    # (no slow window here; trajectories cut to one doubling, no cascade).
    monkeypatch.setattr(hmc, "MAX_DEPTH", 1)
    res = cli.main(args + ["--device", "cpu", "--hamiltonian", "--no-annealed-init"])
    assert math.isfinite(res.log_marginal_likelihood)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(args + ["--device", "cuda"])
