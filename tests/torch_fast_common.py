"""Shared fixtures of the ``tests/test_torch_fast_sweep*.py`` files: small
models built once with the JAX package (float64) and their counterparts in
the PyTorch port, on the same chain states, made from a seed with numpy."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from mcmcdate_tpu.engine import proposals as JP
from mcmcdate_tpu.engine.fast_sweep import FastSweeps as JFast
from mcmcdate_tpu.models import DatingModel as JModel, init_state as j_init
from mcmcdate_tpu.models.state import State as JState
from mcmcdate_tpu.ops import heights as JH, mvn as jmvn, node_priors as jnp_
from mcmcdate_tpu.tree import FlatTopology, parse_newick
from mcmcdate_tpu.utils.simulate import random_ultrametric_tree
from mcmcdate_tpu_torch.engine import fast_sweep as TF, proposals as TP
from mcmcdate_tpu_torch.models import from_numpy

C = 16
MULTIFURCATING = ("((a:1,b:1,c:1):1,((d:0.5,e:0.5,f:0.5,g:0.5):1,(h:1,i:1):0.5):0.5,"
                  "(j:1.5,(k:0.5,l:0.5):1):0.5);")


def tree_of(shape: str, seed: int, leaves: int = 12):
    if shape == "multi":
        t = parse_newick(MULTIFURCATING)
        return _rooted(t)
    return random_ultrametric_tree(np.random.default_rng(seed), leaves)


def _rooted(t):
    """The multifurcating fixture with a bifurcating root (the likelihood's
    distance layout needs one): the last child joins the others."""
    from mcmcdate_tpu.tree.rose import Node

    if len(t.children) > 2:
        rest = Node(children=t.children[:-1], length=0.5)
        t = Node(children=[rest, t.children[-1]], length=0.0)
    return t


def likelihood(kind: str, topo, d0, rng):
    """A likelihood of the given kind centred near the distances ``d0``."""
    k = topo.n - 2
    mu = d0 * rng.uniform(0.9, 1.1, size=k)
    if kind == "full":
        a = rng.normal(size=(k, k)) / np.sqrt(k)
        sigma = (a @ a.T + np.eye(k) * 0.1) * 1e-2
        return jmvn.LikelihoodData.full(mu, np.linalg.inv(sigma), np.linalg.slogdet(sigma)[1])
    if kind == "uni":
        return jmvn.LikelihoodData.univariate(mu, rng.uniform(0.01, 0.1, size=k) ** 2)
    return jmvn.LikelihoodData.none()


def node_priors(topo):
    """A root calibration, a calibration on a non-root-adjacent inner node,
    a constraint and a brace (the last two keep their nodes sequential)."""
    inner = [int(i) for i in topo.inner_nodes if i and topo.level[i] > 1]
    cal = jnp_.CalibrationSet(np.asarray([0, inner[0], inner[1]], np.int32),
                              np.asarray([0.8, 0.2, 0.0]), np.asarray([0.01, 0.02, 1.0]),
                              np.asarray([1.6, np.inf, 0.9]), np.asarray([0.01, 1.0, 0.05]),
                              names=("root", "a", "b"))
    con = jnp_.ConstraintSet(np.asarray([inner[-1]], np.int32), np.asarray([inner[-2]], np.int32),
                             np.asarray([0.01]))
    br = jnp_.BraceSet(np.asarray([[inner[2], inner[-3]]], np.int32), np.asarray([0.05]),
                       names=("b",))
    return cal, con, br


class Case:
    """One model in both packages, with a perturbed chain batch."""

    def __init__(self, lik="full", shape="binary", priors=False, seed=3, clock=None, leaves=12):
        rng = np.random.default_rng(seed)
        t = tree_of(shape, seed, leaves)
        topo = FlatTopology.from_tree(t)
        self.topo = topo
        s0 = j_init(t, topo)
        data = likelihood(lik, topo, np.asarray(JH.distances_from_state(s0, topo)), rng)
        cal = con = br = None
        kw = {}
        if priors:
            cal, con, br = node_priors(topo)
            kw = dict(calibrations=cal, constraints=con, braces=br)
        if clock is not None:
            kw["clock"] = clock
        self.jm = JModel(topo=topo, likelihood=data, mean_root_height=1.2, **kw)
        self.table = JP.build_proposal_table(topo, self.jm.braces, self.jm.calibrations_available)
        self.jfs = JFast(self.jm, self.table)
        h = np.asarray(s0.heights)[None].repeat(C, 0) * rng.uniform(0.9, 1.0, size=(C, 1))
        h[:, 0] = 1.0
        h[:, topo.is_leaf] = 0.0
        self.state = dict(heights=h, rates=rng.gamma(20.0, 0.05, size=(C, topo.n)),
                          birth=rng.uniform(0.5, 2, C), death=rng.uniform(0.1, 1, C),
                          height=rng.uniform(1.0, 1.4, C), rate_mean=rng.uniform(0.8, 1.2, C),
                          rate_var=rng.uniform(0.05, 0.5, C))
        self.pm, self.ps = from_numpy(topo, data, self.state, mean_root_height=1.2,
                                      device="cpu", **{k: v for k, v in kw.items()})
        self.ptable = TP.build_proposal_table(self.pm.topo, self.pm.braces,
                                              self.pm.calibrations_available)
        self.pfs = TF.FastSweeps(self.pm, self.ptable)
        self.tuning = rng.uniform(0.3, 3.0, size=(C, self.table.n_proposals))
        self._jcarry = None

    # -- JAX side -------------------------------------------------------

    def jstate(self):
        return JState(**{k: jnp.asarray(v) for k, v in self.state.items()})

    def jcarry(self):
        """``(batch, terms, d, z, q)`` of the JAX sweep at the state (one
        compiled evaluation per case; JAX arrays are immutable)."""
        if self._jcarry is None:
            def carry(js):
                terms = jax.vmap(self.jm.log_prior_terms)(js)
                d = jax.vmap(lambda s: JH.distances_internal(s, self.topo))(js)
                y = jax.vmap(self.jm.whitened_residual_internal)(js)
                return (js, terms, d) + tuple(self.jfs._zq_from_y(y, jnp.float64))

            self._jcarry = jax.jit(carry)(self.jstate())
        return self._jcarry

    # -- port side ------------------------------------------------------

    def pcarry(self):
        fs = self.pfs
        carry = fs.init_carry(self.ps)
        y = self.pm.whitened_residual_internal(carry.batch)
        carry.z, carry.q = fs._zq_from_y(y)
        return carry


def close(port, ref, tol=1e-10):
    """Equal to ``tol`` relative to the reference's scale, with identical
    non-finite entries."""
    port = np.asarray(port.numpy() if isinstance(port, torch.Tensor) else port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(port), fin)
    np.testing.assert_array_equal(port[~fin], ref[~fin])
    if fin.any():
        scale = max(1.0, float(np.abs(ref[fin]).max()))
        np.testing.assert_allclose(port[fin], ref[fin], rtol=0, atol=tol * scale)


def t(a):
    return torch.as_tensor(np.array(a))


# -- a glob family stepped by both packages over the same keys ---------------


def keyed_glob_draws(cs, grp, tag, seed):
    """Per ticket of ``grp``: the JAX key and the draws it makes (the
    kernel's gamma variate or uniform, and the accept uniform), ``[C]``."""
    from mcmcdate_tpu_torch.kernels.glob_step import GAMMA_TAGS

    key = jax.random.PRNGKey(seed)
    out = []
    for s in range(grp.n_tickets):
        key, kt = jax.random.split(key)
        k1, k2 = jax.random.split(kt)
        tune = jnp.asarray(cs.tuning[:, grp.rows[s]])
        sd = jnp.asarray(grp.sd[s], jnp.float64)
        draw = (jax.random.gamma(k1, sd / tune, dtype=jnp.float64) if tag in GAMMA_TAGS
                else jax.random.uniform(k1, (C,), jnp.float64))
        out.append((kt, tune, draw, jax.random.uniform(k2, (C,), jnp.float64)))
    return out


def run_glob_jax(step, grp, keyed, jc):
    """The JAX ``_glob_step`` (``step``, compiled) over ``grp``'s tickets
    with the keys of :func:`keyed_glob_draws`: ``(carry, accept [C, n])``."""
    accept = []
    for s, (kt, tune, _, _) in enumerate(keyed):
        sx = {"sd": jnp.asarray(grp.sd[s], jnp.float64), "aux": grp.aux[s], "lo": grp.lo[s],
              "hi": grp.hi[s], "n_inner": grp.n_inner[s], "n_nodes": grp.n_nodes[s],
              "rj": grp.rj[s]}
        jc, ref = step(jc, (sx, kt, tune))
        accept.append(np.asarray(ref))
    return jc, np.stack(accept, 1)


def run_glob_port(cs, tag, fam, keyed, carry):
    """The family through the glob wrappers on CPU tensors with the same
    draws: glob_scan, or per ticket the prologue, FastSweeps.glob_product
    and the epilogue.  Returns the accept mask ``[C, n]``."""
    from mcmcdate_tpu_torch.kernels import glob_step as G

    fs = cs.pfs
    tun = t(cs.tuning[:, fam.grp.rows])
    draws = t(np.stack([np.asarray(k[2]) for k in keyed], 1))
    u_acc = t(np.stack([np.asarray(k[3]) for k in keyed], 1))
    if G.FAMILIES[tag].lik != G.DENSE:
        return G.glob_scan(fs.glob, fam, carry, tun, draws, u_acc).accept.numpy()
    accept = []
    for s in range(fam.n):
        pro = G.glob_dense_prologue(fs.glob, fam, s, carry, tun, draws)
        accept.append(G.glob_dense_epilogue(fs.glob, fam, s, carry, pro,
                                            fs.glob_product(fam, s, pro), u_acc))
    return torch.stack(accept, 1).numpy()


def support_rows(fam, s):
    """Subtree ticket ``s``'s support rows as G3 reads them from
    ``fam.srow``: its first node's row, then ``hi - lo - 1`` rows in a row
    from the second start."""
    first, rest = (int(x) for x in fam.srow[s])
    k = int(fam.grp.hi[s]) - int(fam.grp.lo[s])
    return np.concatenate([[first], np.arange(rest, rest + k - 1)]).astype(np.int64)


def jcarry_of(port):
    """The JAX sweep's ``(state, terms, d, z, q)`` as copies of the port's
    float64 carry, so that both packages start from the same values."""
    js = JState(**{k: jnp.asarray(getattr(port.batch, k).numpy().copy())
                   for k in ("heights", "rates", "birth", "death", "height", "rate_mean",
                             "rate_var")})
    return (js,) + tuple(jnp.asarray(x.numpy().copy())
                         for x in (port.terms, port.d, port.z, port.q))


def close_carry(port, jc, use_lik):
    """The port's carry against the JAX step's ``(state, terms, d, z, q)``."""
    js, terms, d, z, q = jc
    for f in ("heights", "rates", "birth", "death", "height", "rate_mean", "rate_var"):
        close(getattr(port.batch, f), getattr(js, f))
    close(port.terms, terms)
    close(port.d, d)
    if use_lik:
        close(port.z, z)
        close(port.q, q)
