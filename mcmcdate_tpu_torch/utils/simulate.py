"""Fixture simulation: generate synthetic posterior tree lists.

The reference's test fixtures are produced by a slynx+PhyloBayes pipeline
(tests/*/data/1-simulate, 2-infer).  For a self-contained repository we
instead sample branch-length "posterior" trees directly from a known ground
truth: a random ultrametric time tree, per-branch rates from a relaxed
clock, and tree-list rows drawn from a multivariate normal around the true
substitution distances.  End-to-end tests then check that inferred node ages
recover the truth.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..tree.flat import FlatTopology
from ..tree.rose import Node, write_newick


@dataclass
class Simulation:
    time_tree: Node  # ultrametric, heights absolute
    topo: FlatTopology
    true_heights: np.ndarray  # absolute node heights
    true_rates: np.ndarray  # per-branch absolute rates
    trees: List[Node]  # "posterior" branch-length trees


def random_ultrametric_tree(rng: np.random.Generator, n_leaves: int,
                            height: float = 1.0) -> Node:
    """Random bifurcating ultrametric tree: recursive leaf-set splitting with
    node heights drawn top-down; branch lengths derive from the heights."""
    names = [f"t{i}" for i in range(n_leaves)]

    def build(leaf_names, h) -> Node:
        # Returns a node sitting at height h (branch length set by caller).
        if len(leaf_names) == 1:
            return Node(0.0, leaf_names[0], [])
        k = int(rng.integers(1, len(leaf_names)))
        hc = h * rng.uniform(0.35, 0.9)
        left = build(leaf_names[:k], hc)
        right = build(leaf_names[k:], hc)
        hl = 0.0 if left.is_leaf else hc
        hr = 0.0 if right.is_leaf else hc
        left.length = h - hl
        right.length = h - hr
        return Node(0.0, "", [left, right])

    return build(names, height)


def _heights_of(node: Node, h: float, out):
    out.append(h)
    for c in node.children:
        _heights_of(c, h - c.length, out)


def simulate(
    n_leaves: int = 6,
    n_trees: int = 600,
    *,
    seed: int = 0,
    height: float = 1.0,
    rate_mean: float = 1.0,
    rate_var: float = 0.0,
    noise: float = 0.05,
) -> Simulation:
    """Simulate a posterior tree list around a random ultrametric truth.

    ``rate_var = 0`` gives a strict clock; otherwise per-branch rates are
    gamma-distributed with mean ``rate_mean`` and variance ``rate_var``.
    ``noise`` scales the standard deviation of the per-branch observation
    noise relative to the branch's true distance.
    """
    rng = np.random.default_rng(seed)
    t = random_ultrametric_tree(rng, n_leaves, height)
    topo = FlatTopology.from_tree(t)
    hs = []
    _heights_of(t, height, hs)
    hs = np.asarray(hs)
    hs[np.asarray(topo.is_leaf)] = 0.0

    n = topo.n
    if rate_var > 0:
        shape = rate_mean**2 / rate_var
        scale = rate_var / rate_mean
        rates = rng.gamma(shape, scale, size=n)
    else:
        rates = np.full(n, rate_mean)

    # True distances per node branch.
    d_true = (hs[topo.parent] - hs) * rates
    d_true[0] = 0.0

    trees = []
    sd = noise * np.maximum(d_true, 1e-3)
    for _ in range(n_trees):
        d = np.maximum(d_true + rng.normal(0, sd), 1e-6)
        tt = t.copy()
        for i, nd in enumerate(tt.preorder()):
            nd.length = float(d[i]) if i else 0.0
        trees.append(tt)
    return Simulation(time_tree=t, topo=topo, true_heights=hs, true_rates=rates, trees=trees)


def simulate_on_topology(
    tree: Node,
    n_trees: int = 600,
    *,
    seed: int = 0,
    height: float = 1.0,
    rate_mean: float = 1.0,
    rate_var: float = 0.0,
    noise: float = 0.05,
) -> Simulation:
    """Same generative scheme as :func:`simulate`, but on a GIVEN rooted
    topology (e.g. the reference's real 1007-taxon GOE tree,
    tutorial/goe/data/1007_mito_plastid.tree, whose PhyloBayes treelist is
    not shipped): draw an ultrametric truth over that topology top-down,
    then sample a noisy branch-length "posterior" tree list around it.
    """
    rng = np.random.default_rng(seed)
    t = tree.copy()
    topo = FlatTopology.from_tree(t)
    n = topo.n
    parent = np.asarray(topo.parent)
    is_leaf = np.asarray(topo.is_leaf)

    # Heights top-down in preorder (parent always precedes child).
    hs = np.zeros(n)
    hs[0] = height
    for i in range(1, n):
        hs[i] = 0.0 if is_leaf[i] else hs[parent[i]] * rng.uniform(0.35, 0.9)

    if rate_var > 0:
        shape = rate_mean**2 / rate_var
        scale = rate_var / rate_mean
        rates = rng.gamma(shape, scale, size=n)
    else:
        rates = np.full(n, rate_mean)

    d_true = (hs[parent] - hs) * rates
    d_true[0] = 0.0

    # Set the time tree's branch lengths to the true time spans.
    for i, nd in enumerate(t.preorder()):
        nd.length = float(hs[parent[i]] - hs[i]) if i else 0.0

    trees = []
    sd = noise * np.maximum(d_true, 1e-3)
    for _ in range(n_trees):
        d = np.maximum(d_true + rng.normal(0, sd), 1e-6)
        tt = t.copy()
        for i, nd in enumerate(tt.preorder()):
            nd.length = float(d[i]) if i else 0.0
        trees.append(tt)
    return Simulation(time_tree=t, topo=topo, true_heights=hs,
                      true_rates=rates, trees=trees)


def write_fixture(sim: Simulation, out_dir: str) -> None:
    """Write ``time.tree`` (rooted tree) and ``trees.nwk`` (tree list)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "time.tree"), "w") as fh:
        fh.write(write_newick(sim.time_tree) + "\n")
    with open(os.path.join(out_dir, "trees.nwk"), "w") as fh:
        for t in sim.trees:
            fh.write(write_newick(t) + "\n")
