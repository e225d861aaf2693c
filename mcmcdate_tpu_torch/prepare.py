"""The ``prepare`` pipeline: posterior tree list -> likelihood data + mean tree.

Re-implements app/Main.hs:159-307 on the host (NumPy/LAPACK):

1. read the posterior tree list (gzip-transparent), drop 1/6 burn-in;
2. check for duplicate leaves;
3. re-root every tree at the outgroup given by the rooted tree's bipartition;
4. check topology equality (tree list: topology AND sub-tree order must
   match; rooted tree: topology up to order);
5. branch matrix with the two root branches merged; posterior mean and
   covariance; inverse + log-determinant;
6. full / sparse (graphical lasso) / univariate / no-likelihood variants;
7. write ``<name>.data`` (reference-compatible JSON) and ``<name>.meantree``.

Port of ``mcmcdate_tpu/prepare.py``: the same steps, on copies of the JAX
package's NumPy-only tree code, native tree-list parser and graphical lasso,
so the files written are identical to the JAX package's.  Everything runs
on the host but the sparse kind's ADMM above ``GLASSO_HOST_MAX`` dims,
whose iterations run on ``device`` (the card unless the caller asks for the
CPU).  The ``banded`` spec (``banded W``) writes the Cholesky banding
estimate of ``ops/banded.py``, as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from .tree.flat import FlatTopology
from .tree.rose import (
    Node,
    assign_indices,
    bipartition,
    duplicate_leaves,
    outgroup,
    read_many_newick,
    read_one_newick,
    tree_from_arrays,
    write_newick,
)
from .utils import native

from .io.lhdata import dense_to_assoc, save_data
from .ops import mvn
from .utils import glasso as G

# Above this dimension the sparse (graphical-lasso) preparation runs the ADMM
# solver on the card (utils/glasso.py:graphical_lasso_admm); at or below it
# the host BCD solver, as in the JAX package.
GLASSO_HOST_MAX = 400


@dataclass
class PrepareResult:
    data: mvn.LikelihoodData
    mean_tree: Node
    n_trees_used: int


def data_file(analysis_name: str) -> str:
    return analysis_name + ".data"


def mean_tree_file(analysis_name: str) -> str:
    return analysis_name + ".meantree"


def _branch_matrix_all(trees: List[Node]) -> np.ndarray:
    """Rows: per-tree branch lengths of ALL nodes in pre-order (incl. stem),
    used for the mean tree (``getPosteriorMatrix``, app/Main.hs:107-108)."""
    n = trees[0].n_nodes()
    rows = np.empty((len(trees), n), dtype=np.float64)
    for k, t in enumerate(trees):
        rows[k] = np.fromiter((nd.length for nd in t.preorder()), dtype=np.float64)
    return rows


class _LinComb:
    """Branch length as a symbolic linear combination of original lengths.

    Running the re-rooting algorithm once with these instead of floats
    yields, for each re-rooted branch, its coefficients over the original
    pre-order branches.  Re-rooting is topology-only, so the SAME linear map
    applies to every tree in the list — the native fast path parses lengths
    into a matrix and re-roots all trees with one sparse mat-mul.
    """

    __slots__ = ("terms",)

    def __init__(self, terms):
        self.terms = dict(terms)

    def __add__(self, other):
        t = dict(self.terms)
        if isinstance(other, _LinComb):
            for k, v in other.terms.items():
                t[k] = t.get(k, 0.0) + v
        elif other:
            raise TypeError(other)
        return _LinComb(t)

    __radd__ = __add__

    def __truediv__(self, c):
        return _LinComb({k: v / c for k, v in self.terms.items()})


def _reroot_map(first_tree: Node, og) -> List[List]:
    """Coefficients of the re-rooted pre-order lengths over the original
    pre-order lengths: ``out[j] = [(i, coeff), ...]``."""
    sym = first_tree.copy()
    for i, nd in enumerate(sym.preorder()):
        nd.length = _LinComb({i: 1.0})
    rerooted = outgroup(sym, og)
    out = []
    for nd in rerooted.preorder():
        if isinstance(nd.length, _LinComb):
            out.append(sorted(nd.length.terms.items()))
        else:  # new root stem: 0.0 float
            out.append([])
    return out


def _apply_reroot_map(coeffs: List[List], lens: np.ndarray) -> np.ndarray:
    out = np.zeros((lens.shape[0], len(coeffs)), dtype=np.float64)
    for j, terms in enumerate(coeffs):
        for i, c in terms:
            out[:, j] += c * lens[:, i]
    return out


def prepare(
    analysis_name: str,
    rooted_tree_file: str,
    trees_file: str,
    likelihood_spec: str,
    *,
    sparse_rho: float = 0.1,
    banded_w: int = 128,
    out_dir: str = ".",
    device="cuda",
    log=print,
) -> PrepareResult:
    """``device``: where the sparse kind's ADMM iterations run (above
    ``GLASSO_HOST_MAX`` dims; no other branch does device work, and the
    banded kind's estimator runs on the host).  ``banded_w``: the banded
    kind's bandwidth."""
    log("Read rooted tree.")
    tree_rooted = read_one_newick(rooted_tree_file)
    og, _ = bipartition(tree_rooted)

    log("Read trees.")
    fast = native.read_treelist_fast(trees_file) if native.available() else None
    if fast is not None:
        # Native path: lengths as a matrix; re-rooting of the whole list is
        # one sparse linear map derived from the shared topology.
        lens_all, parents0, names0, hashes = fast
        n_trees = len(lens_all)
        log(f"{n_trees} trees read (native parser).")
        log("Check if topologies of the trees in the tree list are equal "
            "(topology AND sub tree orders need to match).")
        if len(set(hashes.tolist())) != 1:
            raise ValueError(
                "prepare: A single topology and equal sub tree orders are required."
            )
        first = tree_from_arrays(parents0, names0, lens_all[0])
        log("Check if trees have unique leaves.")
        if duplicate_leaves(first):
            raise ValueError("prepare: Trees have duplicate leaves.")
        n_burn_in = n_trees // 6
        log(f"Skip a burn in of {n_burn_in} trees.")
        lens = lens_all[n_burn_in:]
        log("Root the trees at the same point as the given rooted tree.")
        coeffs = _reroot_map(first, og)
        pm_full = _apply_reroot_map(coeffs, lens)
        first_rooted = outgroup(first, og)
        n_used = len(lens)
    else:
        trees_all = read_many_newick(trees_file)
        n_trees = len(trees_all)
        log(f"{n_trees} trees read.")
        if n_trees == 0:
            raise ValueError("prepare: No trees found.")
        n_burn_in = n_trees // 6
        log(f"Skip a burn in of {n_burn_in} trees.")
        trees = trees_all[n_burn_in:]
        log("Check if trees have unique leaves.")
        if any(duplicate_leaves(t) for t in trees_all):
            raise ValueError("prepare: Trees have duplicate leaves.")
        log("Root the trees at the same point as the given rooted tree.")
        trees_rooted = [outgroup(t, og) for t in trees]
        log("Check if topologies of the trees in the tree list are equal "
            "(topology AND sub tree orders need to match).")
        keys = {t.topology_key_ordered() for t in trees_rooted}
        if len(keys) != 1:
            raise ValueError(
                "prepare: A single topology and equal sub tree orders are required."
            )
        first_rooted = trees_rooted[0]
        pm_full = _branch_matrix_all(trees_rooted)
        n_used = len(trees_rooted)

    log("Check the topology of the rooted tree (sub tree orders may differ).")
    if tree_rooted.topology_key_unordered() != first_rooted.topology_key_unordered():
        raise ValueError("prepare: A single topology is required.")

    topo = FlatTopology.from_tree(first_rooted)
    order = topo.ref_branch_order
    pm_r = pm_full[:, order]
    # Merge the two root branches (sumFirstTwo).
    pm_r = np.concatenate([pm_r[:, :1] + pm_r[:, 1:2], pm_r[:, 2:]], axis=1)

    mu = pm_r.mean(axis=0)
    sigma = np.cov(pm_r, rowvar=False)
    log(f"Number of branches: {len(mu)}.")
    variances = np.diag(sigma)
    min_var = variances.min()
    log(f"Minimum mean branch length: {mu.min()}")
    log(f"Maximum mean branch length: {mu.max()}")
    log(f"Minimum variance: {min_var}")
    log(f"Maximum variance: {variances.max()}")
    if min_var <= 0:
        raise ValueError("prepare: Minimum variance is zero or negative.")

    log("Prepare the covariance matrix for phylogenetic likelihood calculation.")
    if likelihood_spec == mvn.FULL:
        # The full-rank inverse is only needed (and only well-defined,
        # n_samples > n_branches) for the dense MVN kind; the univariate
        # and no-likelihood kinds never touch the off-diagonal covariance.
        sign, log_det_sigma = np.linalg.slogdet(sigma)
        if sign <= 0:
            raise ValueError(
                "prepare: Determinant of covariance matrix is negative? "
                f"(needs more tree samples ({n_used}) than branches "
                f"({len(mu)}) for the full MVN)"
            )
        sigma_inv = np.linalg.inv(sigma)
        log("The logarithm of the determinant of the covariance matrix is: "
            f"{log_det_sigma}")
        log("Use full covariance matrix.")
        data = mvn.LikelihoodData.full(mu, sigma_inv, log_det_sigma)
    elif likelihood_spec == mvn.SPARSE:
        log("Use a sparse covariance/precision matrix (graphical lasso).")
        log(f"Use a (provided) penalty parameter of: {sparse_rho}.")
        mu_s, sd_s, xs_norm = G.scale_data(pm_r)
        corr = np.cov(xs_norm, rowvar=False)
        if len(mu) > GLASSO_HOST_MAX:
            # The host BCD (cyclic Python lasso solves) is practical to a few
            # hundred dims; the reference's largest sparse preparation is
            # GOE-scale, 2,047 dims (tutorial_goe.md).
            log(f"Graphical lasso on the accelerator (ADMM, "
                f"{len(mu)} dims > host limit {GLASSO_HOST_MAX}).")
            stats = {}
            sigma_norm_sparse, prec_norm_sparse = G.graphical_lasso_admm(
                corr, sparse_rho, device=device, stats=stats
            )
            log(f"ADMM iterations: {stats['iterations']}.")
        else:
            sigma_norm_sparse, prec_norm_sparse = G.graphical_lasso(
                corr, sparse_rho
            )
        sigma_sparse = G.rescale_cov(sd_s, sigma_norm_sparse)
        prec_sparse = G.rescale_precision(sd_s, prec_norm_sparse)
        sign_s, log_det_s = np.linalg.slogdet(sigma_sparse)
        if sign_s <= 0:
            raise ValueError("prepare: Determinant of sparse covariance matrix is negative?")
        assoc = dense_to_assoc(prec_sparse)
        n_full = prec_sparse.size
        log(f"Number of elements of full matrix: {n_full}")
        log(f"Number of elements of sparse matrix: {len(assoc)}")
        log(f"Proportion of elements kept: {len(assoc) / n_full}")
        prec_dense = np.zeros_like(prec_sparse)
        for (i, j), v in assoc:
            prec_dense[i, j] = v
        data = mvn.LikelihoodData.sparse(mu_s, prec_dense, log_det_s, assoc=assoc)
    elif likelihood_spec == mvn.BANDED:
        # The JAX package's own scaling kind (no reference analog): a
        # block-banded precision in the internal pre-order layout, from the
        # Cholesky banding estimator (ops/banded.py).
        from .ops import banded as banded_ops

        w = int(banded_w)
        log("Use a banded precision matrix (Cholesky banding estimator).")
        log(f"Use a (provided) bandwidth of: {w}.")
        perm = topo.ref_to_internal_perm
        xs_int = pm_r[:, perm]
        _, band, log_det_b = banded_ops.estimate_banded_chol(xs_int, w)
        nnz_band = int(np.count_nonzero(band)) * 2 - len(mu)
        log(f"Number of elements of full matrix: {len(mu) ** 2}")
        log(f"Number of elements within the band: {nnz_band}")
        log("The logarithm of the determinant of the banded covariance "
            f"matrix is: {log_det_b}")
        data = mvn.LikelihoodData.banded(mu, band, log_det_b, perm)
    elif likelihood_spec == mvn.UNIVARIATE:
        log("Use univariate normal distributions.")
        data = mvn.LikelihoodData.univariate(mu, variances)
    elif likelihood_spec == mvn.NONE:
        log("Do not use the phylogenetic likelihood. Only estimate the prior.")
        data = mvn.LikelihoodData.none()
    else:
        raise ValueError(f"prepare: Unknown likelihood spec {likelihood_spec!r}.")

    import os

    data_path = os.path.join(out_dir, data_file(analysis_name))
    log(f"Save the posterior means and (co)variances to {data_path}.")
    save_data(data_path, data)

    log("Prepare the rooted tree with mean branch lengths (used as initial state).")
    # Use one of the rooted tree-list trees (the given rooted tree may have a
    # different sub-tree order, app/Main.hs:289-291).
    tree_r = first_rooted.copy()
    means_all = pm_full.mean(axis=0)
    for nd, b in zip(tree_r.preorder(), means_all):
        nd.length = float(b)
    mean_tree = assign_indices(tree_r)
    mt_path = os.path.join(out_dir, mean_tree_file(analysis_name))
    log(f"Save the rooted tree with mean branch lengths to {mt_path}.")
    with open(mt_path, "w") as fh:
        fh.write(write_newick(mean_tree) + "\n")
    return PrepareResult(data=data, mean_tree=mean_tree, n_trees_used=n_used)
