"""Flat (array) representation of a fixed tree topology.

The reference manipulates rose trees with zippers and per-node closures
(lib/Mcmc/Tree/Lens.hs, lib/Mcmc/Tree/Proposal/*).  On TPU the topology is
fixed at trace time, so we compile it once into integer arrays; every prior,
likelihood, and proposal then becomes a pure jittable function of dense
vectors indexed by these arrays.  See SURVEY.md §7 ("Design stance").

Node indexing is **pre-order** with the root at index 0 and children visited
left-to-right, so a sub-tree always occupies a contiguous index range
``[i, subtree_end[i])`` — descendant masks are range checks, no gather
matrices needed.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .rose import Node


@dataclass(frozen=True)
class FlatTopology:
    """Static integer-array description of a rooted tree topology.

    All arrays are host NumPy; they are closed over as constants when
    jitting.  ``N`` is the number of nodes.
    """

    parent: np.ndarray  # int32[N]; -1 for the root
    children: np.ndarray  # int32[N, max_children]; -1 padding
    n_children: np.ndarray  # int32[N]
    is_leaf: np.ndarray  # bool[N]
    depth: np.ndarray  # int32[N]; subtree depth, leaves have depth 1 (elynx `depth`)
    level: np.ndarray  # int32[N]; distance from root (root = 0)
    names: Tuple[str, ...]  # node names, pre-order
    subtree_end: np.ndarray  # int32[N]; exclusive end of the pre-order subtree range
    paths: Tuple[Tuple[int, ...], ...]  # reference-style child-index path per node

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @staticmethod
    def from_tree(t: Node) -> "FlatTopology":
        nodes: List[Node] = list(t.preorder())
        n = len(nodes)
        index = {id(nd): i for i, nd in enumerate(nodes)}
        max_c = max((len(nd.children) for nd in nodes), default=0)
        parent = np.full(n, -1, dtype=np.int32)
        children = np.full((n, max(max_c, 1)), -1, dtype=np.int32)
        n_children = np.zeros(n, dtype=np.int32)
        is_leaf = np.zeros(n, dtype=bool)
        depth = np.zeros(n, dtype=np.int32)
        level = np.zeros(n, dtype=np.int32)
        names = []
        paths: List[Tuple[int, ...]] = [()] * n
        for i, nd in enumerate(nodes):
            names.append(nd.name)
            n_children[i] = len(nd.children)
            is_leaf[i] = nd.is_leaf
            for j, c in enumerate(nd.children):
                ci = index[id(c)]
                parent[ci] = i
                children[i, j] = ci
                level[ci] = level[i] + 1
                paths[ci] = paths[i] + (j,)
        # Depth and subtree end via reverse pre-order (children come after
        # parents in pre-order, so reverse order is a valid post-order here).
        subtree_end = np.arange(1, n + 1, dtype=np.int32)
        for i in range(n - 1, -1, -1):
            if n_children[i] == 0:
                depth[i] = 1
            else:
                cs = children[i, : n_children[i]]
                depth[i] = 1 + max(depth[c] for c in cs)
                subtree_end[i] = max(subtree_end[c] for c in cs)
        return FlatTopology(
            parent=parent,
            children=children,
            n_children=n_children,
            is_leaf=is_leaf,
            depth=depth,
            level=level,
            names=tuple(names),
            subtree_end=subtree_end,
            paths=tuple(paths),
        )

    # ------------------------------------------------------------------
    # Simple derived quantities
    # ------------------------------------------------------------------

    @property
    def n(self) -> int:
        return len(self.names)

    @property
    def n_leaves(self) -> int:
        return int(self.is_leaf.sum())

    @cached_property
    def inner_nodes(self) -> np.ndarray:
        """Indices of internal nodes, pre-order (root first)."""
        return np.nonzero(~self.is_leaf)[0].astype(np.int32)

    @cached_property
    def leaf_nodes(self) -> np.ndarray:
        return np.nonzero(self.is_leaf)[0].astype(np.int32)

    @cached_property
    def n_inner_subtree(self) -> np.ndarray:
        """int32[N]: number of internal nodes in the subtree rooted at i."""
        out = np.zeros(self.n, dtype=np.int32)
        for i in range(self.n - 1, -1, -1):
            if self.n_children[i] > 0:
                cs = self.children[i, : self.n_children[i]]
                out[i] = 1 + sum(out[c] for c in cs)
        return out

    @cached_property
    def n_nodes_subtree(self) -> np.ndarray:
        """int32[N]: total number of nodes in the subtree rooted at i."""
        return (self.subtree_end - np.arange(self.n, dtype=np.int32)).astype(np.int32)

    @cached_property
    def levels(self) -> List[np.ndarray]:
        """Node indices grouped by level (root level first)."""
        out = []
        for lv in range(int(self.level.max()) + 1):
            out.append(np.nonzero(self.level == lv)[0].astype(np.int32))
        return out

    @cached_property
    def max_level(self) -> int:
        return int(self.level.max())

    def node_of_path(self, path: Sequence[int]) -> int:
        i = 0
        for j in path:
            i = int(self.children[i, j])
            if i < 0:
                raise IndexError(f"node_of_path: invalid path {path!r}")
        return i

    def descendant_mask(self, i: int, proper: bool = False) -> np.ndarray:
        """bool[N] mask of the subtree rooted at ``i`` (optionally excluding i)."""
        idx = np.arange(self.n)
        lo = i + 1 if proper else i
        return (idx >= lo) & (idx < int(self.subtree_end[i]))

    # ------------------------------------------------------------------
    # Branch-vector convention of the reference likelihood
    # ------------------------------------------------------------------

    @cached_property
    def ref_branch_order(self) -> np.ndarray:
        """Node indices in the reference's branch-vector order.

        app/Tools.hs:36-43 ``getBranches``: the two branches leading to the
        root come first (first branch of the left root subtree, first branch
        of the right root subtree), followed by the remaining branches of the
        left subtree in pre-order, then the remaining branches of the right
        subtree.  The root's stem is excluded.
        """
        if self.n_children[0] != 2:
            raise ValueError("ref_branch_order: Root node is not bifurcating.")
        l, r = int(self.children[0, 0]), int(self.children[0, 1])
        l_block = np.arange(l, int(self.subtree_end[l]), dtype=np.int32)
        r_block = np.arange(r, int(self.subtree_end[r]), dtype=np.int32)
        return np.concatenate(
            [np.array([l, r], dtype=np.int32), l_block[1:], r_block[1:]]
        )

    @cached_property
    def dist_node_index(self) -> np.ndarray:
        """int32[N-2]: node index providing each entry of the distance vector.

        The distance vector is the branch vector with the first two entries
        (the two root-adjacent branches) summed into one (app/Tools.hs:47-48
        ``sumFirstTwo``).  Entry 0 maps to the left root child; the right
        root child's length must be **added** to entry 0 separately (see
        :func:`..ops.heights.distances_from_state`).
        """
        order = self.ref_branch_order
        return np.concatenate([order[:1], order[2:]])

    @property
    def root_children(self) -> Tuple[int, int]:
        if self.n_children[0] != 2:
            raise ValueError("root_children: Root node is not bifurcating.")
        return int(self.children[0, 0]), int(self.children[0, 1])

    # ------------------------------------------------------------------
    # Internal (pre-order) distance layout
    #
    # The on-device likelihood uses distances in PRE-ORDER of the non-root
    # nodes with the second root child's entry merged into the first's
    # (entry 0).  In this layout the distance entries touched by a sub-tree
    # proposal form entry 0 plus ONE contiguous range, enabling incremental
    # whitened-residual updates with static-size dynamic slices.  ``mu`` and
    # the precision factor are permuted from the reference order once on the
    # host (see DatingModel).
    # ------------------------------------------------------------------

    @cached_property
    def internal_pos(self) -> np.ndarray:
        """int32[N]: distance position per node; root -1; both root children
        map to 0 (their branches are summed into entry 0)."""
        l, r = self.root_children
        pos = np.empty(self.n, dtype=np.int32)
        pos[0] = -1
        for n in range(1, self.n):
            if n == r:
                pos[n] = 0
            elif n < r:
                pos[n] = n - 1
            else:
                pos[n] = n - 2
        return pos

    @cached_property
    def internal_dist_index(self) -> np.ndarray:
        """int32[N-2]: node providing each internal distance entry (the
        second root child is added to entry 0 separately)."""
        l, r = self.root_children
        return np.asarray([n for n in range(1, self.n) if n != r], np.int32)

    @cached_property
    def ref_to_internal_perm(self) -> np.ndarray:
        """int32[N-2] with ``d_internal = d_ref[perm]``."""
        ref_nodes = self.dist_node_index  # node per ref entry (entry 0 = l)
        node_to_ref = {int(n): i for i, n in enumerate(ref_nodes)}
        return np.asarray(
            [node_to_ref[int(n)] for n in self.internal_dist_index], np.int32
        )

    def dist_range(self, i: int) -> Tuple[int, int]:
        """Contiguous internal-distance range covered by the sub-tree at
        ``i`` (excluding entry 0, which callers handle separately)."""
        lo_node, hi_node = int(i), int(self.subtree_end[i])
        ps = [int(self.internal_pos[n]) for n in range(lo_node, hi_node)]
        ps = [p for p in ps if p >= 1]
        if not ps:
            return (1, 1)
        lo, hi = min(ps), max(ps) + 1
        assert hi - lo == len(ps), "dist_range: range not contiguous"
        return (lo, hi)
