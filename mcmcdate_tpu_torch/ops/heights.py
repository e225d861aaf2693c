"""State-to-branch transforms over a chain batch.

Port of ``mcmcdate_tpu/ops/heights.py``: node arrays are ``[C, N]``,
scalars ``[C]``.  Branch length of node ``i`` is
``heights[parent[i]] - heights[i]``; the root entry reads the last node
(``parent[0] = -1``) and must be masked by callers, as in the JAX package.
"""

from __future__ import annotations

import torch


def branch_lengths(heights, parent):
    """Relative time branch lengths per node, ``[C, N]``."""
    return heights[:, parent] - heights


def distances(time_lengths, rates, height, rate_mean, dist_node_index, root_right):
    """Distance vector ``[C, N-2]`` in expected substitutions: the two
    root-adjacent branches are summed into entry 0."""
    lens = time_lengths * rates
    d = lens[:, dist_node_index]
    d[:, 0] += lens[:, root_right]
    return d * (height * rate_mean)[:, None]


def distances_from_state(state, topo):
    """Distance vector in the reference branch order."""
    tl = branch_lengths(state.heights, topo.parent_t)
    return distances(tl, state.rates, state.height, state.rate_mean,
                     topo.dist_node_index_t, topo.root_children[1])


def distances_internal(state, topo):
    """Distance vector in the INTERNAL (pre-order) layout used by the
    sampler's incremental likelihood."""
    tl = branch_lengths(state.heights, topo.parent_t)
    return distances(tl, state.rates, state.height, state.rate_mean,
                     topo.internal_dist_index_t, topo.root_children[1])


def root_branch(state, topo):
    """The root branch of the induced unrooted tree, ``[C]``."""
    l, r = topo.root_children
    h = state.heights
    t1 = h[:, 0] - h[:, l]
    t2 = h[:, 0] - h[:, r]
    return state.height * state.rate_mean * (t1 * state.rates[:, l] + t2 * state.rates[:, r])


def log_jacobian_root_branch(state, topo):
    """``-log(rootBranch)`` per chain."""
    return -torch.log(root_branch(state, topo))
