"""The JAX package's host tree code (NumPy only) plus device index arrays.

``tree/rose.py`` and ``tree/flat.py`` of ``mcmcdate_tpu`` import no JAX, so
the port reuses them; :class:`DeviceTopology` adds the index tensors the
torch code gathers with.
"""

from __future__ import annotations

import numpy as np
import torch

from mcmcdate_tpu.tree.flat import FlatTopology
from mcmcdate_tpu.tree.rose import (  # noqa: F401
    Node,
    make_ultrametric,
    node_heights,
    normalize_height,
    read_one_newick,
)


class DeviceTopology:
    """A :class:`FlatTopology` with its index arrays as int64 tensors on
    ``device``; every other attribute reads through to the host topology."""

    def __init__(self, flat: FlatTopology, device="cpu"):
        self.flat = flat
        self.device = torch.device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

        self.parent_t = t(flat.parent)
        self.dist_node_index_t = t(flat.dist_node_index)
        self.internal_dist_index_t = t(flat.internal_dist_index)
        self.non_root_t = self.parent_t >= 0
        self.is_leaf_t = torch.as_tensor(np.asarray(flat.is_leaf), device=self.device)

    def __getattr__(self, name):
        return getattr(self.flat, name)
