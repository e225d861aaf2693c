"""Host tree code (NumPy only) plus device index arrays.

``rose.py`` and ``flat.py`` are copies of the JAX package's host modules of
the same names (the port imports nothing of that package);
:class:`DeviceTopology` adds the index tensors the torch code gathers with.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import device as devices
from .flat import FlatTopology
from .rose import (  # noqa: F401
    Node,
    make_ultrametric,
    mrca_path,
    node_heights,
    normalize_height,
    read_one_newick,
)


class DeviceTopology:
    """A flat topology (:class:`FlatTopology`, or any object with its
    fields) with its index arrays as int64 tensors on ``device`` (the card
    unless the caller asks for the CPU); every other attribute reads
    through to the host topology."""

    def __init__(self, flat: FlatTopology, device="cuda"):
        self.flat = flat
        self.device = devices.resolve(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

        self.parent_t = t(flat.parent)
        self.dist_node_index_t = t(flat.dist_node_index)
        self.internal_dist_index_t = t(flat.internal_dist_index)
        self.non_root_t = self.parent_t >= 0
        self.is_leaf_t = torch.as_tensor(np.asarray(flat.is_leaf), device=self.device)

    def __getattr__(self, name):
        return getattr(self.flat, name)
