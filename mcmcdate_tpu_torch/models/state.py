"""Model state space over a chain batch.

Port of ``mcmcdate_tpu/models/state.py``: every field carries a leading
chain axis (scalars ``[C]``, node arrays ``[C, N]``).  Relative
parameterization: a branch's length in expected substitutions is
``(t_i * height) * (r_i * rate_mean)``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..tree import Node, make_ultrametric, node_heights, normalize_height
from ..utils import device as devices

FIELDS = ("birth", "death", "height", "heights", "rate_mean", "rate_var", "rates")


@dataclass
class State:
    """Sampler state of ``C`` chains."""

    birth: torch.Tensor  # [C] timeBirthRate
    death: torch.Tensor  # [C] timeDeathRate
    height: torch.Tensor  # [C] timeHeight (absolute)
    heights: torch.Tensor  # [C, N] relative node heights; root 1, leaves 0
    rate_mean: torch.Tensor  # [C] rateMean
    rate_var: torch.Tensor  # [C] rateVariance
    rates: torch.Tensor  # [C, N] relative branch rates; root entry unused

    def replace(self, **changes) -> "State":
        return dataclasses.replace(self, **changes)

    @property
    def n_chains(self) -> int:
        return self.heights.shape[0]

    def to(self, device=None, dtype=None) -> "State":
        return State(**{k: getattr(self, k).to(device=device, dtype=dtype) for k in FIELDS})

    def numpy(self) -> dict:
        """Host copies of every field."""
        return {k: getattr(self, k).detach().cpu().numpy() for k in FIELDS}

    @staticmethod
    def from_arrays(arrays: dict, dtype=None, device="cuda") -> "State":
        """State from a dict of arrays; unbatched arrays become one chain.
        On the card unless ``device`` says otherwise; ``dtype=None``:
        float32 on a CUDA device, float64 on the CPU."""
        device = devices.resolve(device)
        dtype = devices.float_dtype(device, dtype)
        out = {}
        for k in FIELDS:
            t = torch.as_tensor(np.asarray(arrays[k]), dtype=dtype, device=device)
            nd = 2 if k in ("heights", "rates") else 1
            out[k] = t.reshape((1,) * (nd - t.dim()) + tuple(t.shape)).contiguous()
        return State(**out)


def init_state(tree: Node, topo, n_chains: int = 1, dtype=None,
               device="cuda") -> State:
    """Initial state from a tree with branch lengths (``initWith``): make the
    tree ultrametric with height one, all rates and hyper-parameters one;
    zero-length branches (except the stem) take the average branch length.
    Every chain starts from the same state, on the card unless ``device``
    says otherwise; ``dtype=None``: float32 on a CUDA device, float64 on
    the CPU."""
    device = devices.resolve(device)
    dtype = devices.float_dtype(device, dtype)
    t = tree.copy()
    bs = [n.length for c in t.children for n in c.preorder()]
    avg = sum(bs) / len(bs) if bs else 1.0
    for c in t.children:
        for n in c.preorder():
            if n.length == 0:
                n.length = avg
    t.length = 0.0
    tn = normalize_height(make_ultrametric(t))
    hs = np.asarray(node_heights(tn), dtype=np.float64)
    hs[np.asarray(topo.is_leaf)] = 0.0
    hs[0] = 1.0
    C = n_chains
    one = torch.ones(C, dtype=dtype, device=device)
    return State(
        birth=one.clone(),
        death=one.clone(),
        height=one.clone(),
        heights=torch.as_tensor(hs, dtype=dtype, device=device).repeat(C, 1),
        rate_mean=one.clone(),
        rate_var=one.clone(),
        rates=torch.ones((C, topo.n), dtype=dtype, device=device),
    )


def is_valid_state(state: State, topo):
    """``isValidState`` per chain, ``[C]`` bool."""
    parent = torch.as_tensor(np.asarray(topo.parent, np.int64), device=state.heights.device)
    is_leaf = torch.as_tensor(np.asarray(topo.is_leaf), device=state.heights.device)
    non_root = parent >= 0
    h = state.heights
    hp = h[:, parent]
    heights_ok = (
        torch.all(torch.where(non_root, hp > h, True), dim=1)
        & torch.all(torch.where(is_leaf, h == 0, True), dim=1)
        & (h[:, 0] == 1.0)
    )
    rates_ok = torch.all(torch.where(non_root, state.rates > 0, True), dim=1)
    scalars_ok = (
        (state.birth > 0)
        & (state.death > 0)
        & (state.height > 0)
        & (state.rate_mean > 0)
        & (state.rate_var > 0)
    )
    return heights_ok & rates_ok & scalars_ok
